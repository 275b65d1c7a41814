"""The control of each configuration at its cell's own size, on the card:
the plain reference in the configuration's ``control_dtype`` (the next
narrower integer type) has to give scores that differ from the int32
reference, on three seeds.  Run with ``python -m pytest -m gpu
benchmark/tests_gpu``; it skips without a GPU."""

import json
import os

import numpy as np
import pytest

from benchmark import harness, reference
from benchmark.tests_gpu.conftest import ROOT

CELLS = [w["name"] for w in json.load(
    open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name):
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("the control is read at the cell's size on a GPU")
    cell = harness.load_cell(ROOT, name)
    sc = cell.config["scoring"]
    for seed in (1, 2, 3):
        a, b = harness.make_inputs(cell, seed)[0]
        want = reference.scores(a, b, sc)
        low = reference.scores(a, b, sc, cell.config["control_dtype"])
        assert np.sum(low != want) > 0, (name, seed)
