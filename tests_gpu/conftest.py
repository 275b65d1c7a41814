"""Tests that need an NVIDIA Hopper GPU.

Unlike ``tests/`` (which pins JAX to the CPU), this directory leaves the
platform alone.  Every test is marked ``gpu``; the fixture below skips it
when JAX's backend is not a GPU, deciding inside the test session and never
while a module is imported.

Run: ``python -m pytest -m gpu tests_gpu`` (``chip_smoke.py`` runs them too).
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def require_gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX's backend is {jax.default_backend()!r}")
