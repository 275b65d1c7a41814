"""Test configuration.

Tests run on CPU with 8 virtual devices so the multi-device sharding paths
are exercised without GPUs (the analog the reference never had — it only
ever tested with real ``mpirun``, SURVEY.md §4).  Tests that need a GPU live
in ``tests_gpu/``.  Must run before jax imports.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"  # force: the ambient env may pin a GPU
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# jax may already be imported before this file runs, with the ambient
# platform captured — override through the config API.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest

from tpualign.config import AlignMode, ScoringConfig

REFERENCE_BDNA = "/root/reference/bdna"


def reference_pair(name: str):
    """Load a tiny pair from the read-only reference corpus if present,
    otherwise synthesize a deterministic stand-in of the same lengths."""
    from tpualign.io.bdna import read_bdna, random_pair

    p1 = os.path.join(REFERENCE_BDNA, f"{name}1.bdna")
    p2 = os.path.join(REFERENCE_BDNA, f"{name}2.bdna")
    if os.path.exists(p1) and os.path.exists(p2):
        return read_bdna(p1), read_bdna(p2)
    sizes = {"debug": (50, 53), "small": (6, 10), "t": (35, 37), "smid": (10030, 9976)}
    l1, l2 = sizes.get(name, (64, 80))
    return random_pair(l1, l2, seed=hash(name) % (2**31))


@pytest.fixture(params=["nw", "sw"], ids=["global", "local"])
def scoring(request) -> ScoringConfig:
    mode = AlignMode.GLOBAL if request.param == "nw" else AlignMode.LOCAL
    return ScoringConfig(mode=mode)


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_executables():
    """Release compiled executables between test modules.

    The suite compiles many hundreds of distinct XLA CPU executables in one
    process; on small hosts the accumulated JIT state can segfault a later
    compilation (observed: deterministic SIGSEGV in
    ``backend_compile_and_load`` near the end of the run on a 1-core VM).
    Dropping jax's compilation caches at module boundaries keeps the live
    executable count bounded; modules recompile what they still need.
    """
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _no_persistent_compile_cache(monkeypatch):
    """Entry points called in-process (``cli.main``) would point this
    worker's compile cache at the checkout; tests compile afresh instead.
    ``test_dispatch.py`` checks the cache placement in fresh interpreters."""
    from tpualign.utils import compile_cache

    monkeypatch.setattr(compile_cache, "setup", lambda: None)
