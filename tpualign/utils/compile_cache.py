"""Where compiled XLA programs are kept between processes.

Every entry point (``tpualign.cli.main``, ``bench.py``, ``chip_smoke.py``,
``__graft_entry__.py``) calls :func:`setup` before it compiles anything.
If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it and that directory is
the cache; nothing here overrides it.  Otherwise the cache is the fixed
directory ``.jax_cache`` at the root of the checkout (listed in
``.gitignore``): a path that never changes from run to run, so a later
process finds what an earlier one compiled.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")
ENV = "JAX_COMPILATION_CACHE_DIR"


def setup() -> str:
    """Point JAX's persistent compile cache at its directory; returns it.

    Every compiled program is cached, however quickly it compiled: the
    kernels' small wrappers are many, and a cold process pays for each."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    path = os.environ.get(ENV)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
