"""Top-level user API: score and align with automatic engine dispatch.

Successor of the reference's driver layer (``src/common/driver.cpp``,
``mpi-*-driver.cpp``): where the reference picks an implementation by compiling
a different binary, here one call dispatches on :class:`EngineConfig.impl` and
the available hardware.  Every backend decision lives in :func:`resolve_impl`'s
capability table; the engines below it never look at the backend.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .config import EngineConfig, ScoringConfig

#: Above this many DP cells, ``align`` switches from the in-memory full-table
#: traceback to the checkpointed block traceback.
FULL_TABLE_CELL_LIMIT = 16 * 1024 * 1024

#: a problem is spread over a multi-device mesh only when every device's
#: strip is at least this many columns wide
MIN_STRIP_COLUMNS = 4096


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What the engine choice depends on: the process's backend, the first
    device's compute capability (GPUs only), the device count, and the
    problem's scoring and shape (``None`` when the caller has no shape)."""

    backend: str
    compute_capability: Optional[str]
    n_devices: int
    scoring: ScoringConfig
    shape: Optional[Tuple[int, int]]

    @classmethod
    def probe(cls, scoring: ScoringConfig, shape=None) -> "Capabilities":
        import jax

        devices = jax.devices()
        return cls(
            backend=jax.default_backend(),
            compute_capability=getattr(devices[0], "compute_capability", None),
            n_devices=len(devices),
            scoring=scoring,
            shape=shape,
        )


def _bitpal_ok(c: Capabilities) -> bool:
    # the kernel is built for sm_90a, which runs on compute capability 9.0
    from .ops import bitpal

    if c.backend != "gpu" or c.compute_capability != "9.0":
        return False
    if c.shape is None:
        return bitpal.family(c.scoring) is not None
    return bitpal.fits(c.scoring, *c.shape)


def _strips_ok(c: Capabilities) -> bool:
    # the sharded row scan carries plain affine pair scoring; linear configs
    # stay on one device, where the single-device engines are faster
    s = c.scoring
    return (c.n_devices > 1 and c.shape is not None and s.is_affine
            and not (s.has_matrix or s.is_ends_free)
            and max(c.shape) >= MIN_STRIP_COLUMNS * c.n_devices)


#: (engine, predicate) rows, first match wins; ``xla`` serves everything
CAPABILITY_TABLE = (
    ("bitpal", _bitpal_ok),
    ("strips", _strips_ok),
    ("xla", lambda c: True),
)


def choose_engine(caps: Capabilities) -> str:
    """The first engine of :data:`CAPABILITY_TABLE` whose predicate holds."""
    for name, ok in CAPABILITY_TABLE:
        if ok(caps):
            return name
    raise AssertionError("the capability table ends with a catch-all")


def resolve_impl(
    engine: EngineConfig,
    scoring: Optional[ScoringConfig] = None,
    shape: Optional[Tuple[int, int]] = None,
) -> str:
    """Resolve ``impl='auto'`` to a concrete engine for this process.

    With ``shape = (len(s1), len(s2))`` the choice also checks the engine's
    size envelope; an explicit ``impl`` is returned as given.
    """
    if engine.impl != "auto":
        return engine.impl
    return choose_engine(
        Capabilities.probe(scoring or ScoringConfig(), shape))


def device_score_fn(impl: str, m: int, n: int,
                    scoring: ScoringConfig = ScoringConfig()):
    """Jitted ``(s1, s2) -> score`` on int32 device arrays for a
    single-device engine (``bitpal`` or ``xla``), for lengths ``(m, n)``."""
    import jax

    if impl == "bitpal":
        from .ops import bitpal

        return bitpal.score_fn(m, n, scoring)
    if impl == "xla":
        from .ops import xla

        return jax.jit(xla.score_fn(scoring))
    raise ValueError(f"no single-device score function for impl {impl!r}")


def align_score(
    s1: np.ndarray,
    s2: np.ndarray,
    scoring: ScoringConfig = ScoringConfig(),
    engine: EngineConfig = EngineConfig(),
) -> int:
    """Alignment score of ``s1`` (columns) vs ``s2`` (rows).

    Semantics identical to the reference serial kernel (``serial.cpp:16-31``)
    for global mode; local mode adds the Smith-Waterman zero floor.
    """
    s1 = np.asarray(s1)
    s2 = np.asarray(s2)
    impl = resolve_impl(engine, scoring, (int(s1.size), int(s2.size)))
    if impl == "oracle":
        from .ops import oracle

        return oracle.score(s1, s2, scoring)
    if impl == "strips":
        from .parallel import strips

        return strips.score(s1, s2, scoring, chunk_rows=engine.chunk_rows)
    if impl == "bitpal":
        from .ops import bitpal

        return bitpal.score(s1, s2, scoring)
    if impl == "xla":
        from .ops import xla

        return xla.score(s1, s2, scoring)
    raise ValueError(f"unknown impl {impl!r}")


def align(
    s1: np.ndarray,
    s2: np.ndarray,
    scoring: ScoringConfig = ScoringConfig(),
    engine: EngineConfig = EngineConfig(),
) -> Tuple[int, str, str]:
    """Score plus aligned strings — capability the reference lacks entirely
    (it prints only the score, ``driver.cpp:35``).

    Small problems use the exact full-table traceback; large ones use the
    checkpointed block traceback (O(NM/K) memory, device forward pass).
    """
    s1 = np.asarray(s1, dtype=np.int8)
    s2 = np.asarray(s2, dtype=np.int8)
    cells = (s1.size + 1) * (s2.size + 1)
    if cells <= FULL_TABLE_CELL_LIMIT:
        from .ops import oracle
        from .utils import native

        if (not scoring.is_local and not scoring.is_affine
                and native.available()):
            try:  # C++ walk, string-identical to the oracle, ~50x faster
                return native.traceback(s1, s2, scoring)
            except RuntimeError:
                pass
        return oracle.traceback(s1, s2, scoring)
    if scoring.has_matrix or scoring.is_ends_free:
        from .ops import ends_free

        # locate the optimal end/start cells, then align the global core
        return ends_free.align_large(s1, s2, scoring, engine)
    if scoring.is_affine:
        from .ops import affine_align

        # Myers-Miller bisection over the affine row scan (global), or
        # locate + anchored-reverse + Myers-Miller (local): linear space,
        # any size
        if scoring.is_local:
            return affine_align.align_local(s1, s2, scoring)
        return affine_align.align(s1, s2, scoring)
    from .ops import traceback as tb

    return tb.align_checkpointed(s1, s2, scoring, engine)


def align_score_batch(
    texts,
    queries,
    scoring: ScoringConfig = ScoringConfig(),
    engine: EngineConfig = EngineConfig(),
) -> np.ndarray:
    """Scores for a batch of pairs (serving path).

    Pair-scored global and local configs run in one device dispatch: the
    row scan vmapped over the batch's padded shape bucket.  Matrix and
    ends-free configs, and explicit engines other than ``xla``, take a
    per-pair loop.
    """
    if (engine.impl in ("auto", "xla")
            and not (scoring.has_matrix or scoring.is_ends_free)):
        # the vmapped scan extracts global/local with match/mismatch only;
        # matrix / ends-free configs would score wrong through it
        from .ops import xla as xla_ops

        return xla_ops.score_batch(texts, queries, scoring)
    return np.asarray(
        [align_score(t, q, scoring, engine) for t, q in zip(texts, queries)]
    )
