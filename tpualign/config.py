"""Scoring and execution configuration for tpu-align.

The reference (EricBAndrews/Fast-Needleman-Wunsch) spreads its configuration over
three tiers — compile-time ``#define``s (``src/common/needleman-wunsch.hpp:11-16``:
MATCH=1, MISMATCH=0, GAP=-1; block shapes ``sentinel-otf-blocked-mt.cpp:5-6``;
comm-chunk sizes ``nw-mpi.hpp:18`` / ``nw-hybrid.hpp:20-22``), argv knobs for the
tune binaries (``block-tuner.cpp:26-27``), and launcher environment
(``OMP_NUM_THREADS``, ``mpirun -np``).  This module unifies all of that into two
plain dataclasses:

* :class:`ScoringConfig` — the algorithm: substitution scores, gap penalty, and
  alignment mode (global Needleman-Wunsch vs. local Smith-Waterman).
* :class:`EngineConfig` — the execution strategy: which engine, and the chunk
  depth of the pipelined multi-device fill (successor of ``COMMBUF_SIZE``).
"""

from __future__ import annotations

import dataclasses
import enum


class AlignMode(enum.Enum):
    """Alignment mode.

    * ``GLOBAL`` — Needleman-Wunsch: both sequences aligned end to end
      (the reference's only mode, ``serial.cpp:16-31``).
    * ``LOCAL`` — Smith-Waterman: best-scoring substring pair (zero floor,
      max over all cells).  Announced but never implemented by the
      reference (``README.md:2``).
    * ``SEMIGLOBAL`` — ends-free / overlap alignment: leading and trailing
      gaps in *either* sequence are free.  Boundaries ``H(0,j)=H(i,0)=0``;
      the score is the maximum over the last row and last column.
    * ``INFIX`` — fitting / glocal alignment: all of ``s2`` (the query)
      must align, inside any substring of ``s1`` (the text).  Boundary
      ``H(0,j)=0`` with ``H(i,0)`` as in global mode; the score is the
      maximum over the last row.

    Neither semiglobal nor infix exists in the reference — both are
    beyond-parity capabilities of the rebuild.
    """

    GLOBAL = "nw"
    LOCAL = "sw"
    SEMIGLOBAL = "sg"
    INFIX = "infix"


@dataclasses.dataclass(frozen=True)
class ScoringConfig:
    """Linear-gap scoring parameters.

    Defaults reproduce the reference's compiled-in constants
    (``needleman-wunsch.hpp:11-13``): match=+1, mismatch=0, gap=-1.
    Scores are int32 throughout; with \\|scores\\| <= 1 and sequence lengths
    <= ~10^7 the DP values stay far from int32 overflow.
    """

    match: int = 1
    mismatch: int = 0
    gap: int = -1
    mode: AlignMode = AlignMode.GLOBAL
    # Substitution matrix: a square tuple-of-tuples indexed directly by
    # symbol code — ``matrix[a][b]`` is the score of aligning code ``a``
    # (from s1) against code ``b`` (from s2).  For the ``.bdna`` alphabet
    # (codes 1..4 = A,T,G,C, ``helper.cpp:28``) pass a 5x5 whose row/col 0
    # covers the gap byte; :mod:`tpualign.matrices` builds common ones
    # (e.g. transition/transversion-weighted DNA).  When set, ``match`` /
    # ``mismatch`` are ignored.  The reference hardwires match/mismatch
    # (``needleman-wunsch.hpp:11-13``); this is a beyond-parity capability.
    matrix: tuple | None = None
    # Affine (Gotoh) gaps: a run of L gap columns costs
    # ``gap_open + L * gap_extend`` (both <= 0).  ``None`` = linear gaps
    # (cost ``L * gap``; equivalently gap_open=0, gap_extend=gap).  The
    # reference has no affine mode; this is a beyond-parity capability
    # served by the oracle and xla engines.
    gap_open: int | None = None
    gap_extend: int | None = None

    def __post_init__(self) -> None:
        for name in ("match", "mismatch", "gap"):
            v = getattr(self, name)
            if not isinstance(v, int):
                raise TypeError(f"{name} must be a Python int, got {type(v)}")
        if not isinstance(self.mode, AlignMode):
            raise TypeError(f"mode must be AlignMode, got {type(self.mode)}")
        if self.matrix is not None:
            m = self.matrix
            if not isinstance(m, tuple) or not m or not all(
                isinstance(r, tuple) and len(r) == len(m) for r in m
            ):
                raise TypeError(
                    "matrix must be a square tuple-of-tuples "
                    "(hashable; build with tpualign.matrices helpers)")
            if len(m) > 16:
                raise ValueError("matrix alphabet too large (max 16 codes)")
            for r in m:
                for v in r:
                    if not isinstance(v, int):
                        raise TypeError("matrix entries must be Python ints")
        if (self.gap_open is None) != (self.gap_extend is None):
            raise ValueError("gap_open and gap_extend must be set together")
        if self.gap_open is not None:
            for name in ("gap_open", "gap_extend"):
                v = getattr(self, name)
                if not isinstance(v, int):
                    raise TypeError(
                        f"{name} must be a Python int, got {type(v)}")
                if v > 0:
                    # open <= 0 also underpins the vectorized E-resolve:
                    # a gap reopened from a gap-sourced cell never beats
                    # extending the existing gap
                    raise ValueError(f"{name} must be <= 0, got {v}")

    @property
    def is_local(self) -> bool:
        return self.mode is AlignMode.LOCAL

    @property
    def is_affine(self) -> bool:
        return self.gap_open is not None

    @property
    def has_matrix(self) -> bool:
        return self.matrix is not None

    # --- ends-free boundary flags (derived from mode) -------------------
    # ``free_start_s1``: leading s1 (text) chars skippable — H(0, j) = 0.
    # ``free_start_s2``: leading s2 (query) chars skippable — H(i, 0) = 0.
    # ``free_end_s1``: score may end anywhere on the last row (max over j).
    # ``free_end_s2``: score may end anywhere on the last column (max over i).
    @property
    def free_start_s1(self) -> bool:
        return self.mode in (AlignMode.SEMIGLOBAL, AlignMode.INFIX)

    @property
    def free_start_s2(self) -> bool:
        return self.mode is AlignMode.SEMIGLOBAL

    @property
    def free_end_s1(self) -> bool:
        return self.mode in (AlignMode.SEMIGLOBAL, AlignMode.INFIX)

    @property
    def free_end_s2(self) -> bool:
        return self.mode is AlignMode.SEMIGLOBAL

    @property
    def is_ends_free(self) -> bool:
        """True for the semiglobal/infix family (handled as a group by
        engines: global boundaries with selective zero rows plus a
        boundary-max score extraction)."""
        return self.mode in (AlignMode.SEMIGLOBAL, AlignMode.INFIX)

    def sub_score(self, a: int, b: int) -> int:
        """Substitution score of s1-code ``a`` against s2-code ``b``."""
        if self.matrix is not None:
            return self.matrix[a][b]
        return self.match if a == b else self.mismatch

    def sub_bounds(self) -> tuple:
        """(min, max) substitution score over the alphabet."""
        if self.matrix is not None:
            lo = min(min(r) for r in self.matrix)
            hi = max(max(r) for r in self.matrix)
            return lo, hi
        return (min(self.match, self.mismatch),
                max(self.match, self.mismatch))

    def with_mode(self, mode: AlignMode) -> "ScoringConfig":
        return dataclasses.replace(self, mode=mode)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution-strategy knobs.

    ``impl`` names the engine; ``"auto"`` lets :func:`tpualign.api.resolve_impl`
    choose from the backend, the scoring and the problem shape:

    * ``bitpal`` -- the bit-parallel CUDA kernel (Hopper GPUs; global scoring
      affinely reducible to ``(1, 0, -g)``);
    * ``xla`` -- the portable row scan (every config, every backend);
    * ``strips`` -- the row scan sharded over a 1-D device mesh;
    * ``oracle`` -- the NumPy reference.

    ``chunk_rows`` is the depth (in DP rows) of one pipelined super-step of the
    multi-device strip fill -- the successor of the reference's MPI
    comm-buffer size (``COMMBUF_SIZE`` 1280 ints, ``nw-mpi.hpp:18``, swept by
    ``src/buf-tune.sh``).
    """

    impl: str = "auto"
    chunk_rows: int = 2048

    def __post_init__(self) -> None:
        if self.impl not in ENGINES:
            raise ValueError(f"unknown impl {self.impl!r}")
        if self.chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")


#: every engine name ``EngineConfig.impl`` accepts
ENGINES = ("auto", "bitpal", "xla", "strips", "oracle")


def ensure_pair_modes(cfg: ScoringConfig, engine: str) -> None:
    """Reject substitution-matrix and ends-free configs in engines that
    serve pair-scored global/local configs only; dispatch routes those
    configs to the xla and oracle engines, which serve them natively."""
    if cfg.has_matrix or cfg.is_ends_free:
        raise ValueError(
            f"{engine} serves pair-scored global/local configs; "
            "matrix/ends-free configs run on the xla engine")


DEFAULT_SCORING = ScoringConfig()
DEFAULT_ENGINE = EngineConfig()
