"""tpu-align: a pairwise sequence-alignment engine for NVIDIA Hopper GPUs.

Built in JAX, with a CUDA kernel through ``jax.ffi``, and with the capability
surface of the C++ reference EricBAndrews/Fast-Needleman-Wunsch (see
SURVEY.md): Needleman-Wunsch global alignment and Smith-Waterman local
alignment over huge DNA pairs, with a bit-parallel score kernel, a portable
XLA row scan, and a multi-device strip-pipelined fill over a
``jax.sharding.Mesh``.

Public API:

- :func:`align_score` — alignment score (NW or SW), auto-dispatched engine.
- :func:`align` — score plus aligned strings (traceback).
- :func:`align_score_batch` — many pairs in one dispatch (serving path).
- :class:`ScoringConfig`, :class:`EngineConfig`, :class:`AlignMode` — config.
- :mod:`tpualign.io.bdna` — ``.bdna`` corpus IO.
"""

from .config import AlignMode, EngineConfig, ScoringConfig, DEFAULT_ENGINE, DEFAULT_SCORING
from .api import align_score, align, align_score_batch

__all__ = [
    "AlignMode",
    "EngineConfig",
    "ScoringConfig",
    "DEFAULT_ENGINE",
    "DEFAULT_SCORING",
    "align_score",
    "align",
    "align_score_batch",
]

__version__ = "0.1.0"
