"""Large-scale alignment for the round-4 scoring shapes: substitution
matrices and the ends-free modes (semiglobal / infix), plus matrix-scored
local alignment.

Reduction (linear-gap):

1. **Locate the end cell**: argmax over all cells (local), the last
   row + column (semiglobal), or the last row (infix) — the same argmax
   conventions as the oracle walks -- the native O(m)-memory pass
   (``native.locate_flex``).
2. **Locate the start cell** by reversing the prefixes ``s1[:je]``,
   ``s2[:ie]`` and running the *anchored* variant: global (gap-penalized)
   boundaries force every path through the reversed origin — the fixed end
   cell — and the mode's extraction set scans exactly the cells that map
   back to legal start boundaries (reversed last row ``p = ie`` ⇔ original
   row 0; reversed last column ``q = je`` ⇔ original column 0; all cells
   for local).  Same pass, reversed inputs.
3. **Align the global core** ``s1[j0:je] × s2[i0:ie]``: pair-scored cores
   ride the classic engines through :func:`tpualign.api.align`; matrix
   cores take a Hirschberg bisection over ``native.last_row_flex``.

Like the SW paths, the returned strings cover the aligned core only.
The reference computes no alignment in any mode (``driver.cpp:35``); both
the modes and the recovery are beyond-parity capabilities.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import AlignMode, EngineConfig, ScoringConfig
from ..utils import native

#: cores at or below this many cells take the exact full-table walk
LEAF_CELLS = 4 * 1024 * 1024


def _align_global_matrix(
    s1: np.ndarray, s2: np.ndarray, cfg: ScoringConfig
) -> Tuple[str, str]:
    """Hirschberg bisection for matrix-scored global cores (linear gap):
    split the rows in half, meet the halves' DP rows, recurse.  O(m)
    memory per pass; ~2x one fill of work total."""
    from . import oracle

    m, n = s1.size, s2.size
    if (m + 1) * (n + 1) <= LEAF_CELLS or (m <= 2 and n <= 2):
        _, a1, a2 = oracle.traceback(s1, s2, cfg)
        return a1, a2
    if n <= 2:
        # tiny-n leaf with huge m: a full table would be O(m) GB — recurse
        # on the transposed problem instead, splitting the long axis
        # (ADVICE r4; m > 2 here, so the transposed call splits)
        import dataclasses

        tcfg = dataclasses.replace(cfg, matrix=tuple(zip(*cfg.matrix)))
        a2t, a1t = _align_global_matrix(s2, s1, tcfg)
        return a1t, a2t
    h = n // 2
    top = native.last_row_flex(
        s1, s2[:h], cfg, zero_row=False, zero_col=False)
    bot = native.last_row_flex(
        s1[::-1], s2[h:][::-1], cfg, zero_row=False, zero_col=False)
    j_star = int(np.argmax(top + bot[::-1]))
    a1l, a2l = _align_global_matrix(s1[:j_star], s2[:h], cfg)
    a1r, a2r = _align_global_matrix(s1[j_star:], s2[h:], cfg)
    return a1l + a1r, a2l + a2r


def _align_core(
    s1: np.ndarray, s2: np.ndarray, cfg: ScoringConfig, engine: EngineConfig
) -> Tuple[int, str, str]:
    """Global alignment of the located core, by scoring shape."""
    from .. import api

    gcfg = cfg.with_mode(AlignMode.GLOBAL)
    if not cfg.has_matrix:
        return api.align(s1, s2, gcfg, engine)
    from . import oracle

    a1, a2 = _align_global_matrix(s1, s2, gcfg)
    return oracle.alignment_score(a1, a2, gcfg), a1, a2


def align_large(
    s1: np.ndarray,
    s2: np.ndarray,
    cfg: ScoringConfig,
    engine: EngineConfig = EngineConfig(),
) -> Tuple[int, str, str]:
    """Score plus aligned core strings for matrix / ends-free configs at
    any size — linear or affine gaps (round 5: affine rides the Gotoh
    locate scan + Myers-Miller cores)."""
    from . import oracle

    s1 = np.asarray(s1, dtype=np.int8)
    s2 = np.asarray(s2, dtype=np.int8)
    m, n = int(s1.size), int(s2.size)
    cells = (m + 1) * (n + 1)
    if cells <= LEAF_CELLS:
        return oracle.traceback(s1, s2, cfg)
    if cfg.is_affine:
        # affine compositions (round 5): Myers-Miller over the Gotoh scans
        # — matrix subs ride the scans' 17x17 gather; ends-free modes
        # reduce exactly like the linear path below, with the affine
        # locate scan finding the end/start cells
        from . import affine_align

        if cfg.mode is AlignMode.GLOBAL:
            return affine_align.align(s1, s2, cfg)
        if cfg.mode is AlignMode.LOCAL:
            return affine_align.align_local(s1, s2, cfg)
        sc, ie, je = affine_align.locate_flex(s1, s2, cfg)
        if ie == 0 or je == 0:
            return sc, "", ""
        sc2, pi, qj = affine_align.locate_flex(
            s1[:je][::-1].copy(), s2[:ie][::-1].copy(), cfg, anchored=True
        )
        if sc2 != sc:  # pragma: no cover - would indicate a locate bug
            raise AssertionError(
                f"affine start-locate {sc2} != end-locate {sc}")
        i0, j0 = ie - pi, je - qj
        gcfg = cfg.with_mode(AlignMode.GLOBAL)
        core_score, a1, a2 = affine_align.align(
            s1[j0:je], s2[i0:ie], gcfg)
        if core_score != sc:  # pragma: no cover
            raise AssertionError(
                f"affine core score {core_score} != locate score {sc}")
        return sc, a1, a2
    if cfg.mode is AlignMode.GLOBAL:
        # matrix-scored global alignment: the whole problem is the core
        return _align_core(s1, s2, cfg, engine)
    sc, ie, je = native.locate_flex(s1, s2, cfg)
    if ie == 0 or je == 0:
        return sc, "", ""  # empty core (nothing profitably aligned)
    sc2, pi, qj = native.locate_flex(
        s1[:je][::-1].copy(), s2[:ie][::-1].copy(), cfg, anchored=True)
    if sc2 != sc:  # pragma: no cover - would indicate a locate bug
        raise AssertionError(
            f"start-locate score {sc2} != end-locate score {sc}")
    i0, j0 = ie - pi, je - qj
    core_score, a1, a2 = _align_core(
        s1[j0:je], s2[i0:ie], cfg, engine)
    if core_score != sc:  # pragma: no cover - would indicate a core bug
        raise AssertionError(f"core score {core_score} != locate score {sc}")
    return sc, a1, a2

