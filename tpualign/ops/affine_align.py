"""Linear-space affine-gap (Gotoh) alignment — Myers-Miller bisection.

The reference never computes alignments at all (``driver.cpp:35``) and has
no affine mode; this module completes the round-3 affine capability
(:mod:`tpualign.ops.xla` scores, :func:`oracle.traceback` small problems)
with alignment at ANY size in O(M + N) memory: Myers & Miller's
divide-and-conquer (CABIOS 1988) over the device-resident three-matrix row
scan.

Structure per recursion node (rows split at ``mid = n // 2``):

- a forward scan of rows ``1..mid`` and a reverse scan of rows ``n..mid+1``
  each return the boundary ``(H, F)`` rows (H = best ending in any state,
  F = best ending inside a vertical gap);
- the crossing column is ``argmax_j`` of ``Hf[j] + Hr[m-j]`` (the path
  touches ``(mid, j)`` gap-free) vs ``Ff[j] + Fr[m-j] - gap_open`` (a
  vertical gap spans the boundary — its open was charged in both halves,
  refund one);
- the F case emits rows ``mid`` and ``mid+1`` as gap columns and recurses
  with the touching edges' vertical-gap open cost waived (``tb``/``te`` =
  0 instead of ``gap_open``) — exactly Myers-Miller's ``tb/te`` flags.

Scans are jitted once per power-of-two (columns, rows) bucket: sequences
pad with a never-matching sentinel (junk stays right of / below the true
lengths: H flows left-to-right, rows freeze once ``i >= n``), so the
compile count is O(log^2) of the problem size, not O(nodes).

Base cases solve a flagged full-table Gotoh (the ``tb/te`` edge waivers
fold into the F init row and the final-state combine) with the oracle's
three-state backtrace conventions.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

from ..config import ScoringConfig

#: below this many table cells a node solves the flagged full table directly
BASE_CELLS = 1 << 20

NEG = -(np.int64(1) << np.int64(40))


def _check_affine_align_cfg(cfg: ScoringConfig) -> None:
    """Gate: global/local affine, pair or matrix scoring (the ends-free
    affine modes reduce through ``ops.ends_free`` to global cores solved
    here)."""
    if cfg.is_ends_free:
        raise ValueError(
            "affine_align serves global/local configs; ends-free affine "
            "modes reduce through ops.ends_free")


def _min0(cfg: ScoringConfig) -> int:
    """Sentinel substitution score (pad rows / post-text chars) in matrix
    mode: <= 0 and <= every real entry, so dead cells only decay --
    the same decay guarantee pair scoring gets from ``mismatch <= 0``."""
    lo, _ = cfg.sub_bounds()
    return min(0, lo)


def _mat17(cfg: ScoringConfig) -> np.ndarray:
    """(17, 17) int64 substitution table: the config's matrix in the top
    corner, the decaying sentinel everywhere else (the scans' pad code
    :data:`_PAD` = 16 rows/cols included) — or the match/mismatch pair
    table when no matrix is set (pad handled by the callers' sentinel,
    which matches nothing)."""
    k = len(cfg.matrix)
    out = np.full((17, 17), _min0(cfg), np.int64)
    out[:k, :k] = np.asarray(cfg.matrix, np.int64)
    return out


# ---------------------------------------------------------------------------
# flagged base solver: full-table Gotoh with edge-gap waivers tb/te
# ---------------------------------------------------------------------------


def _base_align(
    s1: np.ndarray,
    s2: np.ndarray,
    cfg: ScoringConfig,
    tb: int,
    te: int,
) -> Tuple[int, str, str]:
    """Exact Gotoh alignment of a small block with boundary flags.

    ``tb``/``te`` are the vertical-gap OPEN costs at the top/bottom edges
    (``cfg.gap_open`` normally; 0 when the parent recursion carries an
    already-open gap through that edge).  Tie order matches the oracle:
    diag > up (F) > left (E); closing beats extending.
    """
    from ..io.bdna import BASES

    open_, ext = np.int64(cfg.gap_open), np.int64(cfg.gap_extend)
    tb, te = np.int64(tb), np.int64(te)
    matx = _mat17(cfg) if cfg.has_matrix else None
    M, N = s1.size, s2.size
    jext = np.arange(M + 1, dtype=np.int64) * ext
    H = np.zeros((N + 1, M + 1), dtype=np.int64)
    E = np.full((N + 1, M + 1), NEG, dtype=np.int64)
    F = np.full((N + 1, M + 1), NEG, dtype=np.int64)
    H[0, 1:] = open_ + jext[1:]
    F[0, :] = H[0, :] + tb  # row-1 opens cost tb instead of gap_open
    # Rows fill vectorized; the per-cell E values from the cummax identity
    # EQUAL the sequential recurrence (a gap reopened from a gap-ended cell
    # never beats extending, open <= 0), so the backtrace's predecessor
    # tests below see exact E/F/H everywhere.
    for i in range(1, N + 1):
        row_open = tb if i == 1 else open_
        if matx is not None:
            sub = matx[np.asarray(s1, np.int64), int(s2[i - 1])]
        else:
            sub = np.where(s1 == s2[i - 1], np.int64(cfg.match),
                           np.int64(cfg.mismatch))
        F[i] = np.maximum(H[i - 1] + row_open, F[i - 1]) + ext
        T = np.empty(M + 1, dtype=np.int64)
        T[0] = tb + i * ext
        np.maximum(H[i - 1, :-1] + sub, F[i, 1:], out=T[1:])
        C = np.maximum.accumulate(T - jext)
        E[i, 1:] = C[:-1] + open_ + jext[1:]
        H[i] = np.maximum(T, E[i])
    for j in range(1, M + 1):  # row-0 E chain, for the backtrace walk
        E[0, j] = max(H[0, j - 1] + open_, E[0, j - 1]) + ext
    # te: the alignment may end inside a vertical gap with the open waived.
    # A vertical gap needs at least one row — with N == 0 the F init row is
    # H + tb and the waiver would fabricate a bogus higher score (and a
    # gap-state backtrace with nothing to emit).
    end_f = int(F[N, M] + (te - open_)) if N > 0 else int(NEG)
    sc = max(int(H[N, M]), end_f)
    state = "F" if end_f > int(H[N, M]) else "H"
    i, j = N, M
    a1: list = []
    a2: list = []
    while i > 0 or j > 0:
        if state == "H":
            if j == 0:
                state = "F"
                continue
            if i == 0:
                a1.append(BASES[s1[j - 1]])
                a2.append("-")
                j -= 1
                continue
            sub = cfg.sub_score(int(s1[j - 1]), int(s2[i - 1]))
            if H[i, j] == H[i - 1, j - 1] + sub:
                a1.append(BASES[s1[j - 1]])
                a2.append(BASES[s2[i - 1]])
                i, j = i - 1, j - 1
            elif H[i, j] == F[i, j]:
                state = "F"
            elif H[i, j] == E[i, j]:
                state = "E"
            else:  # pragma: no cover
                raise AssertionError(f"no predecessor at H({i},{j})")
        elif state == "F":
            a1.append("-")
            a2.append(BASES[s2[i - 1]])
            row_open = tb if i == 1 else open_
            close = j > 0 and F[i, j] == H[i - 1, j] + row_open + ext
            i -= 1
            state = "H" if close else "F"
            if i == 0 and state == "F":
                state = "H"  # top edge reached mid-gap (tb-waived entry)
        else:  # E
            a1.append(BASES[s1[j - 1]])
            a2.append("-")
            close = i > 0 and E[i, j] == H[i, j - 1] + open_ + ext
            j -= 1
            state = "H" if close else "E"
            if j == 0:
                state = "H"
    return sc, "".join(reversed(a1)), "".join(reversed(a2))


# ---------------------------------------------------------------------------
# bucketed device scans: (H, F) boundary rows
# ---------------------------------------------------------------------------


def _bucket(x: int) -> int:
    return max(8, 1 << (x - 1).bit_length())


@functools.lru_cache(maxsize=64)
def _scan_fn(mb: int, nb: int, cfg: ScoringConfig):
    """Jitted ``(s1_pad, s2_pad, n, tb) -> (H_row, F_row)`` at true row n.

    Shapes are the padded buckets; column junk beyond the true ``m`` never
    flows left (the row resolve's cummax runs left-to-right), rows beyond
    ``n`` are frozen by a ``where`` on the scan carry.
    """
    import jax
    import jax.numpy as jnp

    open_ = jnp.int32(cfg.gap_open)
    ext = jnp.int32(cfg.gap_extend)
    match = jnp.int32(cfg.match)
    mismatch = jnp.int32(cfg.mismatch)
    NEG_INF = jnp.int32(-(2**30))
    if cfg.has_matrix:
        matf = jnp.asarray(_mat17(cfg).reshape(-1), jnp.int32)

        def subs(s1p, base):
            return matf[s1p * 17 + base]
    else:
        def subs(s1p, base):
            return jnp.where(s1p == base, match, mismatch)

    @jax.jit
    def fn(s1p, s2p, n, tb):
        jext = jnp.arange(mb + 1, dtype=jnp.int32) * ext
        h0 = open_ + jext
        h0 = h0.at[0].set(0)
        f0 = h0 + tb

        def step(carry, xs):
            h_prev, f_prev = carry
            base, k = xs
            sub = subs(s1p, base)
            f = jnp.maximum(h_prev + jnp.where(k == 0, tb, open_),
                            f_prev) + ext
            t = jnp.maximum(h_prev[:-1] + sub, f[1:])
            left0 = tb + (k + 1) * ext  # H[i][0] = tb + i*ext
            t = jnp.concatenate([left0[None], t])
            c = jax.lax.associative_scan(jnp.maximum, t - jext)
            e = jnp.concatenate([NEG_INF[None], c[:-1]]) + open_ + jext
            h = jnp.maximum(t, e)
            live = k < n
            h = jnp.where(live, h, h_prev)
            f = jnp.where(live, f, f_prev)
            return (h, f), 0

        ks = jnp.arange(nb, dtype=jnp.int32)
        (h, f), _ = jax.lax.scan(step, (h0, f0), (s2p, ks))
        return h, f

    return fn


#: sentinel code that equals no real base (bases are 1..4); matrix
#: configs pad with 16 instead — the decaying sentinel row of _mat17
_PAD = 9


def _pad_code(cfg: ScoringConfig) -> int:
    return 16 if cfg.has_matrix else _PAD


def _scan(s1: np.ndarray, s2: np.ndarray, cfg: ScoringConfig, tb: int):
    """(H, F) rows (numpy, length m+1) after aligning all of ``s2``."""
    m, n = s1.size, s2.size
    mb, nb = _bucket(m), _bucket(n)
    s1p = np.full(mb, _pad_code(cfg), np.int32)
    s1p[:m] = s1
    s2p = np.full(nb, _pad_code(cfg), np.int32)
    s2p[:n] = s2
    import jax.numpy as jnp

    h, f = _scan_fn(mb, nb, cfg)(
        jnp.asarray(s1p), jnp.asarray(s2p), jnp.int32(n), jnp.int32(tb)
    )
    return np.asarray(h)[: m + 1], np.asarray(f)[: m + 1]


# ---------------------------------------------------------------------------
# Myers-Miller recursion
# ---------------------------------------------------------------------------


def _solve(s1, s2, cfg, tb, te, a1: list, a2: list) -> int:
    """Emit the alignment of this node into a1/a2; returns the node score
    (so the root call IS the total score — no separate scoring pass)."""
    from ..io.bdna import BASES

    m, n = s1.size, s2.size
    if (m + 1) * (n + 1) <= BASE_CELLS or n < 2:
        sc, b1, b2 = _base_align(s1, s2, cfg, tb, te)
        a1.append(b1)
        a2.append(b2)
        return sc
    mid = n // 2
    hf, ff = _scan(s1, s2[:mid], cfg, tb)
    hr, fr = _scan(s1[::-1], s2[mid:][::-1], cfg, te)
    h_case = hf + hr[::-1]
    f_case = ff + fr[::-1] - np.int64(cfg.gap_open)
    jh = int(np.argmax(h_case))
    jf = int(np.argmax(f_case))
    if h_case[jh] >= f_case[jf]:  # path touches (mid, jh) gap-free
        _solve(s1[:jh], s2[:mid], cfg, tb, cfg.gap_open, a1, a2)
        _solve(s1[jh:], s2[mid:], cfg, cfg.gap_open, te, a1, a2)
        return int(h_case[jh])
    # a vertical gap spans rows mid..mid+1 at column jf
    _solve(s1[:jf], s2[: mid - 1], cfg, tb, 0, a1, a2)
    a1.append("--")
    a2.append(BASES[s2[mid - 1]] + BASES[s2[mid]])
    _solve(s1[jf:], s2[mid + 1:], cfg, 0, te, a1, a2)
    return int(f_case[jf])


@functools.lru_cache(maxsize=32)
def _locate_fn(mb: int, nb: int, cfg: ScoringConfig):
    """Jitted ``(s1_pad, s2_pad, n) -> (best, i, j)``: the Smith-Waterman
    optimum and its row-major-FIRST cell (strict improvement test, matching
    the oracle's convention), bucketed like :func:`_scan_fn`."""
    import jax
    import jax.numpy as jnp

    open_ = jnp.int32(cfg.gap_open)
    ext = jnp.int32(cfg.gap_extend)
    match = jnp.int32(cfg.match)
    mismatch = jnp.int32(cfg.mismatch)
    NEG_INF = jnp.int32(-(2**30))
    if cfg.has_matrix:
        matf = jnp.asarray(_mat17(cfg).reshape(-1), jnp.int32)

        def subs(s1p, base):
            return matf[s1p * 17 + base]
    else:
        def subs(s1p, base):
            return jnp.where(s1p == base, match, mismatch)

    @jax.jit
    def fn(s1p, s2p, n):
        jext = jnp.arange(mb + 1, dtype=jnp.int32) * ext
        h0 = jnp.zeros(mb + 1, jnp.int32)
        f0 = jnp.full(mb + 1, NEG_INF, jnp.int32)

        def step(carry, xs):
            h_prev, f_prev, best, bi, bj = carry
            base, k = xs
            sub = subs(s1p, base)
            f = jnp.maximum(h_prev + open_, f_prev) + ext
            t = jnp.maximum(jnp.maximum(h_prev[:-1] + sub, f[1:]), 0)
            t = jnp.concatenate([jnp.zeros(1, jnp.int32), t])
            c = jax.lax.associative_scan(jnp.maximum, t - jext)
            e = jnp.concatenate([NEG_INF[None], c[:-1]]) + open_ + jext
            h = jnp.maximum(t, e)
            live = k < n
            rmax = jnp.max(jnp.where(live, h, NEG_INF))
            better = rmax > best
            best = jnp.where(better, rmax, best)
            bi = jnp.where(better, k + 1, bi)
            bj = jnp.where(better, jnp.argmax(h).astype(jnp.int32), bj)
            h = jnp.where(live, h, h_prev)
            f = jnp.where(live, f, f_prev)
            return (h, f, best, bi, bj), 0

        ks = jnp.arange(nb, dtype=jnp.int32)
        (h, f, best, bi, bj), _ = jax.lax.scan(
            step, (h0, f0, jnp.int32(0), jnp.int32(0), jnp.int32(0)),
            (s2p, ks))
        return best, bi, bj

    return fn


def _locate(s1: np.ndarray, s2: np.ndarray, cfg: ScoringConfig):
    m, n = s1.size, s2.size
    mb, nb = _bucket(m), _bucket(n)
    s1p = np.full(mb, _pad_code(cfg), np.int32)
    s1p[:m] = s1
    s2p = np.full(nb, _pad_code(cfg), np.int32)
    s2p[:n] = s2
    import jax.numpy as jnp

    best, i, j = _locate_fn(mb, nb, cfg)(
        jnp.asarray(s1p), jnp.asarray(s2p), jnp.int32(n))
    return int(best), int(i), int(j)


@functools.lru_cache(maxsize=32)
def _first_hit_fn(mb: int, nb: int, cfg: ScoringConfig):
    """Jitted ``(s1_pad, s2_pad, n, m, target) -> (i, j)``: the first
    (row-major) cell of the GLOBAL affine fill whose H equals ``target``.

    Used on the reversed prefix pair to anchor the SW path start: the
    global fill from the reversed origin IS the set of path scores ending
    at the located forward cell, so the first cell hitting the optimum is
    a valid start.
    """
    import jax
    import jax.numpy as jnp

    open_ = jnp.int32(cfg.gap_open)
    ext = jnp.int32(cfg.gap_extend)
    match = jnp.int32(cfg.match)
    mismatch = jnp.int32(cfg.mismatch)
    NEG_INF = jnp.int32(-(2**30))
    if cfg.has_matrix:
        matf = jnp.asarray(_mat17(cfg).reshape(-1), jnp.int32)

        def subs(s1p, base):
            return matf[s1p * 17 + base]
    else:
        def subs(s1p, base):
            return jnp.where(s1p == base, match, mismatch)

    @jax.jit
    def fn(s1p, s2p, n, m, target):
        jext = jnp.arange(mb + 1, dtype=jnp.int32) * ext
        h0 = open_ + jext
        h0 = h0.at[0].set(0)
        f0 = h0 + open_
        col_ok = jnp.arange(mb + 1, dtype=jnp.int32) <= m

        def step(carry, xs):
            h_prev, f_prev, found, bi, bj = carry
            base, k = xs
            sub = subs(s1p, base)
            f = jnp.maximum(h_prev + open_, f_prev) + ext
            t = jnp.maximum(h_prev[:-1] + sub, f[1:])
            left0 = open_ + (k + 1) * ext
            t = jnp.concatenate([left0[None], t])
            c = jax.lax.associative_scan(jnp.maximum, t - jext)
            e = jnp.concatenate([NEG_INF[None], c[:-1]]) + open_ + jext
            h = jnp.maximum(t, e)
            live = k < n
            hit = (h == target) & col_ok & live
            j_hit = jnp.argmax(hit).astype(jnp.int32)
            take = jnp.any(hit) & ~found
            bi = jnp.where(take, k + 1, bi)
            bj = jnp.where(take, j_hit, bj)
            found = found | take
            h = jnp.where(live, h, h_prev)
            f = jnp.where(live, f, f_prev)
            return (h, f, found, bi, bj), 0

        ks = jnp.arange(nb, dtype=jnp.int32)
        (_, _, found, bi, bj), _ = jax.lax.scan(
            step, (h0, f0, jnp.bool_(False), jnp.int32(-1), jnp.int32(-1)),
            (s2p, ks))
        return found, bi, bj

    return fn


@functools.lru_cache(maxsize=32)
def _locate_flex_fn(mb: int, nb: int, cfg: ScoringConfig, zr: bool,
                    zc: bool, ext_col: bool):
    """Jitted ``(s1_pad, s2_pad, n, m) -> (br, brj, bc, bci)``: the
    last-row max/argmax and (when ``ext_col``) the last-column running
    max/argmax of the affine fill with (zr, zc) zero boundaries — the
    Gotoh analog of ``native.locate_flex``'s extraction, on the portable
    scan (native argmax conventions: first occurrence)."""
    import jax
    import jax.numpy as jnp

    open_ = jnp.int32(cfg.gap_open)
    ext = jnp.int32(cfg.gap_extend)
    match = jnp.int32(cfg.match)
    mismatch = jnp.int32(cfg.mismatch)
    NEG_INF = jnp.int32(-(2**30))
    if cfg.has_matrix:
        matf = jnp.asarray(_mat17(cfg).reshape(-1), jnp.int32)

        def subs(s1p, base):
            return matf[s1p * 17 + base]
    else:
        def subs(s1p, base):
            return jnp.where(s1p == base, match, mismatch)

    @jax.jit
    def fn(s1p, s2p, n, m):
        jext = jnp.arange(mb + 1, dtype=jnp.int32) * ext
        cols = jnp.arange(mb + 1, dtype=jnp.int32)
        col_ok = cols <= m
        if zr:
            h0 = jnp.zeros(mb + 1, jnp.int32)
        else:
            h0 = (open_ + jext).at[0].set(0)
        f0 = jnp.full(mb + 1, NEG_INF, jnp.int32)
        bc0 = h0[jnp.minimum(m, mb)]  # H(0, m) seeds the column max

        def step(carry, xs):
            h_prev, f_prev, bc, bci = carry
            base, k = xs
            sub = subs(s1p, base)
            f = jnp.maximum(h_prev + open_, f_prev) + ext
            t = jnp.maximum(h_prev[:-1] + sub, f[1:])
            left0 = jnp.int32(0) if zc else open_ + (k + 1) * ext
            t = jnp.concatenate([left0[None], t])
            c = jax.lax.associative_scan(jnp.maximum, t - jext)
            e = jnp.concatenate([NEG_INF[None], c[:-1]]) + open_ + jext
            h = jnp.maximum(t, e)
            live = k < n
            if ext_col:
                hm = h[jnp.minimum(m, mb)]
                better = live & (hm > bc)
                bc = jnp.where(better, hm, bc)
                bci = jnp.where(better, k + 1, bci)
            h = jnp.where(live, h, h_prev)
            f = jnp.where(live, f, f_prev)
            return (h, f, bc, bci), 0

        ks = jnp.arange(nb, dtype=jnp.int32)
        (h, _, bc, bci), _ = jax.lax.scan(
            step, (h0, f0, bc0, jnp.int32(0)), (s2p, ks))
        hrow = jnp.where(col_ok, h, NEG_INF)
        brj = jnp.argmax(hrow).astype(jnp.int32)
        return hrow[brj], brj, bc, bci

    return fn


def locate_flex(s1, s2, cfg: ScoringConfig, *, anchored: bool = False):
    """(score, ie, je) of an optimal extraction cell of the AFFINE
    ends-free fill — mirrors ``native.locate_flex``'s boundary forms and
    argmax conventions (forward: mode boundaries; anchored: global
    boundaries on the reversed prefixes, same extraction set)."""
    if not (cfg.is_affine and cfg.is_ends_free):
        raise ValueError("locate_flex here serves affine sg/infix configs")
    s1 = np.asarray(s1, np.int32)
    s2 = np.asarray(s2, np.int32)
    m, n = s1.size, s2.size
    if anchored:
        zr = zc = False
    else:
        zr, zc = cfg.free_start_s1, cfg.free_start_s2
    ext_col = cfg.free_end_s2
    if n == 0 or m == 0:
        def bound(length, zero):
            out = np.zeros(length + 1, np.int64)
            if not zero and length:
                out[1:] = cfg.gap_open + np.arange(
                    1, length + 1, dtype=np.int64) * cfg.gap_extend
            return out

        row = bound(m, zr)
        col = bound(n, zc)
        if n == 0:
            brj = int(row.argmax())
            if ext_col and int(row[m]) > int(row[brj]):
                return int(row[m]), 0, m
            return int(row[brj]), 0, brj
        br = int(col[n])
        if ext_col:
            i = int(col.argmax())
            if int(col[i]) > br:
                return int(col[i]), i, 0
        return br, n, 0
    mb, nb = _bucket(m), _bucket(n)
    s1p = np.full(mb, _pad_code(cfg), np.int32)
    s1p[:m] = s1
    s2p = np.full(nb, _pad_code(cfg), np.int32)
    s2p[:n] = s2
    import jax.numpy as jnp

    br, brj, bc, bci = _locate_flex_fn(mb, nb, cfg, zr, zc, ext_col)(
        jnp.asarray(s1p), jnp.asarray(s2p), jnp.int32(n), jnp.int32(m))
    br, brj, bc, bci = int(br), int(brj), int(bc), int(bci)
    if ext_col and bc > br:
        return bc, bci, m
    return br, n, brj


def align_local(
    s1,
    s2,
    cfg: ScoringConfig,
) -> Tuple[int, str, str]:
    """Local (Smith-Waterman) affine alignment at any size, linear space.

    Locate the optimal END cell with the SW device scan; anchor the START
    by running the GLOBAL affine fill on the reversed prefix pair until a
    cell hits the optimum (every such cell is the start of an optimal
    path ending exactly at the located cell); then hand the matched
    substrings to the global Myers-Miller machinery — an optimal local
    path is exactly an optimal GLOBAL affine path of its matched
    substrings.  Returns the aligned strings of the matched substrings
    like ``oracle.traceback`` local mode.
    """
    _check_affine_align_cfg(cfg)
    if not (cfg.is_affine and cfg.is_local):
        raise ValueError("align_local requires a local affine config")
    if not cfg.has_matrix and cfg.mismatch > 0:
        # pad columns must decay for the locate scan's row max; matrix
        # configs decay by construction (_mat17's sentinel rows)
        raise ValueError(
            "positive-mismatch local affine configs are outside this "
            "engine's envelope")
    s1 = np.asarray(s1, np.int32)
    s2 = np.asarray(s2, np.int32)
    best, ie, je = _locate(s1, s2, cfg)
    if best <= 0:
        return 0, "", ""
    r1 = s1[:je][::-1].copy()
    r2 = s2[:ie][::-1].copy()
    mb, nb = _bucket(r1.size), _bucket(r2.size)
    s1p = np.full(mb, _pad_code(cfg), np.int32)
    s1p[: r1.size] = r1
    s2p = np.full(nb, _pad_code(cfg), np.int32)
    s2p[: r2.size] = r2
    import jax.numpy as jnp

    found, i2, j2 = _first_hit_fn(mb, nb, cfg)(
        jnp.asarray(s1p), jnp.asarray(s2p), jnp.int32(r2.size),
        jnp.int32(r1.size), jnp.int32(best))
    assert bool(found), "reverse anchor fill never reached the optimum"
    i0, j0 = ie - int(i2), je - int(j2)
    import dataclasses

    gcfg = dataclasses.replace(cfg, mode=type(cfg.mode).GLOBAL)
    sc, a1, a2 = align(s1[j0:je], s2[i0:ie], gcfg)
    assert sc == best, (sc, best)
    return best, a1, a2


def align(
    s1,
    s2,
    cfg: ScoringConfig,
) -> Tuple[int, str, str]:
    """Global affine-gap alignment in linear space, any size.

    Returns ``(score, a1, a2)`` like :func:`oracle.traceback`; the path is
    optimal (tie choices may differ from the oracle's conventions — the
    score and validity are what is guaranteed, as with Hirschberg).
    """
    _check_affine_align_cfg(cfg)
    if not cfg.is_affine:
        raise ValueError("align() in affine_align requires an affine config")
    if cfg.is_local:
        return align_local(s1, s2, cfg)
    s1 = np.asarray(s1, np.int32)
    s2 = np.asarray(s2, np.int32)
    if s1.size == 0 and s2.size == 0:
        return 0, "", ""
    a1: list = []
    a2: list = []
    sc = _solve(s1, s2, cfg, cfg.gap_open, cfg.gap_open, a1, a2)
    return sc, "".join(a1), "".join(a2)
