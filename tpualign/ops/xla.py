"""Pure-XLA (jax.lax) scorers — portable across GPU and CPU.

This is the framework's "serial" implementation family (successor of the
reference's ``src/serial/serial.cpp`` / ``blocked-serial.cpp``): one device,
compiler-scheduled.  It serves three roles:

1. the engine for every scoring config the bit-parallel kernel does not
   cover (local, general linear, affine, matrix, ends-free), and for every
   config on a backend without that kernel;
2. the per-shard chunk fill inside the multi-device strip pipeline
   (``tpualign.parallel.strips``), where it must compile under ``shard_map``
   on a virtual CPU mesh as well as on real devices;
3. a device-resident reference that runs anywhere (tests execute it on CPU).

The row update uses the max-plus prefix-scan identity (see ``ops/oracle.py``):
the in-row ``left`` dependency ``H[j] = max(T[j], H[j-1]+g)`` becomes
``H = j*g + cummax(T - j*g)`` via ``jax.lax.associative_scan`` — replacing the
reference's branchless scalar chain (``serial.cpp:23-31``) with a log-depth
vector scan, the idiomatic XLA shape for a loop-carried max.

All values are int32, matching the reference's table type.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import AlignMode, ScoringConfig

NEG_INF = jnp.int32(-(2**30))  # safe "minus infinity": far below any real score


def _sub(s1: jax.Array, base: jax.Array, cfg: ScoringConfig) -> jax.Array:
    """Per-column substitution scores for one DP row.

    With a substitution matrix this is a gather ``matrix[s1, base]`` (the
    (K, K) constant is hoisted out of the scan by XLA); otherwise the
    classic match/mismatch select."""
    if cfg.matrix is not None:
        mat = jnp.asarray(cfg.matrix, dtype=jnp.int32)
        return mat[s1, base]
    return jnp.where(
        s1 == base, jnp.int32(cfg.match), jnp.int32(cfg.mismatch)
    )


def _row_step(
    s1: jax.Array,
    jg: jax.Array,
    cfg: ScoringConfig,
    h_prev: jax.Array,
    left0: jax.Array,
    base: jax.Array,
) -> jax.Array:
    """One DP row: previous row ``h_prev`` (len M+1), new row's column-0 value
    ``left0``, current ``s2`` base.  Returns the new row."""
    g = jnp.int32(cfg.gap)
    sub = _sub(s1, base, cfg)
    t = jnp.maximum(h_prev[:-1] + sub, h_prev[1:] + g)
    if cfg.is_local:
        t = jnp.maximum(t, 0)
    # left0 is the row's column-0 value: the global boundary (i*gap, or 0 in
    # local mode) — or, inside a sharded strip, the halo from the left neighbor
    t = jnp.concatenate([left0[None], t])
    v = jax.lax.associative_scan(jnp.maximum, t - jg)
    return v + jg


def _affine_rows_scan(
    s1: jax.Array,
    s2: jax.Array,
    cfg: ScoringConfig,
    h0: jax.Array,
    left_col: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Gotoh fill: returns (last H row, running max, last-column values).

    Per row, the vertical-gap matrix ``F`` is elementwise; the in-row
    horizontal-gap dependency unrolls to a log-depth cummax exactly like
    the linear engines' resolve (valid because ``gap_open <= 0`` — see
    ``oracle._affine_row``): ``E = open + j*ext + cummax_{k<j}(T_k - k*ext)``.
    """
    M = s1.shape[0]
    open_ = jnp.int32(cfg.gap_open)
    ext = jnp.int32(cfg.gap_extend)
    jext = jnp.arange(M + 1, dtype=jnp.int32) * ext

    def step(carry, xs):
        h_prev, f_prev, best = carry
        base, l0 = xs
        sub = _sub(s1, base, cfg)
        f = jnp.maximum(h_prev + open_, f_prev) + ext
        t = jnp.maximum(h_prev[:-1] + sub, f[1:])
        if cfg.is_local:
            t = jnp.maximum(t, 0)
        t = jnp.concatenate([l0[None], t])
        c = jax.lax.associative_scan(jnp.maximum, t - jext)
        e = jnp.concatenate([NEG_INF[None], c[:-1]]) + open_ + jext
        h = jnp.maximum(t, e)
        best = jnp.maximum(best, jnp.max(h))
        return (h, f, best), h[-1]

    f0 = jnp.full(M + 1, NEG_INF, dtype=jnp.int32)
    (h_last, _, best), right_col = jax.lax.scan(
        step, (h0, f0, NEG_INF), (s2, left_col)
    )
    return h_last, best, right_col


def _rows_scan(
    s1: jax.Array,
    s2: jax.Array,
    cfg: ScoringConfig,
    h0: jax.Array,
    left_col: jax.Array,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Fill ``len(s2)`` rows starting from top row ``h0`` and per-row column-0
    values ``left_col``.  Returns (last row, all last-column values, running max).
    """
    M = s1.shape[0]
    jg = jnp.arange(M + 1, dtype=jnp.int32) * jnp.int32(cfg.gap)

    def step(carry, xs):
        h_prev, best = carry
        base, l0 = xs
        h = _row_step(s1, jg, cfg, h_prev, l0, base)
        best = jnp.maximum(best, jnp.max(h))
        return (h, best), h[-1]

    (h_last, best), right_col = jax.lax.scan(
        step, (h0, NEG_INF), (s2, left_col)
    )
    return h_last, right_col, best


@functools.partial(jax.jit, static_argnames=("cfg",))
def _score_impl(s1: jax.Array, s2: jax.Array, cfg: ScoringConfig) -> jax.Array:
    M = s1.shape[0]
    N = s2.shape[0]
    g = jnp.int32(cfg.gap)
    zero_row = cfg.is_local or cfg.free_start_s1  # H(0, j) = 0
    zero_col = cfg.is_local or cfg.free_start_s2  # H(i, 0) = 0

    def extract(h_last, best, right_col):
        if cfg.is_local:
            return jnp.maximum(best, 0)
        if cfg.free_end_s1:
            ans = jnp.max(h_last)
            if cfg.free_end_s2:
                # last column: rows 1..N via the scan outputs, row 0 via h0
                ans = jnp.maximum(ans, jnp.maximum(jnp.max(right_col),
                                                   h0[-1]))
            return ans
        return h_last[-1]

    if cfg.is_affine:
        open_ = jnp.int32(cfg.gap_open)
        ext = jnp.int32(cfg.gap_extend)
        if zero_row:
            h0 = jnp.zeros(M + 1, dtype=jnp.int32)
        else:
            h0 = open_ + jnp.arange(M + 1, dtype=jnp.int32) * ext
            h0 = h0.at[0].set(0)
        if zero_col:
            left = jnp.zeros(N, dtype=jnp.int32)
        else:
            left = open_ + (jnp.arange(N, dtype=jnp.int32) + 1) * ext
        h_last, best, right_col = _affine_rows_scan(s1, s2, cfg, h0, left)
        return extract(h_last, best, right_col)
    if zero_row:
        h0 = jnp.zeros(M + 1, dtype=jnp.int32)
    else:
        h0 = jnp.arange(M + 1, dtype=jnp.int32) * g
    if zero_col:
        left = jnp.zeros(N, dtype=jnp.int32)
    else:
        left = (jnp.arange(N, dtype=jnp.int32) + 1) * g
    h_last, right_col, best = _rows_scan(s1, s2, cfg, h0, left)
    return extract(h_last, best, right_col)


def score(s1, s2, cfg: ScoringConfig = ScoringConfig()) -> int:
    """Alignment score via the XLA row scan.  Accepts NumPy or JAX arrays."""
    s1 = jnp.asarray(s1, dtype=jnp.int32)
    s2 = jnp.asarray(s2, dtype=jnp.int32)
    if s1.shape[0] == 0 or s2.shape[0] == 0:
        # degenerate: all-gap alignment (or empty local/ends-free alignment)
        if cfg.is_local or cfg.mode is AlignMode.SEMIGLOBAL:
            return 0
        # infix: an empty query aligns for free; an empty text forces an
        # all-gap alignment of the query
        L = s1.shape[0] + s2.shape[0]
        if cfg.mode is AlignMode.INFIX:
            L = s2.shape[0]
        if L == 0:
            return 0
        if cfg.is_affine:
            return cfg.gap_open + cfg.gap_extend * L
        return cfg.gap * L
    return int(_score_impl(s1, s2, cfg))


def score_fn(cfg: ScoringConfig = ScoringConfig()):
    """Jittable ``(s1, s2) -> score`` closure for benchmarking/compile checks."""

    def fn(s1: jax.Array, s2: jax.Array) -> jax.Array:
        return _score_impl(s1, s2, cfg)

    return fn


@functools.partial(jax.jit, static_argnames=("cfg",))
def _batch_affine_impl(
    texts: jax.Array,  # (B, m_cap) int32, pad char 14
    queries: jax.Array,  # (B, n_cap) int32, pad char 15
    mts: jax.Array,  # (B,) true text lengths
    nqs: jax.Array,  # (B,) true query lengths
    cfg: ScoringConfig,
) -> jax.Array:
    """Batched Gotoh scores in ONE dispatch: the affine row scan vmapped
    over a padded shape bucket.  Rows past each pair's true length freeze
    the carry; column junk right of the true text never flows left (the
    in-row resolve's cummax runs left-to-right), so extraction at
    ``h[mt]`` (global) / a column-masked running max (local) is exact.
    The two pad codes (14/15) match neither each other nor real bases, so
    padded local cells only decay."""
    m_cap = texts.shape[1]
    open_ = jnp.int32(cfg.gap_open)
    ext = jnp.int32(cfg.gap_extend)
    match = jnp.int32(cfg.match)
    mismatch = jnp.int32(cfg.mismatch)
    jext = jnp.arange(m_cap + 1, dtype=jnp.int32) * ext
    cols = jnp.arange(m_cap + 1, dtype=jnp.int32)

    def one(s1, s2, mt, nq):
        if cfg.is_local:
            h0 = jnp.zeros(m_cap + 1, jnp.int32)
        else:
            h0 = jnp.where(cols == 0, 0, open_ + jext)
        f0 = jnp.full(m_cap + 1, NEG_INF, jnp.int32)
        col_ok = (cols >= 1) & (cols <= mt)

        def step(carry, xs):
            h_prev, f_prev, best = carry
            base, k = xs
            sub = jnp.where(s1 == base, match, mismatch)
            f = jnp.maximum(h_prev + open_, f_prev) + ext
            t = jnp.maximum(h_prev[:-1] + sub, f[1:])
            if cfg.is_local:
                t = jnp.maximum(t, 0)
                left0 = jnp.int32(0)
            else:
                left0 = open_ + (k + 1) * ext
            t = jnp.concatenate([left0[None], t])
            c = jax.lax.associative_scan(jnp.maximum, t - jext)
            e = jnp.concatenate([NEG_INF[None], c[:-1]]) + open_ + jext
            h = jnp.maximum(t, e)
            live = k < nq
            if cfg.is_local:
                rmax = jnp.max(jnp.where(col_ok & live, h, NEG_INF))
                best = jnp.maximum(best, rmax)
            h = jnp.where(live, h, h_prev)
            f = jnp.where(live, f, f_prev)
            return (h, f, best), 0

        ks = jnp.arange(s2.shape[0], dtype=jnp.int32)
        (h, _, best), _ = jax.lax.scan(step, (h0, f0, NEG_INF), (s2, ks))
        if cfg.is_local:
            return jnp.maximum(best, 0)
        return h[mt]

    return jax.vmap(one)(texts, queries, mts, nqs)


def score_batch(texts, queries, cfg: ScoringConfig) -> "np.ndarray":
    """Scores for a batch of pair-scored global or local configs in one
    device dispatch.  Linear gaps run as affine gaps with ``gap_open = 0``,
    which is the same recurrence."""
    if not cfg.is_affine:
        cfg = dataclasses.replace(cfg, gap_open=0, gap_extend=cfg.gap)
    return score_batch_affine(texts, queries, cfg)


def score_batch_affine(texts, queries, cfg: ScoringConfig) -> "np.ndarray":
    """Gotoh scores for a batch of pairs in one device dispatch.

    ``texts``/``queries`` are sequences of int arrays; pairs pad to the
    batch's (m_cap, n_cap) bucket."""
    import numpy as np

    if not cfg.is_affine:
        raise ValueError("score_batch_affine requires an affine config")
    from ..config import ensure_pair_modes

    # the vmapped scan scores with match/mismatch and extracts global/local
    # only — matrix / ends-free configs must not reach it
    ensure_pair_modes(cfg, "score_batch_affine")
    batch = len(texts)
    if batch == 0:
        return np.zeros(0, np.int64)
    mts = np.asarray([len(t) for t in texts], np.int32)
    nqs = np.asarray([len(q) for q in queries], np.int32)
    m_cap = max(1, int(mts.max()))
    n_cap = max(1, int(nqs.max()))
    tp = np.full((batch, m_cap), 14, np.int32)
    qp = np.full((batch, n_cap), 15, np.int32)
    for b in range(batch):
        tp[b, : mts[b]] = np.asarray(texts[b], np.int32)
        qp[b, : nqs[b]] = np.asarray(queries[b], np.int32)
    out = np.asarray(
        _batch_affine_impl(
            jnp.asarray(tp), jnp.asarray(qp), jnp.asarray(mts),
            jnp.asarray(nqs), cfg,
        )
    ).astype(np.int64)
    # degenerate pairs: the scan never fires a live row / has no columns
    for b in range(batch):
        if mts[b] == 0 or nqs[b] == 0:
            L = int(mts[b] + nqs[b])
            if cfg.is_local or L == 0:
                out[b] = 0
            else:
                out[b] = cfg.gap_open + cfg.gap_extend * L
    return out


def last_row(
    s1,
    s2,
    cfg: ScoringConfig = ScoringConfig(),
    *,
    reverse: bool = False,
) -> jax.Array:
    """Final DP row (length M+1) — the Hirschberg building block.

    With ``reverse=True`` computes the last row of the suffix problem (both
    sequences reversed), used to find the optimal split column.
    """
    if cfg.is_affine:
        # splitting affine problems needs BOTH the H and E rows (a gap
        # crossing the split must not be double-opened); the Hirschberg
        # tier is linear/family-only
        raise ValueError("last_row supports linear-gap configs only")
    s1 = jnp.asarray(s1, dtype=jnp.int32)
    s2 = jnp.asarray(s2, dtype=jnp.int32)
    if reverse:
        s1, s2 = s1[::-1], s2[::-1]
    M = s1.shape[0]
    N = s2.shape[0]
    g = jnp.int32(cfg.gap)
    h0 = jnp.arange(M + 1, dtype=jnp.int32) * g
    if N == 0:
        return h0
    left = (jnp.arange(N, dtype=jnp.int32) + 1) * g
    h_last, _, _ = _rows_scan(s1, s2, cfg, h0, left)
    return h_last
