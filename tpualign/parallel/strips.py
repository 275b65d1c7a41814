"""Multi-chip strip-pipelined DP fill: the successor of ``src/mpi/mpi-vert.cpp``.

Decomposition (reference ``mpi-vert.cpp:4-111``, ``mpi-vert-driver.cpp:35-38``):
the DP table's *column* axis is cut into P contiguous strips, one per chip, and
each strip is filled top-to-bottom in row-chunks of depth ``chunk_rows``.  The
reference pipelines rank r's chunk ``h`` behind rank r-1's chunk ``h`` with
blocking ``MPI_Send``/``MPI_Recv`` of the boundary column (``COMMBUF_SIZE``-row
pieces, ``nw-mpi.hpp:18``).  Here the same wavefront pipeline is expressed as an
SPMD program under ``jax.shard_map``: one ``lax.scan`` over super-steps, where
each step every chip fills one chunk of its strip and the boundary column moves
one chip to the right via ``lax.ppermute`` — XLA hands the halo exchange to
NCCL over NVLink, with no rank-role case analysis (the reference needs
three: send-only rank 0, recv-only last rank, middle ranks, ``mpi-horz.cpp:23-96``).

At super-step ``t`` chip ``c`` works on chunk ``h = t - c``; chips outside
``0 <= h < K`` compute a dummy chunk and mask their carries — the pipeline
fill/drain bubble costs ``(P-1)/(K+P-1)`` efficiency, identical in shape to the
reference's ramp-up (SURVEY.md §3.3).  ``chunk_rows`` is the tuning knob that
succeeds ``COMMBUF_SIZE`` (swept by ``src/buf-tune.sh``): deeper chunks amortize
collective latency, shallower chunks shorten the bubble.

The per-chunk fill is the pure-XLA row scan (``ops/xla.py``); sequences are
padded per shard, and the true score cell ``H[N][M]`` is extracted with masked
selects since padding columns/rows lie strictly right/below of it.

Affine (Gotoh) configs shard too: the halo becomes an (H, E) column pair —
the horizontal-gap chain crosses the column split, the vertical F chain
never does (it is carried chip-locally chunk to chunk like the top row) —
and the incoming E seeds the in-row cummax resolve
(:func:`_chunk_fill_affine`).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ensure_pair_modes, ScoringConfig
from ..ops import xla as xla_ops
from .mesh import AXIS, make_mesh

NEG_INF = jnp.int32(-(2**30))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _chunk_fill(
    s1_local: jax.Array,  # (W,) local columns, padded with sentinel 0
    s2_chunk: jax.Array,  # (C,) chunk rows, padded with sentinel 0
    h_top: jax.Array,  # (W+1,) row above the chunk, incl. left corner
    left_col: jax.Array,  # (C,) boundary column for the chunk's rows
    row_valid: jax.Array,  # (C,) bool, False on padding rows (SW masking)
    col_valid: jax.Array,  # (W,) bool, False on padding columns
    sel: jax.Array,  # local column index to tap (score extraction)
    best0: jax.Array,  # running-max init (pre-varied by the caller)
    cfg: ScoringConfig,
):
    """Fill one C x W chunk.  Returns (last row incl. corner, right boundary
    column, tapped column values, masked running max)."""
    W = s1_local.shape[0]
    jg = jnp.arange(W + 1, dtype=jnp.int32) * jnp.int32(cfg.gap)

    def step(carry, xs):
        h_prev, best = carry
        base, l0, rv = xs
        h = xla_ops._row_step(s1_local, jg, cfg, h_prev, l0, base)
        if cfg.is_local:
            cell_ok = rv & col_valid
            best = jnp.maximum(best, jnp.max(jnp.where(cell_ok, h[1:], NEG_INF)))
        return (h, best), (h[W], h[sel])

    (h_last, best), (right_col, tap_col) = jax.lax.scan(
        step, (h_top, best0), (s2_chunk, left_col, row_valid)
    )
    return h_last, right_col, tap_col, best


def _chunk_fill_affine(
    s1_local: jax.Array,  # (W,)
    s2_chunk: jax.Array,  # (C,)
    h_top: jax.Array,  # (W+1,) H row above the chunk, incl. left corner
    f_top: jax.Array,  # (W,) F row above the chunk (own columns only —
    #                    the F chain never crosses the column sharding)
    left_h: jax.Array,  # (C,) halo H column (left edge)
    left_e: jax.Array,  # (C,) halo E column: seeds the in-row resolve
    row_valid: jax.Array,
    col_valid: jax.Array,
    sel: jax.Array,
    best0: jax.Array,
    cfg: ScoringConfig,
):
    """Gotoh chunk fill.  The in-row E dependency unrolls to the usual
    cummax with ONE extra seed: the incoming chain ``E_in + j*ext`` enters
    as ``E_in - open`` at position 0 (``E[j] = open + j*ext +
    cummax(T[k] - k*ext, E_in - open)``).  Returns (H last row, F last
    row, right (H, E) halo columns, tapped column, masked running max)."""
    W = s1_local.shape[0]
    open_ = jnp.int32(cfg.gap_open)
    ext = jnp.int32(cfg.gap_extend)
    match = jnp.int32(cfg.match)
    mismatch = jnp.int32(cfg.mismatch)
    jext = jnp.arange(W + 1, dtype=jnp.int32) * ext

    def step(carry, xs):
        h_prev, f_prev, best = carry
        base, l0h, l0e, rv = xs
        sub = jnp.where(s1_local == base, match, mismatch)
        f = jnp.maximum(h_prev[1:] + open_, f_prev) + ext
        t = jnp.maximum(h_prev[:-1] + sub, f)
        if cfg.is_local:
            t = jnp.maximum(t, 0)
        t = jnp.concatenate([l0h[None], t])
        seed = t - jext
        seed = seed.at[0].set(jnp.maximum(seed[0], l0e - open_))
        cmax = jax.lax.associative_scan(jnp.maximum, seed)
        e = jnp.concatenate([NEG_INF[None], cmax[:-1]]) + open_ + jext
        h = jnp.maximum(t, e)
        if cfg.is_local:
            cell_ok = rv & col_valid
            best = jnp.maximum(
                best, jnp.max(jnp.where(cell_ok, h[1:], NEG_INF))
            )
        return (h, f, best), (h[W], e[W], h[sel])

    (h_last, f_last, best), (right_h, right_e, tap_col) = jax.lax.scan(
        step, (h_top, f_top, best0), (s2_chunk, left_h, left_e, row_valid)
    )
    return h_last, f_last, right_h, right_e, tap_col, best


def _strip_pipeline_body(
    cfg: ScoringConfig,
    n_rows: int,  # true N (len s2)
    m_cols: int,  # true M (len s1)
    chunk: int,  # C
    n_chunks: int,  # K
    s1_local: jax.Array,  # (W,)
    s2_full: jax.Array,  # (K*C,) replicated, padded
) -> jax.Array:
    P = jax.lax.axis_size(AXIS)
    c = jax.lax.axis_index(AXIS)
    W = s1_local.shape[0]
    g = jnp.int32(cfg.gap)
    local = cfg.is_local
    col_off = c * W  # global column index of local column 0 (0-based DP col)

    own_global_cols = col_off + 1 + jnp.arange(W, dtype=jnp.int32)
    col_valid = own_global_cols <= m_cols
    # shard and local index of the true last column M
    c_own = jnp.int32((m_cols - 1) // W)
    sel = jnp.where(c == c_own, jnp.int32((m_cols - 1) % W + 1), jnp.int32(0))
    h_last_chunk = jnp.int32((n_rows - 1) // chunk)
    sel_row = jnp.int32((n_rows - 1) % chunk)

    affine = cfg.is_affine
    if affine:
        open_ = jnp.int32(cfg.gap_open)
        ext = jnp.int32(cfg.gap_extend)
    if local:
        top0 = jax.lax.pcast(jnp.zeros(W + 1, dtype=jnp.int32), AXIS, to='varying')
        corner0 = jax.lax.pcast(jnp.int32(0), AXIS, to='varying')
    elif affine:
        cols = jnp.concatenate([col_off[None], own_global_cols])
        top0 = jnp.where(cols == 0, 0, open_ + cols * ext)
        corner0 = jnp.where(col_off == 0, 0, open_ + col_off * ext)
    else:
        top0 = jnp.concatenate([col_off[None], own_global_cols]) * g
        corner0 = col_off * g  # H[0][col_off], diag dep of my chunk-0 corner cell

    def superstep(carry, t):
        h_top, f_top, corner, left_in, left_in_e, best, score = carry
        h = t - c  # my chunk index this step
        active = (h >= 0) & (h < n_chunks)
        hc = jnp.clip(h, 0, n_chunks - 1)
        r0 = hc * chunk  # global row above the chunk (0-based DP row)

        s2_chunk = jax.lax.dynamic_slice(s2_full, (r0,), (chunk,))
        rows = r0 + 1 + jnp.arange(chunk, dtype=jnp.int32)
        row_valid = rows <= n_rows
        # shard 0 sits on the global left boundary: H[i][0] = i*gap (NW) / 0
        # (SW) / open + i*ext (affine NW); interior shards receive the halo
        # column(s) from their neighbor
        if local:
            bnd = jnp.zeros(chunk, dtype=jnp.int32)
        elif affine:
            bnd = open_ + rows * ext
        else:
            bnd = rows * g
        left_col = jnp.where(c == 0, bnd, left_in)

        h_top_full = h_top.at[0].set(corner)
        if affine:
            # chip 0's E halo is the true E(i, 0) = -inf boundary
            left_e = jnp.where(c == 0, NEG_INF, left_in_e)
            h_last, f_last, right_col, right_e, tap_col, cbest = (
                _chunk_fill_affine(
                    s1_local, s2_chunk, h_top_full, f_top, left_col,
                    left_e, row_valid, col_valid, sel,
                    jax.lax.pcast(NEG_INF, AXIS, to='varying'), cfg,
                )
            )
            f_top = jnp.where(active, f_last, f_top)
        else:
            h_last, right_col, tap_col, cbest = _chunk_fill(
                s1_local, s2_chunk, h_top_full, left_col, row_valid,
                col_valid, sel,
                jax.lax.pcast(NEG_INF, AXIS, to='varying'), cfg,
            )
            right_e = left_in_e  # unused linear carry, kept for shape

        # carries update only while this chip is inside the wavefront;
        # the next chunk's corner H[r0+C][col_off] is my left column's last row
        h_top = jnp.where(active, h_last, h_top)
        corner = jnp.where(active, left_col[chunk - 1], corner)
        if local:
            best = jnp.where(active, jnp.maximum(best, cbest), best)
        else:
            score = jnp.where(
                active & (c == c_own) & (hc == h_last_chunk),
                tap_col[sel_row],
                score,
            )

        # halo: my right boundary column(s) become my right neighbor's left
        perm = [(i, i + 1) for i in range(P - 1)]
        left_next = jax.lax.ppermute(right_col, AXIS, perm)
        left_next_e = jax.lax.ppermute(right_e, AXIS, perm) if affine \
            else left_in_e
        return (h_top, f_top, corner, left_next, left_next_e, best,
                score), None

    # constant-valued carry components must still be marked device-varying
    # (each shard's copy diverges from step 1); top0/corner0 already vary via c
    def vary(x):
        return jax.lax.pcast(x, AXIS, to='varying')

    init = (
        top0,
        vary(jnp.full(W, NEG_INF, dtype=jnp.int32)),  # f_top (affine)
        corner0,
        vary(jnp.zeros(chunk, dtype=jnp.int32)),
        vary(jnp.full(chunk, NEG_INF, dtype=jnp.int32)),  # E halo (affine)
        vary(NEG_INF),
        vary(NEG_INF),
    )
    steps = jnp.arange(n_chunks + P - 1, dtype=jnp.int32)
    (h_top, _, _, _, _, best, score), _ = jax.lax.scan(
        superstep, init, steps)

    if local:
        out = jnp.maximum(jax.lax.pmax(best, AXIS), 0)
    else:
        out = jax.lax.pmax(score, AXIS)  # only c_own committed a real value
    return out[None]


def _strip_pipeline_score(
    cfg: ScoringConfig,
    n_rows: int,
    m_cols: int,
    chunk: int,
    n_chunks: int,
    mesh,
    s1_sharded: jax.Array,
    s2_full: jax.Array,
) -> jax.Array:
    body = functools.partial(
        _strip_pipeline_body, cfg, n_rows, m_cols, chunk, n_chunks
    )
    P = jax.sharding.PartitionSpec
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(AXIS), P()),
        out_specs=P(AXIS),
    )
    return fn(s1_sharded, s2_full)


def score(
    s1,
    s2,
    cfg: ScoringConfig = ScoringConfig(),
    *,
    mesh=None,
    chunk_rows: int = 2048,
) -> int:
    """Alignment score with the table column axis sharded over the mesh.

    Matches the serial semantics exactly (score-exact vs ``serial.cpp``); the
    decomposition mirrors ``src/mpi/mpi-vert.cpp`` with ``chunk_rows`` playing
    the role of ``COMMBUF_SIZE``.
    """
    ensure_pair_modes(cfg, "strips")
    if mesh is None:
        mesh = make_mesh()
    P = mesh.devices.size
    s1 = np.asarray(s1)
    s2 = np.asarray(s2)
    m, n = int(s1.size), int(s2.size)
    if m == 0 or n == 0:
        if cfg.is_local:
            return 0
        if cfg.is_affine:
            L = m + n
            return 0 if L == 0 else cfg.gap_open + cfg.gap_extend * L
        return cfg.gap * (m + n)

    chunk = int(min(chunk_rows, _round_up(n, 8)))
    n_chunks = -(-n // chunk)
    w = -(-m // P)
    s1_pad = np.zeros(P * w, dtype=np.int32)
    s1_pad[:m] = s1
    s2_pad = np.zeros(n_chunks * chunk, dtype=np.int32)
    s2_pad[:n] = s2

    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(AXIS))
    s1_dev = jax.device_put(jnp.asarray(s1_pad), sharding)
    s2_dev = jax.device_put(
        jnp.asarray(s2_pad), jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    )
    out = _strip_pipeline_score(
        cfg, n, m, chunk, n_chunks, mesh, s1_dev, s2_dev
    )
    return int(np.asarray(out)[0])


def score_fn(
    m: int,
    n: int,
    cfg: ScoringConfig = ScoringConfig(),
    *,
    mesh=None,
    chunk_rows: int = 2048,
):
    """Jittable sharded ``(s1_padded, s2_padded) -> score`` for fixed lengths.

    Caller must pre-pad: ``s1`` to ``P * ceil(m/P)`` columns, ``s2`` to
    ``n_chunks * chunk`` rows (see :func:`score` for the exact layout).
    """
    ensure_pair_modes(cfg, "strips")
    if mesh is None:
        mesh = make_mesh()
    P = mesh.devices.size
    chunk = int(min(chunk_rows, _round_up(n, 8)))
    n_chunks = -(-n // chunk)

    def fn(s1_pad: jax.Array, s2_pad: jax.Array) -> jax.Array:
        return _strip_pipeline_score(cfg, n, m, chunk, n_chunks, mesh, s1_pad, s2_pad)

    return fn, (P * (-(-m // P)), n_chunks * chunk)
