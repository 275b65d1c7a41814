"""The plain reference: alignment scores by the anti-diagonal wavefront.

It imports nothing of the program under test and takes its scoring from the
configuration file, so it shares no code, table or constant with what it
checks.  The recurrence is Gotoh's, written out cell by cell: with ``O`` the
gap-open and ``X`` the gap-extend score, a gap of length ``L`` scores
``O + L X`` (linear gaps are ``O = 0``, ``X = gap``), and for cell ``(i, j)``
of the pair ``(a, b)``

    E(i, j) = max(H(i, j-1) + O + X, E(i, j-1) + X)      gap consuming b
    F(i, j) = max(H(i-1, j) + O + X, F(i-1, j) + X)      gap consuming a
    H(i, j) = max(H(i-1, j-1) + s(a_i, b_j), E(i, j), F(i, j)[, 0 if local])

with ``H(0, 0) = 0``, ``H(i, 0) = O + i X``, ``H(0, j) = O + j X`` in global
mode (0 in local mode) and ``E``, ``F`` minus infinity on the boundary.  The
global score is ``H(m, n)``; the local score is the largest ``H``.

Every cell of anti-diagonal ``d = i + j`` depends only on diagonals ``d - 1``
and ``d - 2``, so one loop step computes a whole diagonal as a vector indexed
by ``i``, for a leading batch of pairs at once.  The arithmetic runs in the
integer type ``dtype``: int32 is the reference; a narrower type is the
benchmark's control, which has to come out wrong.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def gap_scores(scoring: dict):
    """``(open, extend)`` of the configuration's scoring."""
    if "gap_open" in scoring:
        return int(scoring["gap_open"]), int(scoring["gap_extend"])
    return 0, int(scoring["gap"])


@functools.partial(jax.jit, static_argnames=(
    "match", "mismatch", "gap_open", "gap_extend", "local", "dtype"))
def _wavefront(a, b, *, match, mismatch, gap_open, gap_extend, local, dtype):
    dt = jnp.dtype(dtype)
    batch, m = a.shape
    n = b.shape[1]
    neg = jnp.asarray(jnp.iinfo(dt).min // 2, dt)
    o_x = jnp.asarray(gap_open + gap_extend, dt)
    x = jnp.asarray(gap_extend, dt)
    zero = jnp.asarray(0, dt)
    ii = jnp.arange(m + 1, dtype=jnp.int32)
    # a_ext[:, i] = a[i-1]; b reversed and padded so that entry i of the
    # slice taken for diagonal d is b[d-1-i] (code 0 outside the sequence)
    a_ext = jnp.concatenate(
        [jnp.zeros((batch, 1), jnp.int32), a.astype(jnp.int32)], axis=1)
    pad = jnp.zeros((batch, m + 1), jnp.int32)
    b_pad = jnp.concatenate([pad, b[:, ::-1].astype(jnp.int32), pad], axis=1)

    def shift(v):  # v[i-1] at i, minus infinity at i = 0
        return jnp.concatenate(
            [jnp.full((batch, 1), neg, dt), v[:, :-1]], axis=1)

    def boundary(k):  # H(k, 0) = H(0, k)
        if local:
            return zero
        return (gap_open + k * gap_extend).astype(dt)

    def step(d, carry):
        h1, h2, e1, f1, best = carry
        j = d - ii
        b_d = jax.lax.dynamic_slice_in_dim(b_pad, m + 1 + n - d, m + 1, axis=1)
        s = jnp.where(a_ext == b_d, jnp.asarray(match, dt),
                      jnp.asarray(mismatch, dt))
        e = jnp.maximum(h1 + o_x, e1 + x)
        f = jnp.maximum(shift(h1) + o_x, shift(f1) + x)
        h = jnp.maximum(shift(h2) + s, jnp.maximum(e, f))
        if local:
            h = jnp.maximum(h, zero)
        inside = (ii >= 1) & (j >= 1) & (j <= n)
        edge = ((ii == 0) & (j <= n)) | ((j == 0) & (ii <= m))
        h = jnp.where(inside, h, jnp.where(edge, boundary(d), neg))
        e = jnp.where(inside, e, neg)
        f = jnp.where(inside, f, neg)
        if local:
            best = jnp.maximum(best, jnp.max(jnp.where(inside, h, neg), axis=1))
        return h, h1, e, f, best

    h0 = jnp.where(ii == 0, zero, neg)[None, :].repeat(batch, axis=0)
    none = jnp.full((batch, m + 1), neg, dt)
    init = (h0, none, none, none, jnp.full((batch,), zero, dt))
    h, _, _, _, best = jax.lax.fori_loop(1, m + n + 1, step, init, unroll=4)
    out = best if local else h[:, m]
    return out.astype(jnp.int32)


def scores(a, b, scoring: dict, dtype: str = "int32") -> np.ndarray:
    """Scores of the pairs ``(a[k], b[k])``: ``a`` is ``(B, m)`` and ``b``
    ``(B, n)``, integer symbol codes, with ``m, n >= 1``."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"pairs must be (B, m) and (B, n), got {a.shape} "
                         f"and {b.shape}")
    if min(a.shape[1], b.shape[1]) < 1:
        raise ValueError("the reference scores non-empty sequences")
    mode = scoring.get("mode", "global")
    if mode not in ("global", "local"):
        raise ValueError(f"the reference has no mode {mode!r}")
    gap_open, gap_extend = gap_scores(scoring)
    out = _wavefront(
        jnp.asarray(a), jnp.asarray(b), match=int(scoring["match"]),
        mismatch=int(scoring["mismatch"]), gap_open=gap_open,
        gap_extend=gap_extend, local=mode == "local", dtype=dtype)
    return np.asarray(out).astype(np.int64)
