"""Bit-parallel global score: 64 DP cells per machine word, CUDA on Hopper.

Derivation (match=1, mismatch=0, gap=-g)
----------------------------------------
Let ``v = H(i,j) - H(i-1,j)`` (vertical delta) and ``h = H(i,j) - H(i,j-1)``
(horizontal delta).  Both lie in ``[-g, 1+g]``: the gap branch bounds them
below by ``-g``, and ``H(i-1,j-1) >= H(i-1,j) - g`` bounds them above by
``1+g``.  Subtracting ``H(i-1,j-1)`` from the recurrence gives, per cell, with
inputs ``v_in = v(i, j-1)``, ``h_in = h(i-1, j)`` and match bit ``s``:

    T     = max(s, h_in - g, v_in - g)    # = H(i,j) - H(i-1,j-1)
    h_out = T - v_in;   v_out = T - h_in

Since ``h_in - g <= 1`` and ``v_in - g <= 1``, ``T`` is *binary*: ``T = 1``
iff ``s`` or ``v_in = 1+g`` or ``h_in = 1+g`` -- a single "promotion bit"
``P``.  The only dependency along a column is the ``h_in = 1+g`` chain:
``h_out = 1+g`` iff ``P`` and ``v_in = -g``, so a promotion ripples down
exactly through runs of ``v_in = -g`` cells.  That ripple is the carry chain
of one integer add (Myers 1999; BitPAl, Loving, Hernandez & Benson 2014):

    summ = Z + (E & Z) + c_in;   P = E | (v_in = 1+g) | (summ ^ Z)

with ``Z`` the ``v_in = -g`` indicator word, ``E`` the match word of the text
character and ``c_in`` the promotion handed down from the word above.  The
deltas are stored as ``B = bit_length(2g+1)`` bit planes of ``enc = delta +
g``, and both outputs are ``enc_out = 2g - enc_in + P``, a bit-sliced add.

Any global pair scoring affinely equivalent to ``(1, 0, -g)`` for an integer
``1 <= g <= MAX_G`` maps onto this recurrence (:func:`family`).  The score is
recovered from the last column's vertical deltas: ``H(nq, mt) = -g mt +
sum_i v(i, mt)``, a popcount per plane.

The kernel (``ops/cuda/bitpal.cu``) gives each GPU thread one 64-row word of
the query, hands the bottom-row ``h_out`` of a word to the next by warp
shuffle one column later, and between warps by a stream of self-tagged
bytes in global memory.  This module holds everything around it, all of
it runnable on the CPU: the family map, word packing, padding, orientation,
the score reduction, and two plain references -- :func:`score_bigint` (the
whole column in one Python integer) and :func:`planes_reference` (the
kernel's own word step, word by word).

Exactness: every value is an integer (uint64 planes, int32 scores); no
floating-point operation or matrix product is involved, so TF32 and
summation order do not arise, and every comparison with a reference is
exact.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ScoringConfig

WORD = 64  # DP rows per machine word
CODES = 16  # 4-bit symbol codes (the .bdna alphabet)
WARP_WORDS = 32  # words per warp: one per lane
MAX_G = 7  # largest reduced gap weight the kernel is compiled for
#: scratch ceiling: one hand-off byte per text column for every warp
MAX_SCRATCH = 1 << 31
FFI_TARGET = "tpualign_bitpal_score"
_MASK64 = (1 << WORD) - 1


def family(cfg: ScoringConfig):
    """``(mult, g)`` if ``cfg`` is global scoring affinely equivalent to
    ``(1, 0, -g)`` for an integer ``1 <= g <= MAX_G``, else None.

    For any alignment of sequences with lengths m, n: matches a, mismatches
    b, gaps G satisfy ``2(a + b) + G# = m + n`` (G# = gap count), so

        S = M a + X b + G G# = X (m+n)/2 + (M-X) a + (G - X/2) G#.

    When ``G - X/2 == -g (M-X)`` (and ``M > X`` so the map is
    order-preserving) this is an exact affine function of the reduced score
    ``S_g = a - g G#`` -- the score under ``(1, 0, -g)``:
    ``S = (X (m+n) + 2 (M-X) S_g) / 2`` (always integral).  Examples:
    g=1 covers ``(k,0,-k)``, ``(1,-2,-4)``, ``(5,2,-2)``; g=2 covers
    ``(1,0,-2)``, ``(2,0,-4)``, ``(3,2,-1)``.
    """
    if cfg.is_local or cfg.is_affine or cfg.is_ends_free or cfg.has_matrix:
        return None
    mult = cfg.match - cfg.mismatch
    if mult <= 0:
        return None
    num = cfg.mismatch - 2 * cfg.gap  # = 2 g (M-X) when a member
    if num <= 0 or num % (2 * mult):
        return None
    g = num // (2 * mult)
    return (mult, g) if 1 <= g <= MAX_G else None


def supported_scale(cfg: ScoringConfig) -> Optional[int]:
    """The affine multiplier when :func:`family` matches, else None."""
    fam = family(cfg)
    return fam[0] if fam else None


def _from_unit(cfg: ScoringConfig, total_len, unit_score):
    """Map the reduced-scheme score back to ``cfg``'s scale (see
    :func:`family`); exact integer arithmetic."""
    mult = cfg.match - cfg.mismatch
    return (cfg.mismatch * total_len + 2 * mult * unit_score) // 2


# ---------------------------------------------------------------------------
# plain references
# ---------------------------------------------------------------------------


def score_bigint(s1, s2) -> int:
    """Bit-parallel NW score with unit scheme via arbitrary-precision ints.

    One bigint per indicator plane holds the whole column; Python's bigint add
    propagates the promotion carry across all rows at once.  This is the
    executable specification the kernel is tested against (itself validated
    against the scalar DP oracle, ``ops/oracle.py``).
    """
    s1 = np.asarray(s1)
    s2 = np.asarray(s2)
    m, n = int(s1.size), int(s2.size)
    if m == 0 or n == 0:
        return -(m + n)
    mask = (1 << n) - 1
    eq: dict = {}
    for i, c in enumerate(np.asarray(s2, np.int64)):
        eq[int(c)] = eq.get(int(c), 0) | 1 << i
    vm1, v0, v1, v2 = mask, 0, 0, 0
    for c in np.asarray(s1, np.int64):
        E = eq.get(int(c), 0)
        S = E | v2
        received = (((S & vm1) + vm1) ^ vm1) & mask  # h_top=-1 -> no carry-in
        P = S | received
        nP = mask ^ P
        h2 = P & vm1
        h1 = (P & v0) | (nP & vm1)
        h0 = (P & v1) | (nP & v0)
        hm1 = (P & v2) | (nP & v1)
        h2i = (h2 << 1) & mask
        h1i = (h1 << 1) & mask
        h0i = (h0 << 1) & mask
        hm1i = ((hm1 << 1) | 1) & mask  # top boundary: Dh(0,j) = gap
        v2 = P & hm1i
        v1 = (P & h0i) | (nP & hm1i)
        v0 = (P & h1i) | (nP & h0i)
        vm1 = (P & h2i) | (nP & h1i)
    return -m + bin(v1).count("1") + 2 * bin(v2).count("1") - bin(vm1).count("1")


def plane_bits(g: int) -> int:
    """Bit planes per delta: ``enc = delta + g`` spans ``[0, 2g+1]``."""
    return (2 * g + 1).bit_length()


def _neg_add(planes, carry: int, vmax: int):
    """``2g - enc + carry`` on bit planes, as ``~enc + vmax + carry``."""
    out = []
    for b, a in enumerate(planes):
        x = ~a & _MASK64
        if (vmax >> b) & 1:
            out.append(~(x ^ carry) & _MASK64)
            carry = x | carry
        else:
            out.append(x ^ carry)
            carry = x & carry
    return out


def word_step(V, E: int, hin: int, g: int):
    """One word, one text column: the kernel's per-thread step.

    ``V`` holds the word's vertical-delta planes, ``E`` its match word for
    the column's character and ``hin`` the ``h_out`` encoding handed down
    from the bottom row of the word above.  Returns the new planes and this
    word's own bottom-row ``h_out`` encoding."""
    vmax = 2 * g + 1
    is0 = _MASK64
    ismax = _MASK64
    for b, v in enumerate(V):
        is0 &= ~v
        ismax &= v if (vmax >> b) & 1 else ~v
    is0 &= _MASK64
    ismax &= _MASK64
    summ = (is0 + (E & is0) + int(hin == vmax)) & _MASK64
    P = E | ismax | (summ ^ is0)
    U = _neg_add(V, P, vmax)
    hb = sum(((u >> (WORD - 1)) & 1) << b for b, u in enumerate(U))
    Ui = [((u << 1) & _MASK64) | ((hin >> b) & 1) for b, u in enumerate(U)]
    return _neg_add(Ui, P, vmax), hb


def planes_reference(text, eq, g: int) -> np.ndarray:
    """What the kernel returns for ``(text, eq)``, computed word by word.

    ``text`` is the ``(mt,)`` code array and ``eq`` the ``(nw, 16, 2)``
    uint32 match words of :func:`eq_words`; the result is the ``(nw, B, 2)``
    uint32 final-column planes."""
    text = np.asarray(text, np.int64)
    eq = np.asarray(eq, np.uint64)
    nw = eq.shape[0]
    B = plane_bits(g)
    eqw = [[int(eq[w, c, 0]) | int(eq[w, c, 1]) << 32 for c in range(CODES)]
           for w in range(nw)]
    V = [[0] * B for _ in range(nw)]  # column 0: v = -g, enc 0
    for ch in text:
        hin = 0  # row 0 boundary: h = -g, enc 0
        for w in range(nw):
            V[w], hin = word_step(V[w], eqw[w][int(ch) & (CODES - 1)], hin, g)
    out = np.zeros((nw, B, 2), np.uint32)
    for w in range(nw):
        for b in range(B):
            out[w, b, 0] = V[w][b] & 0xFFFFFFFF
            out[w, b, 1] = V[w][b] >> 32
    return out


# ---------------------------------------------------------------------------
# host side of the kernel: layout, packing, reduction
# ---------------------------------------------------------------------------


def orientation(m: int, n: int) -> bool:
    """True when ``s1`` becomes the query (bit axis).  The longer sequence
    does: the kernel's sequential steps are the text columns plus a ramp
    per warp, so the shorter text is the shorter critical path.  Family
    scores are global pair scores and hence symmetric under the swap."""
    return m >= n


def words(nq: int) -> int:
    return -(-nq // WORD)


def scratch_bytes(nw: int, mt: int) -> int:
    """Mirror of the kernel's scratch layout: a 256-byte header (the warp
    ticket counter), then one ``mt``-byte hand-off stream per warp."""
    return 256 + -(-nw // WARP_WORDS) * mt


def fits(cfg: ScoringConfig, m: int, n: int) -> bool:
    """Envelope of the kernel: family scoring, non-empty sequences, int32
    headroom for the mapped score, and scratch below :data:`MAX_SCRATCH`."""
    fam = family(cfg)
    if fam is None or m < 1 or n < 1:
        return False
    mult, g = fam
    if (abs(cfg.mismatch) + 2 * mult * g) * (m + n) >= 2**31:
        return False
    nq, mt = (m, n) if orientation(m, n) else (n, m)
    return mt <= 1 << 30 and scratch_bytes(words(nq), mt) <= MAX_SCRATCH


def eq_words(query: jax.Array, nw: int) -> jax.Array:
    """``(nw, 16, 2)`` uint32: bit ``k`` of half ``h`` of entry ``(w, c)``
    is set iff ``query[64 w + 32 h + k] == c``.  Rows past the query match
    nothing.  Read as little-endian uint64 words by the kernel."""
    nq = query.shape[0]
    q = jnp.full((nw * WORD,), -1, jnp.int32).at[:nq].set(
        query.astype(jnp.int32))
    rows = q.reshape(nw, 1, 2, 32)
    codes = jnp.arange(CODES, dtype=jnp.int32).reshape(1, CODES, 1, 1)
    weights = jnp.left_shift(jnp.uint32(1), jnp.arange(32, dtype=jnp.uint32))
    return jnp.sum(jnp.where(rows == codes, weights, jnp.uint32(0)),
                   axis=-1, dtype=jnp.uint32)


def valid_mask(nq: int, nw: int) -> np.ndarray:
    """``(nw, 2)`` uint32 mask of the real query rows in each word."""
    bits = np.zeros(nw * WORD, bool)
    bits[:nq] = True
    halves = bits.reshape(nw, 2, 32)
    weights = np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64))
    return (halves * weights).sum(axis=-1).astype(np.uint32)


def reduce_planes(planes: jax.Array, valid, nq: int, mt: int,
                  cfg: ScoringConfig) -> jax.Array:
    """Score from the final-column planes: ``H(nq, mt) = sum_rows enc -
    g (mt + nq)`` in the reduced scheme, mapped back to ``cfg``."""
    g = family(cfg)[1]
    counts = jax.lax.population_count(planes & valid[:, None, :])
    per_plane = jnp.sum(counts.astype(jnp.int32), axis=(0, 2))
    weights = jnp.left_shift(1, jnp.arange(planes.shape[1], dtype=jnp.int32))
    unit = jnp.sum(per_plane * weights) - g * (mt + nq)
    return _from_unit(cfg, mt + nq, unit)


def planes_call(text: jax.Array, eq: jax.Array, g: int) -> jax.Array:
    """The kernel as a JAX operation: ``(mt,)`` uint8 text and ``(nw, 16, 2)``
    match words in, ``(nw, B, 2)`` final-column planes out.  The scratch
    result carries the inter-warp hand-off streams and is dropped."""
    nw, mt = eq.shape[0], text.shape[0]
    out = (jax.ShapeDtypeStruct((nw, plane_bits(g), 2), jnp.uint32),
           jax.ShapeDtypeStruct((scratch_bytes(nw, mt),), jnp.uint8))
    planes, _ = jax.ffi.ffi_call(FFI_TARGET, out)(text, eq, g=np.int64(g))
    return planes


@functools.lru_cache(maxsize=64)
def score_fn(m: int, n: int, cfg: ScoringConfig = ScoringConfig()):
    """Jitted ``(s1, s2) -> score`` for ``m = len(s1)``, ``n = len(s2)``.
    Needs the CUDA library, which it builds and registers on first use."""
    if not fits(cfg, m, n):
        raise ValueError(
            "bitpal kernel needs global scoring affinely reducible to "
            f"(1, 0, -g), 1 <= g <= {MAX_G}, within its size envelope")
    from ..utils import cuda_lib

    cuda_lib.register()
    s1_is_query = orientation(m, n)
    nq, mt = (m, n) if s1_is_query else (n, m)
    nw = words(nq)
    g = family(cfg)[1]
    valid = valid_mask(nq, nw)

    def fn(s1: jax.Array, s2: jax.Array) -> jax.Array:
        query, text = (s1, s2) if s1_is_query else (s2, s1)
        planes = planes_call(text.astype(jnp.uint8), eq_words(query, nw), g)
        return reduce_planes(planes, jnp.asarray(valid), nq, mt, cfg)

    return jax.jit(fn)


def score(s1, s2, cfg: ScoringConfig = ScoringConfig()) -> int:
    """Global score through the kernel (see :func:`fits` for its envelope)."""
    m, n = int(np.size(s1)), int(np.size(s2))
    if family(cfg) is not None and (m == 0 or n == 0):
        return cfg.gap * (m + n)
    fn = score_fn(m, n, cfg)
    return int(fn(jnp.asarray(s1, jnp.int32), jnp.asarray(s2, jnp.int32)))
