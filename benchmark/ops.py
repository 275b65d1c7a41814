"""Operations and bytes a kernel's algorithm needs, counted from the
algorithm and not from any implementation of it, so the count reads the
same work whatever computes it.

Bit-parallel global score (Myers 1999; Loving, Hernandez & Benson 2014), for
the scoring family ``(1, 0, -g)``: the deltas of a 64-row word are kept as
``B = bit_length(2g + 1)`` bit planes of ``enc = delta + g``, and one word
step (one word, one text column) is, on 64-bit words:

    Z     = no plane set                 B - 1 OR (its NOT folds away)
    V     = planes equal to 2g + 1       B - 1 AND (NOTs fold away)
    summ  = Z + (E & Z) + c_in           1 AND, 2 ADD
    P     = E | V | (summ ^ Z)           1 XOR, 2 OR
    h_out = 2g - v_enc + P               per plane 1 XOR and a carry
                                         (1 AND or OR), no carry out of
                                         the last plane: 2B - 1
    h_in  = h_out shifted down a row,    per plane 1 SHL, 1 OR: 2B
            the word above's bit in
    v_out = 2g - h_in + P                2B - 1

which is ``8B + 2`` operations of two inputs.  NOTs are not counted: a GPU's
three-input logic instruction absorbs them.  One 64-bit operation costs at
least one 32-bit instruction even when two of them share a three-input
instruction, so the count over the peak 32-bit issue rate is a lower bound
on the time, and a kernel's share of it cannot pass 100% while the
algorithm stays this one.
"""

from __future__ import annotations

WORD = 64


def plane_bits(g: int) -> int:
    return (2 * g + 1).bit_length()


def bitpal_word_ops(g: int) -> int:
    """64-bit operations of one word step for gap weight ``g``."""
    b = plane_bits(g)
    z_and_v = 2 * (b - 1)
    summ_and_p = 3 + 3
    neg_adds = 2 * (2 * b - 1)
    shift = 2 * b
    return z_and_v + summ_and_p + neg_adds + shift


def bitpal_word_steps(m: int, n: int) -> int:
    """Word steps of a score over lengths ``m``, ``n``: one per 64-row word
    of the bit axis and text column, taking the orientation with fewer."""
    return min(-(-m // WORD) * n, -(-n // WORD) * m)


def bitpal_family_g(scoring: dict) -> int:
    """``g`` of the ``(1, 0, -g)`` family that a linear global scoring
    ``(M, X, G)`` maps onto: ``X - 2G = 2 g (M - X)``."""
    if "gap" not in scoring or scoring.get("mode", "global") != "global":
        raise ValueError("the bit-parallel family is linear global scoring")
    mult = int(scoring["match"]) - int(scoring["mismatch"])
    num = int(scoring["mismatch"]) - 2 * int(scoring["gap"])
    if mult <= 0 or num <= 0 or num % (2 * mult):
        raise ValueError(f"scoring {scoring} is not in the (1, 0, -g) family")
    return num // (2 * mult)


def bitpal_roofline_s(scoring: dict, m: int, n: int, peak: dict):
    """``(seconds, bound)``: the least time one score can take on a device
    of ``peak``, and which of its rates bounds it.  The bytes are the two
    sequences read once, one byte a base."""
    ops = bitpal_word_ops(bitpal_family_g(scoring)) * bitpal_word_steps(m, n)
    t_ops = ops / peak["int32_ops_per_s"]
    t_bytes = (m + n) / peak["hbm_bytes_per_s"]
    return (t_ops, "int32 issue") if t_ops >= t_bytes else (t_bytes, "hbm")
