"""Bit-parallel score: the plain references and the kernel's host side.

``score_bigint`` (the whole column in one Python integer) is checked
against the scalar DP oracle; ``planes_reference`` (the CUDA kernel's own
word step, word by word) stands in for the kernel's output so that the
packing, padding, orientation and score reduction around it are checked
here on the CPU.  The compiled kernel runs in ``tests_gpu/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpualign.config import AlignMode, ScoringConfig
from tpualign.io.bdna import random_pair
from tpualign.ops import bitpal, oracle

from conftest import reference_pair

UNIT = ScoringConfig()  # (1, 0, -1): the reference scheme


def host_score(s1, s2, cfg):
    """The kernel wrapper's pipeline with the reference planes in place of
    the FFI call: orientation, packing, planes, masked reduction."""
    m, n = len(s1), len(s2)
    q, t = (s1, s2) if bitpal.orientation(m, n) else (s2, s1)
    nq, mt = len(q), len(t)
    nw = bitpal.words(nq)
    eq = bitpal.eq_words(jnp.asarray(q, jnp.int32), nw)
    planes = bitpal.planes_reference(t, np.asarray(eq), bitpal.family(cfg)[1])
    valid = jnp.asarray(bitpal.valid_mask(nq, nw))
    return int(bitpal.reduce_planes(jnp.asarray(planes), valid, nq, mt, cfg))


def test_supported_scale():
    assert bitpal.supported_scale(UNIT) == 1
    assert bitpal.supported_scale(ScoringConfig(match=3, mismatch=0, gap=-3)) == 3
    assert bitpal.supported_scale(ScoringConfig(match=2, mismatch=1, gap=-2)) is None
    assert bitpal.family(ScoringConfig(gap=-2)) == (1, 2)  # g=2 member
    assert bitpal.supported_scale(ScoringConfig(mode=AlignMode.LOCAL)) is None


@pytest.mark.parametrize("name", ["debug", "small", "t"])
def test_bigint_matches_oracle_corpus(name):
    s1, s2 = reference_pair(name)
    assert bitpal.score_bigint(s1, s2) == oracle.score(s1, s2, UNIT)


def test_bigint_matches_oracle_random(rng):
    for _ in range(120):
        m = int(rng.integers(1, 150))
        n = int(rng.integers(1, 150))
        a = int(rng.integers(1, 5))
        s1 = rng.integers(1, a + 1, m).astype(np.int8)
        s2 = rng.integers(1, a + 1, n).astype(np.int8)
        assert bitpal.score_bigint(s1, s2) == oracle.score(s1, s2, UNIT), (
            m, n, a, s1.tolist(), s2.tolist())


def test_bigint_any_code_matches_oracle(rng):
    # every 4-bit code matches itself, as in the oracle (gap byte included)
    for _ in range(20):
        s1 = rng.integers(0, 16, int(rng.integers(1, 90))).astype(np.int8)
        s2 = rng.integers(0, 16, int(rng.integers(1, 90))).astype(np.int8)
        assert bitpal.score_bigint(s1, s2) == oracle.score(s1, s2, UNIT)


@pytest.mark.parametrize(
    "m,n",
    [(1, 1), (1, 40), (40, 1), (31, 33), (32, 32), (63, 64), (64, 64),
     (65, 64), (64, 65), (129, 70), (70, 129), (200, 93)],
)
def test_kernel_matches_bigint_word_edges(m, n):
    # word edges at 64 rows: the reference planes through the host pipeline
    s1, s2 = random_pair(m, n, seed=m * 1000 + n)
    assert host_score(s1, s2, UNIT) == bitpal.score_bigint(s1, s2)


@pytest.mark.parametrize(
    "match,mismatch,gap",
    [(1, -2, -4), (5, 2, -2), (2, -2, -5), (4, 0, -4), (3, 0, -3)],
)
def test_affine_equivalent_scoring_family(match, mismatch, gap, rng):
    cfg = ScoringConfig(match=match, mismatch=mismatch, gap=gap)
    assert bitpal.supported_scale(cfg) is not None
    for _ in range(3):
        m = int(rng.integers(1, 100))
        n = int(rng.integers(1, 100))
        s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
        got = host_score(s1, s2, cfg)
        assert got == oracle.score(s1, s2, cfg), (match, mismatch, gap, m, n)


def test_affine_family_rejects_nonmember():
    for cfg in (ScoringConfig(match=2, mismatch=0, gap=-1),
                ScoringConfig(match=1, mismatch=1, gap=-1),
                ScoringConfig(match=1, mismatch=-1, gap=-2)):
        assert bitpal.supported_scale(cfg) is None


@pytest.mark.parametrize(
    "match,mismatch,gap",
    [(1, 0, -2), (3, 2, -1), (2, 0, -4), (1, 0, -3), (4, 2, -5),
     (1, 0, -7)],
)
def test_generalized_gap_family(match, mismatch, gap, rng):
    cfg = ScoringConfig(match=match, mismatch=mismatch, gap=gap)
    fam = bitpal.family(cfg)
    assert fam is not None and fam[1] >= 2, fam
    for _ in range(3):
        m = int(rng.integers(1, 140))
        n = int(rng.integers(1, 140))
        s1, s2 = random_pair(m, n, seed=int(rng.integers(1 << 30)))
        got = host_score(s1, s2, cfg)
        assert got == oracle.score(s1, s2, cfg), (match, mismatch, gap, m, n)


@pytest.mark.parametrize("g", range(1, 8))
def test_word_step_matches_bigint_one_word(g, rng):
    # a single word: the word step alone against the whole-column bigint
    cfg = ScoringConfig(gap=-g)
    s1 = rng.integers(1, 5, 64).astype(np.int8)
    s2 = rng.integers(1, 5, 37).astype(np.int8)
    assert host_score(s1, s2, cfg) == oracle.score(s1, s2, cfg)


def test_eq_words_packing(rng):
    q = rng.integers(0, 16, 150).astype(np.int32)
    nw = bitpal.words(q.size)
    eq = np.asarray(bitpal.eq_words(jnp.asarray(q), nw))
    assert eq.shape == (nw, bitpal.CODES, 2) and eq.dtype == np.uint32
    words = eq[..., 0].astype(np.uint64) | eq[..., 1].astype(np.uint64) << 32
    for row in range(nw * bitpal.WORD):
        w, bit = divmod(row, bitpal.WORD)
        hits = [c for c in range(bitpal.CODES)
                if (int(words[w, c]) >> bit) & 1]
        assert hits == ([int(q[row])] if row < q.size else []), row


@pytest.mark.parametrize("nq", [1, 31, 32, 33, 63, 64, 65, 128, 130])
def test_valid_mask_padding(nq):
    nw = bitpal.words(nq)
    mask = bitpal.valid_mask(nq, nw)
    assert mask.shape == (nw, 2) and mask.dtype == np.uint32
    total = sum(bin(int(x)).count("1") for x in mask.ravel())
    assert total == nq
    words = mask[:, 0].astype(np.uint64) | mask[:, 1].astype(np.uint64) << 32
    for w in range(nw - 1):
        assert int(words[w]) == (1 << 64) - 1
    assert int(words[-1]) == (1 << (nq - 64 * (nw - 1))) - 1


def test_reduce_planes_ignores_padding_rows():
    # junk in the padding rows of the last word must not reach the score
    nq, mt = 70, 10
    nw = bitpal.words(nq)
    ones = np.full((nw, 2, 2), 0xFFFFFFFF, np.uint32)  # enc 3 on every row
    valid = jnp.asarray(bitpal.valid_mask(nq, nw))
    got = int(bitpal.reduce_planes(jnp.asarray(ones), valid, nq, mt, UNIT))
    assert got == 3 * nq - (mt + nq)


def test_orientation_longer_sequence_is_query():
    assert bitpal.orientation(100, 50) is True
    assert bitpal.orientation(50, 100) is False
    assert bitpal.orientation(64, 64) is True
    s1, s2 = random_pair(40, 150, seed=3)
    assert host_score(s1, s2, UNIT) == host_score(s2, s1, UNIT) == \
        oracle.score(s1, s2, UNIT)


def test_scratch_layout():
    # a 256-byte header (the warp ticket), then one mt-byte stream per
    # warp of 32 words
    assert bitpal.scratch_bytes(1, 10) == 256 + 10
    assert bitpal.scratch_bytes(32, 10) == 256 + 10
    assert bitpal.scratch_bytes(33, 10) == 256 + 2 * 10
    nw = bitpal.words(126440)
    assert bitpal.scratch_bytes(nw, 127240) == 256 + 62 * 127240


def test_fits_envelope():
    assert bitpal.fits(UNIT, 126440, 127240)
    assert not bitpal.fits(UNIT, 0, 10)
    assert not bitpal.fits(ScoringConfig(mode=AlignMode.LOCAL), 10, 10)
    assert not bitpal.fits(ScoringConfig(match=2, mismatch=1, gap=-2), 10, 10)
    # int32 headroom of the mapped score
    big = ScoringConfig(match=1000, mismatch=0, gap=-1000)
    assert bitpal.fits(big, 1000, 1000)
    assert not bitpal.fits(big, 10**6, 10**6)
    # scratch ceiling: one byte per text column per warp
    assert not bitpal.fits(UNIT, 10**8, 10**8)


def test_planes_call_shapes():
    # the FFI call's abstract signature, without the CUDA library
    text = jax.ShapeDtypeStruct((300,), jnp.uint8)
    for g in (1, 2, 4, 7):
        eq = jax.ShapeDtypeStruct((5, bitpal.CODES, 2), jnp.uint32)
        out = jax.eval_shape(lambda t, e: bitpal.planes_call(t, e, g),
                             text, eq)
        assert out.shape == (5, bitpal.plane_bits(g), 2)
        assert out.dtype == jnp.uint32


def test_score_empty_and_unsupported():
    s2 = np.ones(10, np.int8)
    assert bitpal.score(np.empty(0, np.int8), s2, UNIT) == -10
    assert bitpal.score(s2, np.empty(0, np.int8),
                        ScoringConfig(match=3, mismatch=0, gap=-3)) == -30
    with pytest.raises(ValueError):
        bitpal.score(s2, s2, ScoringConfig(match=2, mismatch=1, gap=-2))
