"""The plain reference against a cell-by-cell Python Gotoh, and its control
(the same wavefront in a narrower integer type) failing where that type
cannot hold the scores."""

import numpy as np
import pytest

from benchmark import reference

CONFIGS = {
    "ref64gb-nw": {"match": 1, "mismatch": 0, "gap": -1, "mode": "global"},
    "stretcher-64gb": {"match": 5, "mismatch": -4, "gap_open": -12,
                       "gap_extend": -4, "mode": "global"},
    "bwamem-sr150": {"match": 1, "mismatch": -4, "gap_open": -6,
                     "gap_extend": -1, "mode": "local"},
}


def gotoh(a, b, sc):
    """H, E, F cell by cell, in Python integers."""
    o, x = reference.gap_scores(sc)
    local = sc["mode"] == "local"
    m, n = len(a), len(b)
    neg = -(10**9)
    H = [[0] * (n + 1) for _ in range(m + 1)]
    E = [[neg] * (n + 1) for _ in range(m + 1)]
    F = [[neg] * (n + 1) for _ in range(m + 1)]
    for i in range(1, m + 1):
        H[i][0] = 0 if local else o + i * x
    for j in range(1, n + 1):
        H[0][j] = 0 if local else o + j * x
    best = 0
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            E[i][j] = max(H[i][j - 1] + o + x, E[i][j - 1] + x)
            F[i][j] = max(H[i - 1][j] + o + x, F[i - 1][j] + x)
            s = sc["match"] if a[i - 1] == b[j - 1] else sc["mismatch"]
            h = max(H[i - 1][j - 1] + s, E[i][j], F[i][j])
            H[i][j] = max(h, 0) if local else h
            best = max(best, H[i][j])
    return best if local else H[m][n]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("m,n", [(1, 1), (1, 9), (8, 3), (33, 40), (57, 22)])
def test_reference_equals_cell_by_cell_dp(name, m, n):
    rng = np.random.default_rng(m * 100 + n)
    a = rng.integers(1, 5, (4, m))
    b = rng.integers(1, 5, (4, n))
    b[1, : min(m, n)] = a[1, : min(m, n)]  # one near-identical pair
    got = reference.scores(a, b, CONFIGS[name])
    assert list(got) == [gotoh(a[k], b[k], CONFIGS[name]) for k in range(4)]


def test_reference_rejects_bad_shapes():
    with pytest.raises(ValueError):
        reference.scores(np.ones((2, 3)), np.ones((3, 3)), CONFIGS["ref64gb-nw"])
    with pytest.raises(ValueError):
        reference.scores(np.ones((1, 3)), np.ones((1, 3)),
                         {**CONFIGS["ref64gb-nw"], "mode": "sg"})


@pytest.mark.parametrize("name,size", [("ref64gb-nw", 34000),
                                       ("stretcher-64gb", 9000)])
def test_int16_control_fails_past_its_range(name, size):
    # a near-identical pair of this size scores past int16's range
    rng = np.random.default_rng(1)
    a = rng.integers(1, 5, (1, size))
    b = rng.integers(1, 5, (1, size + 7))
    b[0, :size] = np.where(rng.random(size) < 0.02, b[0, :size], a[0])
    want = reference.scores(a, b, CONFIGS[name])
    assert abs(want[0]) > 2**15
    assert reference.scores(a, b, CONFIGS[name], "int16")[0] != want[0]


def test_int8_control_fails_on_short_reads():
    from benchmark.generators import short_reads
    from benchmark.tests.test_generators import READS

    (w, r), = short_reads.make(READS, 11, 1, 256)
    want = reference.scores(w, r, CONFIGS["bwamem-sr150"])
    low = reference.scores(w, r, CONFIGS["bwamem-sr150"], "int8")
    assert want.max() > 127 and np.sum(low != want) > 0
    # int16 holds these scores: it is no lower precision at this size
    assert np.array_equal(
        reference.scores(w, r, CONFIGS["bwamem-sr150"], "int16"), want)
