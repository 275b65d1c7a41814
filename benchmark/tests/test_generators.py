"""The copied input generators: the same seed gives the same inputs."""

import numpy as np

from benchmark.generators import random_pair, short_reads

READS = {"read_length": 150, "window": 160, "offset": 5,
         "substitution_rate": 0.02, "indel_max": 3, "cut_range": [10, 140],
         "genome_length": 200000}


def same(x, y):
    return all(np.array_equal(a, c) and np.array_equal(b, d)
               for (a, b), (c, d) in zip(x, y))


def test_random_pair_is_the_programs_generator():
    from tpualign.io.bdna import random_pair as program_pair

    big = 2**31 + 12345  # seeds above 32 signed bits are valid
    ((a, b),) = random_pair.make({"lengths": [300, 280]}, big, 1, 1)
    s1, s2 = program_pair(300, 280, seed=big)
    assert np.array_equal(a[0], s1) and np.array_equal(b[0], s2)
    assert a.dtype == np.int8 and set(np.unique(a)) <= {1, 2, 3, 4}


def test_random_pair_seeded():
    p = {"lengths": [50, 60]}
    assert same(random_pair.make(p, 3, 2, 2), random_pair.make(p, 3, 2, 2))
    assert not same(random_pair.make(p, 3, 1, 1), random_pair.make(p, 4, 1, 1))


def test_short_reads_seeded_and_shaped():
    x = short_reads.make(READS, 2**32 + 7, 3, 500)
    assert same(x, short_reads.make(READS, 2**32 + 7, 3, 500))
    assert not same(x, short_reads.make(READS, 8, 3, 500))
    for windows, reads in x:
        assert windows.shape == (500, 160) and reads.shape == (500, 150)
        assert windows.dtype == reads.dtype == np.int8
        assert set(np.unique(reads)) <= {1, 2, 3, 4}


def test_short_reads_follow_their_window():
    # before the indel a read is its window past the offset, up to the ~2%
    # substitutions (three quarters of which change the base)
    (windows, reads), = short_reads.make(READS, 5, 1, 2000)
    head = reads[:, :10] != windows[:, 5:15]
    assert 0.005 < head.mean() < 0.03
    # after a 1..3-base indel the read is shifted against the window: most
    # of the tail then differs at a fixed offset of 0 and matches at k
    tail = reads[:, 145:] != windows[:, 150:155]
    assert tail.mean() > 0.5
