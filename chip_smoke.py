"""End-to-end check of tpu-align on one NVIDIA GPU (Hopper).

Runs the main path through the entry points a user calls, at real sizes,
and checks every result exactly against an independent reference:

1. device: the card's name and power limit, JAX's device kind, compute
   capability and version; no GPU is a failure (there is no CPU fallback);
2. build: the CUDA library (``nvcc``) and the native C++ helper;
3. headline: the 64gb pair (126,440 x 127,240) through ``align_score``, on
   the engine ``resolve_impl`` picks (the bit-parallel CUDA kernel), equal
   to the XLA row scan run on the card (and to the reference binary's
   73888 where the corpus is mounted), with warm wall time and GCUPS of
   both;
4. the other scoring configs on a ~10k x 10k pair through ``align_score``,
   against the native C++ scorer;
5. ``align`` above the full-table limit (checkpointed and Myers-Miller
   device paths), for default and affine scoring;
6. ``align_score_batch`` on 1,000 short-read pairs, against the oracle;
7. the ``gpu``-marked tests (``tests_gpu/``), in this same process.

With ``--four-cards`` it runs only the sharded strip fill over a 1-D mesh of
four GPUs at the 64gb pair, against one card's score of the same pair.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
any failure exits non-zero before it is printed.  Usage::

    python chip_smoke.py                # one GPU, phases 1-7
    python chip_smoke.py --four-cards   # four GPUs, the sharded phase only
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

CORPUS = "/root/reference/bdna"
PAIR_64GB = (126440, 127240)
GOLDEN_64GB = 73888


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def load_64gb():
    """The 64gb corpus pair if mounted (with its golden score), else a
    seeded random pair of the same lengths (and no golden)."""
    from tpualign.io.bdna import random_pair, read_bdna

    p1 = os.path.join(CORPUS, "64gb-1.bdna")
    p2 = os.path.join(CORPUS, "64gb-2.bdna")
    if os.path.exists(p1) and os.path.exists(p2):
        return read_bdna(p1), read_bdna(p2), GOLDEN_64GB
    s1, s2 = random_pair(*PAIR_64GB, seed=64)
    return s1, s2, None


def timed(fn, *args):
    """(result, seconds) of one call that ends in a host read."""
    t0 = time.perf_counter()
    out = fn(*args)
    out = out.block_until_ready() if hasattr(out, "block_until_ready") else out
    return out, time.perf_counter() - t0


def phase_device() -> dict:
    import jax

    from tpualign.utils import device

    d = device.require_gpu()
    say(device.card())
    say(f"jax {jax.__version__}, device_kind {d.device_kind}, compute "
        f"capability {getattr(d, 'compute_capability', None)}, "
        f"{len(jax.devices())} device(s)")
    return device.describe()


def phase_build() -> None:
    from tpualign.utils import cuda_lib, native

    t0 = time.perf_counter()
    path = cuda_lib.build()
    say(f"build: CUDA library {path} ({cuda_lib.last_build_seconds:.3f} s "
        f"compiling, {time.perf_counter() - t0:.3f} s in all; set-up)")
    t0 = time.perf_counter()
    check(native.available(), "native C++ helper failed to build or load")
    say(f"build: native helper {native.LIB} "
        f"({time.perf_counter() - t0:.3f} s; set-up)")


def phase_headline() -> None:
    import jax
    import jax.numpy as jnp

    from tpualign import align_score
    from tpualign.api import resolve_impl
    from tpualign.config import EngineConfig, ScoringConfig
    from tpualign.ops import bitpal, xla

    s1, s2, golden = load_64gb()
    cfg = ScoringConfig()
    m, n = len(s1), len(s2)
    cells = m * n
    impl = resolve_impl(EngineConfig(), cfg, (m, n))
    check(impl == "bitpal", f"resolve_impl chose {impl!r}, not 'bitpal'")
    got, cold = timed(align_score, s1, s2, cfg)
    say(f"headline: align_score on {m} x {n} ({cells:.4g} cells), engine "
        f"{impl}: score {got} (first call {cold:.3f} s, incl. compile)")
    d1, d2 = jnp.asarray(s1, jnp.int32), jnp.asarray(s2, jnp.int32)
    kfn = bitpal.score_fn(m, n, cfg)
    kfn(d1, d2).block_until_ready()
    walls = [timed(kfn, d1, d2)[1] for _ in range(3)]
    k_best = min(walls)
    say(f"headline: bitpal kernel warm wall {k_best:.6f} s (runs "
        f"{', '.join(f'{w:.6f}' for w in walls)}), "
        f"{cells / k_best / 1e9:.3f} GCUPS")
    xfn = jax.jit(xla.score_fn(cfg))
    want, x_cold = timed(xfn, d1, d2)
    want = int(want)
    _, x_warm = timed(xfn, d1, d2)
    say(f"headline: XLA row scan on the card: score {want}, warm wall "
        f"{x_warm:.6f} s ({cells / x_warm / 1e9:.3f} GCUPS; first call "
        f"{x_cold:.3f} s); kernel speed-up {x_warm / k_best:.1f}x")
    check(got == want, f"kernel score {got} != XLA scan score {want}")
    if golden is not None:
        check(got == golden, f"64gb score {got} != golden {golden}")
        say(f"headline: equals the reference binary's golden {golden}")


def _configs():
    from tpualign.config import AlignMode, ScoringConfig
    from tpualign.matrices import dna

    return {
        "sw 2/-1/-2": ScoringConfig(match=2, mismatch=-1, gap=-2,
                                    mode=AlignMode.LOCAL),
        "general 2/-3/-4": ScoringConfig(match=2, mismatch=-3, gap=-4),
        "affine -5/-2 global": ScoringConfig(match=2, mismatch=-3,
                                             gap_open=-5, gap_extend=-2),
        "affine -5/-2 local": ScoringConfig(match=2, mismatch=-3,
                                            gap_open=-5, gap_extend=-2,
                                            mode=AlignMode.LOCAL),
        "matrix dna:2,-1,-3": ScoringConfig(gap=-2, matrix=dna(2, -1, -3)),
        "semiglobal 2/-1/-2": ScoringConfig(match=2, mismatch=-1, gap=-2,
                                            mode=AlignMode.SEMIGLOBAL),
        "infix 2/-1/-2": ScoringConfig(match=2, mismatch=-1, gap=-2,
                                       mode=AlignMode.INFIX),
    }


def phase_configs(m: int = 10000, n: int = 10000) -> None:
    from tpualign import align_score
    from tpualign.api import resolve_impl
    from tpualign.config import EngineConfig
    from tpualign.io.bdna import random_pair
    from tpualign.utils import native

    s1, s2 = random_pair(m, n, seed=10)
    for name, cfg in _configs().items():
        impl = resolve_impl(EngineConfig(), cfg, (m, n))
        got, first = timed(align_score, s1, s2, cfg)
        _, warm = timed(align_score, s1, s2, cfg)
        want = native.score(s1, s2, cfg)
        say(f"configs: {name:22s} {m} x {n}: engine {impl}, score {got}, "
            f"native {want}, warm wall {warm:.6f} s "
            f"({m * n / warm / 1e9:.3f} GCUPS; first call {first:.3f} s)")
        check(got == want, f"{name}: score {got} != native {want}")


def _check_alignment(s1, s2, cfg, score, a1, a2, label) -> None:
    from tpualign.io.bdna import decode
    from tpualign.ops import oracle

    check(len(a1) == len(a2), f"{label}: aligned strings differ in length")
    if not cfg.is_local:
        check(a1.replace("-", "") == decode(s1), f"{label}: s1 not covered")
        check(a2.replace("-", "") == decode(s2), f"{label}: s2 not covered")
    check(not any(x == y == "-" for x, y in zip(a1, a2)),
          f"{label}: gap aligned to gap")
    check(oracle.alignment_score(a1, a2, cfg) == score,
          f"{label}: recomputed alignment score differs from {score}")


def phase_alignment(m: int = 10030, n: int = 9976) -> None:
    from tpualign import align, align_score
    from tpualign.api import FULL_TABLE_CELL_LIMIT
    from tpualign.config import ScoringConfig
    from tpualign.io.bdna import random_pair

    s1, s2 = random_pair(m, n, seed=5839)
    big = (m + 1) * (n + 1) > FULL_TABLE_CELL_LIMIT
    for name, cfg in (
        ("default", ScoringConfig()),
        ("affine -5/-2", ScoringConfig(match=2, mismatch=-3, gap_open=-5,
                                       gap_extend=-2)),
    ):
        (sc, a1, a2), wall = timed(align, s1, s2, cfg)
        want = align_score(s1, s2, cfg)
        check(sc == want, f"align {name}: score {sc} != align_score {want}")
        _check_alignment(s1, s2, cfg, sc, a1, a2, f"align {name}")
        say(f"alignment: {name} {m} x {n} "
            f"({'linear-space device path' if big else 'full table'}): "
            f"score {sc}, {len(a1)} columns, valid, wall {wall:.3f} s")


def short_read_batch(n_pairs: int, seed: int = 150):
    """``n_pairs`` reads of 150 bases, each cut from a 160-base window of a
    seeded random genome, with ~2% substitutions and one small indel."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(1, 5, 200000).astype(np.int8)
    texts, queries = [], []
    for _ in range(n_pairs):
        pos = int(rng.integers(0, genome.size - 160))
        window = genome[pos:pos + 160].copy()
        read = window[5:].copy()
        subs = rng.random(read.size) < 0.02
        read[subs] = rng.integers(1, 5, int(subs.sum()))
        cut = int(rng.integers(10, 140))
        if rng.random() < 0.5:
            read = np.delete(read, slice(cut, cut + int(rng.integers(1, 4))))
        else:
            ins = rng.integers(1, 5, int(rng.integers(1, 4))).astype(np.int8)
            read = np.insert(read, cut, ins)
        texts.append(window)
        queries.append(read[:150])
    return texts, queries


def phase_batch(n_pairs: int = 1000) -> None:
    from tpualign import align_score_batch
    from tpualign.config import AlignMode, ScoringConfig
    from tpualign.ops import oracle

    texts, queries = short_read_batch(n_pairs)
    for name, cfg in (
        ("default", ScoringConfig()),
        ("sw 2/-1/-2", ScoringConfig(match=2, mismatch=-1, gap=-2,
                                     mode=AlignMode.LOCAL)),
    ):
        got, first = timed(align_score_batch, texts, queries, cfg)
        _, warm = timed(align_score_batch, texts, queries, cfg)
        want = np.asarray([oracle.score(t, q, cfg)
                           for t, q in zip(texts, queries)])
        bad = int(np.sum(np.asarray(got) != want))
        say(f"batch: {name}: {n_pairs} pairs of 150 x 160, {bad} differ "
            f"from the oracle; warm wall {warm:.6f} s "
            f"({n_pairs / warm:.1f} pairs/s; first call {first:.3f} s)")
        check(bad == 0, f"batch {name}: {bad} scores differ from the oracle")


def phase_gpu_tests() -> None:
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests_gpu")])
    check(rc == 0, f"tests_gpu failed (pytest exit code {int(rc)})")
    say("gpu tests: passed")


def phase_four_cards() -> dict:
    import jax
    import jax.numpy as jnp

    from tpualign.config import ScoringConfig
    from tpualign.ops import bitpal, xla
    from tpualign.parallel import strips
    from tpualign.parallel.mesh import AXIS, make_mesh
    from tpualign.utils import device

    device.require_gpu()
    say(device.card())
    check(len(jax.devices()) >= 4,
          f"--four-cards needs 4 GPUs, found {len(jax.devices())}")
    s1, s2, golden = load_64gb()
    cfg = ScoringConfig()
    m, n = len(s1), len(s2)
    cells = m * n
    d1, d2 = jnp.asarray(s1, jnp.int32), jnp.asarray(s2, jnp.int32)

    kfn = bitpal.score_fn(m, n, cfg)
    one = int(kfn(d1, d2))
    _, k_wall = timed(kfn, d1, d2)
    xfn = jax.jit(xla.score_fn(cfg))
    x_one = int(xfn(d1, d2))
    _, x_wall = timed(xfn, d1, d2)
    say(f"one card: bitpal score {one}, warm wall {k_wall:.6f} s "
        f"({cells / k_wall / 1e9:.3f} GCUPS); XLA row scan score {x_one}, "
        f"warm wall {x_wall:.6f} s ({cells / x_wall / 1e9:.3f} GCUPS)")
    check(one == x_one, f"one card: bitpal {one} != XLA {x_one}")

    mesh = make_mesh(4)
    fn, (m_pad, n_pad) = strips.score_fn(m, n, cfg, mesh=mesh)
    p1 = np.zeros(m_pad, np.int32)
    p1[:m] = s1
    p2 = np.zeros(n_pad, np.int32)
    p2[:n] = s2
    spec = jax.sharding.PartitionSpec
    a1 = jax.device_put(jnp.asarray(p1),
                        jax.sharding.NamedSharding(mesh, spec(AXIS)))
    a2 = jax.device_put(jnp.asarray(p2),
                        jax.sharding.NamedSharding(mesh, spec()))
    shard_devices = {s.device for s in a1.addressable_shards}
    check(len(shard_devices) == 4,
          f"s1 shards on {len(shard_devices)} device(s), not 4")
    say(f"four cards: s1 strips on devices "
        f"{sorted(d.id for d in shard_devices)}")
    sfn = jax.jit(fn)
    out, first = timed(sfn, a1, a2)
    four = int(np.asarray(out)[0])
    _, s_wall = timed(sfn, a1, a2)
    say(f"four cards: strips score {four}, warm wall {s_wall:.6f} s "
        f"({cells / s_wall / 1e9:.3f} GCUPS; first call {first:.3f} s); "
        f"vs one card: bitpal {k_wall:.6f} s, XLA {x_wall:.6f} s")
    check(four == one, f"strips on 4 cards {four} != one card {one}")
    if golden is not None:
        check(four == golden, f"64gb score {four} != golden {golden}")
    return device.describe()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded strip fill on 4 GPUs")
    args = ap.parse_args(argv)
    from tpualign.utils import compile_cache, device

    compile_cache.setup()
    try:
        if args.four_cards:
            desc = phase_four_cards()
        else:
            desc = phase_device()
            phase_build()
            phase_headline()
            phase_configs()
            phase_alignment()
            phase_batch()
            phase_gpu_tests()
    except device.NoAcceleratorError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say(json.dumps({"ok": True, "device": desc}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
