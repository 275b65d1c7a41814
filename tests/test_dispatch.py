"""Engine choice, compile-cache placement, and the GPU-only entry points.

``resolve_impl``'s capability table is checked over backend x compute
capability x scoring x device count without any GPU; the cache and exit-code
checks start fresh interpreters, since both are per-process settings."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tpualign.api import (CAPABILITY_TABLE, Capabilities, choose_engine,
                          resolve_impl)
from tpualign.config import AlignMode, EngineConfig, ScoringConfig
from tpualign.matrices import dna

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

UNIT = ScoringConfig()
G3 = ScoringConfig(match=1, mismatch=0, gap=-3)
SCALED = ScoringConfig(match=5, mismatch=2, gap=-2)
GENERAL = ScoringConfig(match=2, mismatch=-3, gap=-4)
SW = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.LOCAL)
AFFINE = ScoringConfig(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
MATRIX = ScoringConfig(gap=-2, matrix=dna(2, -1, -3))
SG = ScoringConfig(match=2, mismatch=-1, gap=-2, mode=AlignMode.SEMIGLOBAL)
AFFINE_SG = ScoringConfig(match=2, mismatch=-1, gap_open=-5, gap_extend=-2,
                          mode=AlignMode.SEMIGLOBAL)

HOPPER = ("gpu", "9.0")
AMPERE = ("gpu", "8.0")
CPU = ("cpu", None)
BIG = (126440, 127240)
SMALL = (5000, 4000)


def pick(backend, cfg, shape=BIG, n_dev=1):
    return choose_engine(Capabilities(backend[0], backend[1], n_dev, cfg,
                                      shape))


@pytest.mark.parametrize("cfg", [UNIT, G3, SCALED], ids=["unit", "g3",
                                                         "scaled"])
@pytest.mark.parametrize("shape", [BIG, SMALL, (1, 1), None])
def test_family_on_hopper_takes_kernel(cfg, shape):
    assert pick(HOPPER, cfg, shape) == "bitpal"
    assert pick(HOPPER, cfg, shape, n_dev=4) == "bitpal"


@pytest.mark.parametrize("backend", [CPU, AMPERE], ids=["cpu", "sm80"])
@pytest.mark.parametrize("cfg", [UNIT, G3, GENERAL, SW, AFFINE, MATRIX, SG],
                         ids=["unit", "g3", "general", "sw", "affine",
                              "matrix", "sg"])
def test_other_backends_take_xla(backend, cfg):
    assert pick(backend, cfg) == "xla"


@pytest.mark.parametrize("cfg", [GENERAL, SW, AFFINE, MATRIX, SG, AFFINE_SG],
                         ids=["general", "sw", "affine", "matrix", "sg",
                              "affine-sg"])
def test_non_family_on_hopper_takes_xla(cfg):
    assert pick(HOPPER, cfg) == "xla"


def test_kernel_envelope_is_checked_by_shape():
    # outside the kernel's envelope (empty, or scratch past its ceiling)
    # the table falls through to the row scan instead of raising later
    assert pick(HOPPER, UNIT, (0, 100)) == "xla"
    assert pick(HOPPER, UNIT, (10**8, 10**8)) == "xla"


def test_device_count_and_sharding():
    big = (4096 * 4, 4096 * 4)
    assert pick(HOPPER, AFFINE, big, n_dev=4) == "strips"
    assert pick(CPU, AFFINE, big, n_dev=4) == "strips"
    assert pick(HOPPER, AFFINE, big, n_dev=1) == "xla"
    assert pick(HOPPER, AFFINE, (4096, 4096), n_dev=4) == "xla"
    # matrix / ends-free affine never shard; linear configs stay on one
    # device on every backend
    assert pick(HOPPER, AFFINE_SG, big, n_dev=4) == "xla"
    assert pick(CPU, GENERAL, big, n_dev=4) == "xla"
    assert pick(HOPPER, UNIT, big, n_dev=4) == "bitpal"


def test_table_ends_with_catch_all():
    name, ok = CAPABILITY_TABLE[-1]
    assert name == "xla" and ok(None)


def test_resolve_impl_this_process():
    # the test process is CPU-only with 8 virtual devices (conftest)
    assert resolve_impl(EngineConfig(), UNIT, BIG) == "xla"
    assert resolve_impl(EngineConfig(), AFFINE, (40000, 40000)) == "strips"
    for impl in ("bitpal", "xla", "strips", "oracle"):
        assert resolve_impl(EngineConfig(impl=impl), UNIT, BIG) == impl


def test_engine_config_rejects_removed_engines():
    for impl in ("band", "pallas", "bitpal-strips", "band-chunked"):
        with pytest.raises(ValueError):
            EngineConfig(impl=impl)


def test_device_score_fn_xla():
    import jax.numpy as jnp

    from tpualign.api import device_score_fn
    from tpualign.io.bdna import random_pair
    from tpualign.ops import oracle

    s1, s2 = random_pair(90, 70, seed=2)
    fn = device_score_fn("xla", 90, 70, GENERAL)
    got = int(fn(jnp.asarray(s1, jnp.int32), jnp.asarray(s2, jnp.int32)))
    assert got == oracle.score(s1, s2, GENERAL)
    with pytest.raises(ValueError):
        device_score_fn("strips", 90, 70, GENERAL)


def _run(code_or_args, env_extra, cwd=ROOT, timeout=240):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra)
    args = code_or_args if isinstance(code_or_args, list) else [
        sys.executable, "-c", code_or_args]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


_COMPILE = """
import sys
sys.path.insert(0, {root!r})
from tpualign.utils import compile_cache
print(compile_cache.setup())
import jax, jax.numpy as jnp
print(int(jax.jit(lambda x: (x * 3 + 1).sum())(jnp.arange(7))))
"""


def test_compile_cache_uses_env_dir(tmp_path):
    cache = tmp_path / "cache"
    r = _run(_COMPILE.format(root=ROOT),
             {"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(cache), "70"]
    assert any(cache.iterdir()), "no compiled entry in the env directory"


def test_compile_cache_default_is_fixed_in_checkout(tmp_path):
    # a copy of the package in a fresh "checkout": the cache must land at
    # <checkout>/.jax_cache and nowhere else
    import shutil

    checkout = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "tpualign"), checkout / "tpualign",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run(_COMPILE.format(root=str(checkout)), {}, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    want = checkout / ".jax_cache"
    assert r.stdout.split() == [str(want), "70"]
    assert any(want.iterdir())
    assert sorted(p.name for p in checkout.iterdir()) == [".jax_cache",
                                                          "tpualign"]


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_gpu_scripts_fail_without_gpu(script):
    r = _run([sys.executable, os.path.join(ROOT, script)], {})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "GCUPS" not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run([sys.executable, str(tmp_path / "chip_smoke.py")], {},
             cwd=str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_last_line_contract(monkeypatch, capsys):
    # with every phase stubbed, the last stdout line is the JSON contract
    sys.path.insert(0, ROOT)
    import chip_smoke

    desc = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: desc)
    for name in ("phase_build", "phase_headline", "phase_configs",
                 "phase_alignment", "phase_batch", "phase_gpu_tests"):
        monkeypatch.setattr(chip_smoke, name, lambda: None)
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": desc}

    def fail():
        raise chip_smoke.SmokeFailure("score mismatch")

    monkeypatch.setattr(chip_smoke, "phase_batch", fail)
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_phases_small():
    # the backend-agnostic phases, rehearsed at a small size on the CPU
    sys.path.insert(0, ROOT)
    import chip_smoke
    from tpualign.utils import native

    if not native.available():
        pytest.skip("no native toolchain")
    chip_smoke.phase_configs(300, 280)
    chip_smoke.phase_alignment(300, 280)
    chip_smoke.phase_batch(20)


def test_short_read_batch_shapes():
    sys.path.insert(0, ROOT)
    import chip_smoke

    texts, queries = chip_smoke.short_read_batch(50)
    assert len(texts) == len(queries) == 50
    assert all(t.size == 160 for t in texts)
    assert all(q.size == 150 for q in queries)
    assert all(np.all((q >= 1) & (q <= 4)) for q in queries)
