"""The accelerator a measurement ran on, and the refusal to measure without one."""

from __future__ import annotations

import subprocess


class NoAcceleratorError(RuntimeError):
    """JAX found no GPU: a device measurement cannot be made."""


def require_gpu():
    """The first GPU device; raises :class:`NoAcceleratorError` otherwise."""
    import jax

    if jax.default_backend() != "gpu":
        raise NoAcceleratorError(
            f"no GPU: JAX's backend is {jax.default_backend()!r}")
    return jax.devices()[0]


def card() -> str:
    """``name, power.limit`` of the first card as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def describe() -> dict:
    """The device as JAX reports it, keyed as the benchmark's JSON keys it."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}
