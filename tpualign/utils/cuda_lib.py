"""Build and register the repository's CUDA kernels (``tpualign/ops/cuda``).

The library is compiled with ``nvcc`` for Hopper (``sm_90a``) at first use,
into ``build/cuda/<hash>/`` at the root of the checkout, where ``<hash>``
covers the sources and the compiler command; a changed source therefore
builds a new library and never loads a stale one.  ``python -m
tpualign.utils.cuda_lib`` builds it ahead of time.  Build failures raise:
a caller that asked for the kernel gets an error, not a silent fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "ops", "cuda")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "cuda")
LIB_NAME = "libtpualign_cuda.so"

#: FFI target name -> exported handler symbol
TARGETS = {"tpualign_bitpal_score": "TpualignBitpalScore"}

_registered = False
#: seconds the last build in this process took (0.0 when the library existed)
last_build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                       "build the GPU kernels")


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")


def _command(nvcc: str, out: str):
    import jax.ffi

    return [nvcc, *FLAGS, "-I", jax.ffi.include_dir(), "-o", out,
            *_sources()]


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def build() -> str:
    """Compile the library unless it exists; returns its path."""
    global last_build_seconds
    path = library_path()
    if os.path.exists(path):
        last_build_seconds = 0.0
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.partial"
    t0 = time.perf_counter()
    proc = subprocess.run(_command(_nvcc(), tmp), capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)
    last_build_seconds = time.perf_counter() - t0
    return path


def register() -> None:
    """Build (if needed), load, and register every FFI target for CUDA."""
    global _registered
    if _registered:
        return
    import jax.ffi

    lib = ctypes.CDLL(build())
    for target, symbol in TARGETS.items():
        jax.ffi.register_ffi_target(
            target, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA")
    _registered = True


if __name__ == "__main__":
    print(build())
