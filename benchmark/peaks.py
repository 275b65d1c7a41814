"""Published peak rates of each accelerator the benchmark runs on, keyed by
JAX's ``device_kind``.  A device that is not in the table is an error: a
share of a peak is never taken against a guess."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        # 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock; the clock is the
        # one at which the data sheet's 67 TFLOP/s FP32 (132 x 128 lanes x
        # 2) holds
        "int32_ops_per_s": 132 * 64 * 1.98e9,
        "hbm_bytes_per_s": 3.35e12,
        "source": ("NVIDIA H100 Tensor Core GPU data sheet (SXM5: 132 SMs, "
                   "67 TFLOP/s FP32, 3.35 TB/s HBM3) and NVIDIA H100 "
                   "Tensor Core GPU Architecture white paper (64 INT32 "
                   "lanes per SM); rated at the 700 W power limit"),
    },
}


class UnknownDevice(KeyError):
    """The device kind has no row in :data:`PEAKS`."""


def peak(device_kind: str) -> dict:
    """The peak row of ``device_kind``; raises :class:`UnknownDevice`."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise UnknownDevice(
            f"no published peaks for device kind {device_kind!r}; add a row "
            "with its source to benchmark/peaks.py") from None
