"""Mesh construction helpers for the sharded engines."""

from __future__ import annotations

from typing import Optional, Sequence

import jax

AXIS = "x"


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None):
    """1-D mesh over the sequence (column) axis.

    The reference's process grid is likewise 1-D: MPI ranks own column strips
    (``mpi-vert-driver.cpp:35-38``).  The mesh is a flat device list: GPUs
    of one host reach each other all to all over NVLink, so the order of
    the devices along the axis does not matter.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return jax.sharding.Mesh(list(devices), (AXIS,))
