"""The ('data', 'shard') device grid of the sharded index.

Counterpart of ``deepreadmapper_tpu/parallel/mesh.py``, with its shapes and
its error messages.  'shard' splits the index rows: shard s is a complete
sub-index over a contiguous slice of the vectors, resident on the grid's
device in row 0, column s.  'data' splits each query batch into n_data
blocks, as the JAX mesh does (the INT8FLAT and PQFLAT shards quantize each
block with its own scale, as the JAX shards do).  The port runs no SPMD
program: a search loops over the blocks and the shards, and each shard
searches on its own device.

One difference is necessary.  A JAX mesh takes one device per position,
and the JAX tests fake eight CPU devices.  torch has one CPU device, and
the card machine has one GPU, so here several shards may share a device:
when the grid needs more devices than it is given, position (d, s) takes
``devices[(d * n_shard + s) % len(devices)]`` -- shard s on
``devices[s % len(devices)]`` -- and a card holding several shards
searches them one after another.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A grid of torch devices with the JAX mesh's axis names and shape."""

    axis_names = ("data", "shard")

    def __init__(self, devices: np.ndarray):
        self.devices = devices  # object array [n_data, n_shard] of torch.device
        self.shape = {"data": devices.shape[0], "shard": devices.shape[1]}

    def shard_device(self, s: int) -> torch.device:
        """The device that holds shard s."""
        return self.devices[0, s]

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, shard={self.shape['shard']})"


def _grid(devices, n_data: int, n_shard: int) -> np.ndarray:
    arr = np.empty((n_data, n_shard), dtype=object)
    for d in range(n_data):
        for s in range(n_shard):
            arr[d, s] = torch.device(devices[(d * n_shard + s) % len(devices)])
    return arr


def _default_devices() -> list[torch.device]:
    """Every visible card; raises without one (the port's rule: the CPU
    only when the caller asks for it)."""
    from deepreadmapper_tpu_torch import default_device

    default_device()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_distributed_mesh(n_shard: int, devices=None) -> Mesh:
    """('data', 'shard') grid for multi-process serving: SHARD columns are
    contiguous device blocks, aligned with ``distributed.own_shards``'
    contiguous per-process shard assignment, so shard s sits on the device
    of the process that loaded its files.  devices lists each process's
    device in rank order.  With at least n_shard devices, n_data =
    devices // n_shard, as in the JAX package; with fewer, each device
    holds n_shard / len(devices) consecutive shards and n_data is 1."""
    devices = list(devices) if devices is not None else _default_devices()
    nd = len(devices)
    if nd >= n_shard:
        if nd % n_shard:
            raise ValueError(
                f"{nd} devices cannot hold {n_shard} equal shard columns; "
                "choose a shard count dividing the device count"
            )
        n_data = nd // n_shard
        arr = np.empty((n_shard * n_data,), dtype=object)
        arr[:] = [torch.device(d) for d in devices]
        return Mesh(arr.reshape(n_shard, n_data).T.copy())
    if n_shard % nd:
        raise ValueError(
            f"{nd} devices cannot hold {n_shard} equal shard columns; "
            "choose a shard count the device count divides"
        )
    per = n_shard // nd
    arr = np.empty((1, n_shard), dtype=object)
    for s in range(n_shard):
        arr[0, s] = torch.device(devices[s // per])
    return Mesh(arr)


def make_mesh(n_data: int | None = None, n_shard: int = 1, devices=None) -> Mesh:
    """('data', 'shard') grid over devices (default: every visible card).
    n_data defaults to devices // n_shard (at least 1).  With enough
    devices the grid is the JAX one, devices[:n] row-major; with fewer,
    positions share devices (module docstring)."""
    devices = list(devices) if devices is not None else _default_devices()
    if n_data is None:
        n_data = max(1, len(devices) // n_shard)
    if n_data < 1 or n_shard < 1:
        raise ValueError(f"mesh {n_data}x{n_shard} needs at least one position "
                         "on each axis")
    return Mesh(_grid(devices, n_data, n_shard))
