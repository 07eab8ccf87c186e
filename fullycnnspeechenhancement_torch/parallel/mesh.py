"""Device meshes: a grid of torch devices with named axes.

Counterpart of `fullycnnspeechenhancement_tpu/parallel/mesh.py`.  Axes:
('data', 'model').  The 32k-parameter R-CED family needs no tensor
parallelism, so 'model' stays size 1 by default.  A mesh here is only a
placement: the time-sharded forward (`parallel/halo.py`) runs one shard
on each device of its 'data' axis from one process.  Data-parallel
training does not use it; it runs one process per rank over
`torch.distributed` (`parallel/dp.py`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """`devices`, an [n_data, n_model] object array of `torch.device`, with
    `axis_names` and `shape` ({axis name: size}) as JAX's Mesh has them."""

    def __init__(self, devices: np.ndarray, axis_names=(DATA_AXIS, MODEL_AXIS)):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis: str = DATA_AXIS) -> list:
        """The devices along `axis`, at index 0 of every other axis."""
        i = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, i, 0).reshape(self.devices.shape[i], -1)[:, 0])


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """An n_data x n_model mesh over the first n_data * n_model of
    `devices` (default: every CUDA card of this process).  A caller may
    name one device several times (tests, or shards that share a card)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    n = n_data * n_model
    if n < 1 or n > len(devices):
        raise ValueError(f"mesh {n_data}x{n_model} needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid.reshape(n_data, n_model))
