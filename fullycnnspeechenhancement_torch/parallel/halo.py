"""Time-axis sharded inference with a halo exchange.

Counterpart of `fullycnnspeechenhancement_tpu/parallel/halo.py`.  The
model family's time receptive field is the first conv's kernel height 8
with TF SAME pads (3 frames before, 4 after); every later layer works
frame by frame.  So a long spectrogram's time axis can split across the
devices of a mesh: each shard takes its left neighbour's last 3 frames
and its right neighbour's first 4 (zeros at the global edges, as SAME
pads them), runs `model.apply` on the extended slice on its own device
and keeps the middle.  Interior outputs equal the unsharded forward's.

In JAX each device is a member of one SPMD program and the halos move by
`ppermute`; here one process issues each shard's work on its device in
turn (the launches are asynchronous, so shards on different cards
overlap) and the halos move by device-to-device copies.  As in the JAX
package this is the plain model, not the fused stack.
"""

from __future__ import annotations

import torch

from fullycnnspeechenhancement_torch.models.rced import ModelDef
from fullycnnspeechenhancement_torch.parallel.mesh import DATA_AXIS

_HALO_L = 3  # (kh-1)//2 of the first conv's time kernel 8
_HALO_R = 4  # kh//2


def _on(tree, device):
    return {k: (_on(v, device) if isinstance(v, dict) else v.to(device)) for k, v in tree.items()}


def make_time_sharded_forward(model: ModelDef, mesh, axis: str = DATA_AXIS):
    """-> forward(params, bn_state, mag [B, T, F]) -> [B, T, F] on mag's
    device, with T split into equal shards over the devices of `axis`.
    T must be divisible by the axis size, each shard at least 4 frames."""
    devices = mesh.axis_devices(axis)
    n = len(devices)

    @torch.no_grad()
    def forward(params, bn_state, mag: torch.Tensor) -> torch.Tensor:
        B, T, F = mag.shape
        if T % n:
            raise ValueError(f"{T} frames do not split into {n} equal shards")
        tl = T // n
        if tl < _HALO_R:
            raise ValueError(f"shards of {tl} frames are shorter than the {_HALO_R}-frame halo")
        shards = [mag[:, i * tl : (i + 1) * tl].to(d) for i, d in enumerate(devices)]
        outs = []
        for i, d in enumerate(devices):
            zeros = lambda k: torch.zeros(B, k, F, dtype=mag.dtype, device=d)  # noqa: E731
            left = shards[i - 1][:, -_HALO_L:].to(d) if i > 0 else zeros(_HALO_L)
            right = shards[i + 1][:, :_HALO_R].to(d) if i < n - 1 else zeros(_HALO_R)
            ext = torch.cat([left, shards[i], right], dim=1)
            pred, _ = model.apply(_on(params, d), _on(bn_state, d), ext[..., None], is_training=False)
            outs.append(pred[:, _HALO_L : _HALO_L + tl, :, 0])
        return torch.cat([o.to(mag.device) for o in outs], dim=1)

    return forward
