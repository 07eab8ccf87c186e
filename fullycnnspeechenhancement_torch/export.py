"""Model export: the reference's freeze-to-pb equivalent.

Counterpart of `fullycnnspeechenhancement_tpu/export.py`.  `freeze.py` in
the reference folds checkpoint variables into a frozen GraphDef
(`freeze.py:31-48`).  The port writes:

  * `export_npz`: weights and BN statistics in the TF-variable-name npz
    layout both packages read (`train/checkpoint.py`);
  * `export_torch`: a `torch.export` artefact of the BN-folded inference
    forward ([B, T, F, 1] magnitude -> enhanced magnitude, float32, plain
    torch convs), where the JAX package writes StableHLO.  The folded
    weights are constants of the program, as a frozen graph's are.
    `load_torch_export` returns the program; call `.module()(x)`.

The artefact's constants live on the device the weights were on when it
was written.  It is tied to the torch version that wrote it: reload it
with the same version.
"""

from __future__ import annotations

import logging
import os

import torch

from fullycnnspeechenhancement_torch.config import Config
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.models.blocks import conv2d_same
from fullycnnspeechenhancement_torch.ops.rced_stack import fold_bn_inference
from fullycnnspeechenhancement_torch.train.checkpoint import export_params_npz

logger = logging.getLogger(__name__)


def export_npz(path: str, params: dict, bn_state: dict) -> str:
    export_params_npz(path, params, bn_state)
    logger.info("wrote weights npz: %s", path)
    return path


class FoldedForward(torch.nn.Module):
    """The inference forward with BN folded into each conv: conv, then the
    pre-ReLU skip, ReLU, and V3's post-ReLU residual, as `ModelDef.apply`
    in eval mode computes them."""

    def __init__(self, model, params, bn_state):
        super().__init__()
        self.specs = []
        for i, (spec, w, b) in enumerate(fold_bn_inference(model, params, bn_state)):
            self.register_buffer(f"w{i}", w.detach().to(torch.float32).contiguous())
            self.register_buffer(f"b{i}", b.detach().to(torch.float32).contiguous())
            self.specs.append(spec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)  # NCHW inside
        taps = {}
        for i, spec in enumerate(self.specs):
            y = conv2d_same(h, getattr(self, f"w{i}"), getattr(self, f"b{i}"))
            if spec.skip_from is not None:
                y = y + taps[spec.skip_from]
            if spec.use_act:
                y = torch.relu(y)
            if spec.add_from is not None:
                y = y + taps[spec.add_from]
            taps[spec.name] = h = y
        return h.permute(0, 2, 3, 1)


def export_torch(
    config: Config,
    params: dict,
    bn_state: dict,
    path: str,
    batch: int = 1,
    frames: int = 512,
) -> str:
    """Write the inference forward ([batch, frames, F, 1] float32
    magnitude -> enhanced magnitude) as a `torch.export` artefact."""
    module = FoldedForward(get_model(config.model.net_work), params, bn_state).eval()
    device = next(module.buffers()).device
    example = torch.zeros(batch, frames, config.model.feature_dim, 1, device=device)
    with torch.no_grad():
        program = torch.export.export(module, (example,))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    logger.info("wrote torch.export artefact: %s (%d bytes)", path, os.path.getsize(path))
    return path


def load_torch_export(path: str):
    """-> the `torch.export.ExportedProgram` written by `export_torch`."""
    return torch.export.load(path)
