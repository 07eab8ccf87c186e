"""Plain forward, loss and training steps of the R-CED family in torch.

Written from the layer equations (`specs.py`), TF-1.14 semantics: conv
with TF SAME padding, BN (momentum 0.99, epsilon 1e-3, biased batch
variance), the skip added after BN and before the ReLU, V3's residual
after it; the loss is the squared spectral error summed over the batch
padded to its longest utterance, divided by the configured batch size.
No kernel, cache or batching of the program: `F.conv2d` on whatever
dtype it is given (the reference's is float64, or float32 without TF32
under a bf16 configuration: `check.training_reference`).

`bits` turns the same code into the controls of the correctness check:
every conv operand and every layer's output is rounded to `bits` mantissa
bits (`round_mantissa`: 10 for TF32, 7 for bf16, 3 for fp8 e4m3), with
straight-through gradients.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .specs import in_channels

BN_MOMENTUM = 0.99
BN_EPSILON = 1e-3


def round_mantissa(x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """`x` rounded to nearest (ties to even) with `bits` explicit mantissa
    bits and float32's exponent range, returned in float32; `x` itself
    when `bits` is None."""
    if bits is None:
        return x
    shift = 23 - bits
    i = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (i >> shift) & 1
    i = (i + ((1 << (shift - 1)) - 1) + lsb) & ~((1 << shift) - 1)
    return i.view(torch.float32)


def lowp(x: torch.Tensor, bits: Optional[int]) -> torch.Tensor:
    """`round_mantissa` in the forward pass, the identity in the backward."""
    if bits is None:
        return x
    return x + (round_mantissa(x, bits).to(x.dtype) - x).detach()


def init_params(layers, seed: int):
    """(params, bn_state) in float32 on the CPU: Glorot-uniform OIHW
    kernels drawn layer by layer from one CPU `torch.Generator` seeded
    with `seed` (`torch.rand`, then (2u - 1) * limit, as tf.layers'
    initializer is commonly written), zero biases, unit BN scale, zero BN
    shift, BN statistics mean 0 and variance 1."""
    g = torch.Generator().manual_seed(seed)
    params, bn = {}, {}
    for lay, cin in zip(layers, in_channels(layers)):
        kh, kw = lay.kernel
        limit = math.sqrt(6.0 / (kh * kw * cin + kh * kw * lay.out_ch))
        u = torch.rand((lay.out_ch, cin, kh, kw), generator=g, dtype=torch.float32)
        p = {"w": (2.0 * u - 1.0) * limit, "b": torch.zeros(lay.out_ch)}
        if lay.use_norm:
            p["gamma"] = torch.ones(lay.out_ch)
            p["beta"] = torch.zeros(lay.out_ch)
            bn[lay.name] = {"mean": torch.zeros(lay.out_ch), "var": torch.ones(lay.out_ch)}
        params[lay.name] = p
    return params, bn


def cast(tree: dict, dtype, device) -> dict:
    """A copy of a {layer: {leaf: tensor}} tree in `dtype` on `device`."""
    return {n: {k: v.detach().to(device=device, dtype=dtype, copy=True) for k, v in d.items()} for n, d in tree.items()}


def _block(lay, training: bool, bits, h, skip, add, w, b, gamma, beta, mean, var):
    kh, kw = lay.kernel
    y = F.conv2d(F.pad(lowp(h, bits), ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)), lowp(w, bits), b)
    stats = ()
    if lay.use_norm:
        if training:
            mean = y.mean(dim=(0, 2, 3))
            var = torch.square(y - mean[:, None, None]).mean(dim=(0, 2, 3))
            stats = (mean.detach(), var.detach())
        scale = gamma * torch.rsqrt(var + BN_EPSILON)
        y = y * scale[:, None, None] + (beta - mean * scale)[:, None, None]
    if skip is not None:
        y = y + skip
    if lay.use_act:
        y = torch.relu(y)
    if add is not None:
        y = y + add
    return (lowp(y, bits),) + stats


def forward(layers, params, bn, x: torch.Tensor, training: bool, bits=None, remat: bool = False):
    """[B, T, F] magnitude -> ([B, T, F] prediction, {layer: (mean, var)}
    of the batch statistics when `training`).  BN uses the batch's
    statistics over every (row, frame, bin) of `x` when `training`, else
    `bn`.  `remat` recomputes each layer in the backward pass instead of
    keeping its intermediates (the layer outputs are kept)."""
    h = lowp(x[:, None], bits)
    taps, stats = {}, {}
    for lay in layers:
        p = params[lay.name]
        s = bn.get(lay.name, {})
        args = (
            h,
            taps[lay.skip_from] if lay.skip_from else None,
            taps[lay.add_from] if lay.add_from else None,
            p["w"], p["b"], p.get("gamma"), p.get("beta"), s.get("mean"), s.get("var"),
        )
        if remat:
            out = checkpoint(_block, lay, training, bits, *args, use_reentrant=False)
        else:
            out = _block(lay, training, bits, *args)
        h = out[0]
        if len(out) == 3:
            stats[lay.name] = out[1:]
        taps[lay.name] = h
    return h[:, 0], stats


def spectral_loss(pred: torch.Tensor, clean: torch.Tensor, batch_size: int) -> torch.Tensor:
    """sum((clean - pred)^2) / the configured batch size."""
    return torch.square(clean - pred).sum() / batch_size
