"""The conv + batch-norm + (skip) + relu building block, on NCHW tensors.

Counterpart of `fullycnnspeechenhancement_tpu/models/blocks.py`.
Behavioural spec: the reference's `model_utils/module.py:11-34` --
conv2d(SAME) -> optional BN -> optional skip-add (after BN, *before* ReLU)
-> optional ReLU, with TF-1.14 semantics:

  * SAME padding for even kernels is asymmetric: (k-1)//2 before, k//2
    after (time-kernel 8 -> 3 frames before, 4 after), so the block pads
    with `F.pad` and convolves with padding 0;
  * conv kernel init Glorot/Xavier uniform, bias zeros;
  * BN momentum 0.99, epsilon 1e-3, applied by hand (not
    `nn.BatchNorm2d`, which updates the running variance with the
    unbiased estimate and takes no frame mask); moving stats are updated
    as moving = momentum*moving + (1-momentum)*batch with the *biased*
    batch variance.

Weights are OIHW.  The JAX package keeps HWIO; `w_hwio.permute(3, 2, 0, 1)`
converts, with no flip: both frameworks compute cross-correlation.
Activations run in the dtype of `x`; parameters and BN state stay float32
and are cast to it where the JAX package casts them.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

BN_MOMENTUM = 0.99
BN_EPSILON = 1e-3


def tf_same_pads(kernel: Tuple[int, int]) -> tuple:
    """TF SAME padding (stride 1): (k-1)//2 before, k//2 after, per dim."""
    kh, kw = kernel
    return ((kh - 1) // 2, kh // 2), ((kw - 1) // 2, kw // 2)


def conv2d_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NCHW conv, stride 1, TF SAME padding; `w` is OIHW."""
    (ph0, ph1), (pw0, pw1) = tf_same_pads(tuple(w.shape[2:]))
    return F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), w, b)


def masked_moments(y: torch.Tensor, frame_mask: Optional[torch.Tensor]):
    """Biased batch (mean, var) per channel of NCHW `y` over (B, T, F), in
    at least float32 (float64 stays float64), as E[y^2] - mean^2.

    `frame_mask` ([B, T] per utterance, or [1, T]: the batch-max mask,
    which stays broadcast) restricts the moments to masked frames; the
    denominator is sum(mask) * F * (B // rows of the mask)."""
    y32 = y.to(torch.promote_types(torch.float32, y.dtype))
    if frame_mask is None:
        mean = y32.mean(dim=(0, 2, 3))
        return mean, (y32 * y32).mean(dim=(0, 2, 3)) - mean * mean
    m = frame_mask.to(y32.dtype)[:, None, :, None]
    n = m.sum() * y.shape[3] * (y.shape[0] // frame_mask.shape[0])
    mean = (y32 * m).sum(dim=(0, 2, 3)) / n
    return mean, (y32 * y32 * m).sum(dim=(0, 2, 3)) / n - mean * mean


def updated_bn_state(state, mean: torch.Tensor, var: torch.Tensor):
    """The moving statistics after one training batch (detached)."""
    return {
        "mean": BN_MOMENTUM * state["mean"] + (1.0 - BN_MOMENTUM) * mean.detach(),
        "var": BN_MOMENTUM * state["var"] + (1.0 - BN_MOMENTUM) * var.detach(),
    }


def glorot_uniform(generator: torch.Generator, out_ch, in_ch, kh, kw) -> torch.Tensor:
    """Glorot/Xavier uniform OIHW conv kernel (tf.layers default)."""
    fan_in, fan_out = kh * kw * in_ch, kh * kw * out_ch
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand((out_ch, in_ch, kh, kw), generator=generator, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def conv_bn_relu_init(
    generator: torch.Generator,
    in_ch: int,
    out_ch: int,
    kernel: Tuple[int, int],
    use_norm: bool = True,
):
    """(params, state) for one block.  State is empty without BN."""
    params = {
        "w": glorot_uniform(generator, out_ch, in_ch, *kernel),
        "b": torch.zeros(out_ch),
    }
    state = {}
    if use_norm:
        params["gamma"] = torch.ones(out_ch)
        params["beta"] = torch.zeros(out_ch)
        state = {"mean": torch.zeros(out_ch), "var": torch.ones(out_ch)}
    return params, state


def bn_scale_shift(params, mean, var):
    """BN as y * scale + shift, per channel, from (mean, var)."""
    scale = params["gamma"] * torch.rsqrt(var + BN_EPSILON)
    return scale, params["beta"] - mean * scale


def conv_bn_relu_apply(
    params,
    state,
    x: torch.Tensor,
    *,
    is_training: bool = False,
    use_norm: bool = True,
    use_act: bool = True,
    skip_input: Optional[torch.Tensor] = None,
    frame_mask: Optional[torch.Tensor] = None,
):
    """Apply one block to NCHW `x` ([B, C, T, F]).  Returns (y, new_state).

    `new_state` is `state` unchanged in eval mode or without BN.  In
    training mode BN normalises with the batch moments over (B, T, F),
    restricted to the frames of `frame_mask` ([B, T] or [1, T]) when it is
    given; activations at masked-out frames still flow forward."""
    y = conv2d_same(x, params["w"].to(x.dtype), params["b"].to(x.dtype))
    new_state = state
    if use_norm:
        if is_training:
            mean, var = masked_moments(y, frame_mask)
            new_state = updated_bn_state(state, mean, var)
        else:
            mean, var = state["mean"], state["var"]
        scale, shift = bn_scale_shift(params, mean, var)
        y = y * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
    if skip_input is not None:
        # Skip add after BN, before ReLU (module.py:30-31).
        y = y + skip_input
    if use_act:
        y = torch.relu(y)
    return y, new_state
