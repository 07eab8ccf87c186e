"""Freq-to-depth ("blocked") forward of the model family.

Counterpart of `fullycnnspeechenhancement_tpu/models/blocked.py`.  Each
layer is reparametrized EXACTLY (same math, same params; only the
floating-point reduction order changes): `fb` consecutive frequency bins
fold into the channel axis, turning every (1, k) frequency conv into a
(1, KB) conv over NB = ceil(F / fb) blocks with fb*C channels.

Weight transform (differentiable; the canonical OIHW weights stay the one
source of truth, so checkpoints and the optimizer are untouched):

    W_blk[t, d, v*Cin+ci, u*Cout+co] = w[co, ci, t, (d-dc)*fb + v - u + lo]

where u is the output bin's position in its block, v the input bin's, d
the block tap and lo = (kw-1)//2 (TF SAME for odd kw).  Out-of-range taps
gather a zero row through a sentinel index; that row is a constant, so it
receives no gradient.

Semantics kept relative to `ModelDef.apply`:
  * TF SAME padding: along frequency by the index map plus a zero pad band
    (F padded to NB*fb), re-zeroed after every layer so the next layer's
    neighbour-block taps read true zeros; along time by the conv padding;
  * training-mode BN moments over (B, T, real F) per canonical channel
    (the in-block position axis folded), masked by `frame_mask`;
  * the skip add after BN and before the ReLU, V3's residual after it;
  * the final (1, 129) projection on the unblocked layout (its taps span
    every block).

Activations keep the JAX layout [B, T, NB, fb*C] at this module's
functions; the convs see channels-last NCHW views of them.  With
`dw_pallas`, the (1, KB) inner layers go through
`ops/blocked_dw.py::blocked_freq_conv`, whose dW is the CUDA kernel.  Each
layer's chain after its conv (bias, BN, skip, ReLU, residual, pad band) is
`ops/bn_chain.py::chain_plain`; a training-mode forward runs the BN
layers' chains through `ops/bn_chain.py::bn_chain`, CUDA kernels forward
and backward on the card and `chain_plain` on the CPU.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from fullycnnspeechenhancement_torch.models.blocks import tf_same_pads
from fullycnnspeechenhancement_torch.models.rced import ModelDef
from fullycnnspeechenhancement_torch.ops.blocked_dw import blocked_freq_conv, conv_nhwc
from fullycnnspeechenhancement_torch.ops.bn_chain import bn_chain, chain_plain, make_batch

FB_DEFAULT = 8


@functools.lru_cache(maxsize=64)
def _block_index_map(kw: int, fb: int) -> Tuple[np.ndarray, int]:
    """(J [KB, fb(v), fb(u)] gather indices with sentinel kw, dc)."""
    lo, hi = (kw - 1) // 2, kw // 2
    d_min = (0 - lo - (fb - 1)) // fb  # floor over the leftmost tap
    d_max = (fb - 1 + hi) // fb
    kb = d_max - d_min + 1
    dc = -d_min
    J = np.full((kb, fb, fb), kw, np.int64)  # sentinel -> zero row
    for d in range(kb):
        for v in range(fb):
            for u in range(fb):
                j = (d - dc) * fb + v - u + lo
                if 0 <= j < kw:
                    J[d, v, u] = j
    return J, dc


@functools.lru_cache(maxsize=256)
def _block_index_tensor(kw: int, fb: int, device: torch.device) -> torch.Tensor:
    """`_block_index_map`'s J, flat, on `device` (made once: a copy from
    host memory on every call would wait for the device)."""
    return torch.as_tensor(_block_index_map(kw, fb)[0].reshape(-1), device=device)


def _block_weight(w: torch.Tensor, fb: int) -> Tuple[torch.Tensor, int]:
    """OIHW [Cout, Cin, kh, kw] -> (HWIO [kh, KB, fb*Cin, fb*Cout], dc).
    Exact and differentiable: a gather, whose backward is a scatter-add."""
    cout, cin, kh, kw = w.shape
    J, dc = _block_index_map(kw, fb)
    kb = J.shape[0]
    w_hwio = w.permute(2, 3, 1, 0)
    wpad = torch.cat([w_hwio, w_hwio.new_zeros(kh, 1, cin, cout)], dim=1)
    g = wpad.index_select(1, _block_index_tensor(kw, fb, w.device))
    g = g.reshape(kh, kb, fb, fb, cin, cout)
    g = g.permute(0, 1, 2, 4, 3, 5)  # [kh, KB, v, Cin, u, Cout]
    return g.reshape(kh, kb, fb * cin, fb * cout), dc


def block_input(x: torch.Tensor, fb: int) -> torch.Tensor:
    """NHWC [B, T, F, C] -> [B, T, NB, fb*C] (freq zero-padded to NB*fb)."""
    B, T, F, C = x.shape
    nb = -(-F // fb)
    x = torch.nn.functional.pad(x, (0, 0, 0, nb * fb - F))
    return x.reshape(B, T, nb, fb * C)


def unblock_output(z: torch.Tensor, f_dim: int, c: int) -> torch.Tensor:
    """[B, T, NB, fb*C] -> NHWC [B, T, F, C]."""
    B, T, nb, fc = z.shape
    return z.reshape(B, T, nb * (fc // c), c)[:, :, :f_dim, :]


def apply_blocked(
    model: ModelDef,
    params,
    state,
    x: torch.Tensor,
    *,
    is_training: bool,
    fb: int = FB_DEFAULT,
    frame_mask=None,
    dw_pallas: bool = False,
    reduce=None,
):
    """Drop-in equivalent of `ModelDef.apply` on NHWC [B, T, F, 1].

    Returns (y [B, T, F, 1], new_state).  Numerics match `apply` up to
    floating-point reduction order.  `frame_mask` ([B, T] or [1, T])
    restricts BN batch statistics to masked frames; the frequency pad-band
    mask composes with it.  `reduce` takes the statistics over every
    data-parallel rank (`blocks.moments_from_sums`), and the chain's
    backward sums too (`ops/bn_chain.py`).
    """
    B, T, F, _ = x.shape
    dt = x.dtype
    batch = make_batch(B, T, F, fb, dt, x.device, is_training=is_training, frame_mask=frame_mask)

    z = block_input(x, fb)
    taps, new_state = {}, {}
    for spec in model.layers:
        p = params[spec.name]
        kh, kw = spec.kernel

        if kw >= F:  # the (1, 129) projection: run unblocked
            cin = z.shape[3] // fb
            xn = unblock_output(z, F, cin)
            y = conv_nhwc(xn, p["w"].to(dt).permute(2, 3, 1, 0), tf_same_pads(spec.kernel))
            y = y + p["b"].to(dt)
            # the final layer of every variant has no BN
            if spec.use_act:
                y = torch.relu(y)
            z = block_input(y, fb)
            taps[spec.name] = z
            continue

        wb, dc = _block_weight(p["w"], fb)
        kb = wb.shape[1]
        if kh == 1 and dw_pallas:
            y = blocked_freq_conv(z, wb.to(dt), dc)
        else:
            y = conv_nhwc(z, wb.to(dt), (tf_same_pads(spec.kernel)[0], (dc, kb - 1 - dc)))
        links = dict(
            skip=None if spec.skip_from is None else taps[spec.skip_from],
            add=None if spec.add_from is None else taps[spec.add_from],
            relu=spec.use_act, reduce=reduce,
        )
        s = state.get(spec.name, {})
        # Batch statistics go through bn_chain (kernels on the card); eval
        # mode and a layer without BN stay plain.
        if spec.use_norm and is_training:
            y, st = bn_chain(y, p, s, batch, **links)
        else:
            y, st = chain_plain(y, p, s, batch, use_norm=spec.use_norm, is_training=is_training, **links)
        if st is not None:
            new_state[spec.name] = st
        taps[spec.name] = y
        z = y

    out = unblock_output(z, F, model.layers[-1].out_ch)
    # eval mode and layers without BN keep their incoming state
    for name, s in state.items():
        if name not in new_state:
            new_state[name] = s
    return out, new_state
