"""Plain training steps: the model of `model.py`, its loss, autograd
gradients, TF-1.14 Adam under the Noam warm-up, and BN's running
statistics.

TF Adam puts epsilon outside the bias-corrected root:
    alpha = lr * sqrt(1 - b2^t) / (1 - b1^t)
    theta -= alpha * m / (sqrt(v) + eps)
with lr = noam(t - 1) = init_lr * warmup^0.5 * min(t * warmup^-1.5, t^-0.5)
for the t-th update (t from 1), and the moving BN statistics follow
moving = 0.99 * moving + 0.01 * batch with the biased batch variance.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from . import model

B1, B2, EPS = 0.9, 0.999, 1e-8


def noam(init_lr: float, warmup: float, step: int) -> float:
    s = step + 1.0
    return init_lr * warmup**0.5 * min(s * warmup**-1.5, s**-0.5)


class Steps(NamedTuple):
    losses: List[float]  # each step's loss
    grads: dict  # the first step's gradient, {layer: {leaf: tensor}}
    params: dict  # the parameters after the last step
    bn: dict  # the BN running statistics after the last step


def run_steps(layers, params0, bn0, batches, batch_size: int, lr: float, warmup: float,
              dtype=torch.float64, device="cpu", bits=None, remat: bool = False) -> Steps:
    """Train from (params0, bn0) over `batches`, a list of (mix magnitude,
    clean magnitude) [B, T, F] arrays, one optimizer step each, in
    `dtype` on `device`; `bits` rounds as `model.forward` says."""
    params = model.cast(params0, dtype, device)
    bn = model.cast(bn0, dtype, device)
    names = [(n, k) for n in sorted(params) for k in sorted(params[n])]
    leaves = [params[n][k].requires_grad_(True) for n, k in names]
    mu = [torch.zeros_like(v) for v in leaves]
    nu = [torch.zeros_like(v) for v in leaves]
    losses, first = [], None
    for t, (mix, clean) in enumerate(batches):
        x = torch.as_tensor(np.asarray(mix), dtype=dtype, device=device)
        y = torch.as_tensor(np.asarray(clean), dtype=dtype, device=device)
        pred, stats = model.forward(layers, params, bn, x, training=True, bits=bits, remat=remat)
        loss = model.spectral_loss(pred.to(dtype), y, batch_size)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if first is None:
            first = {}
            for (n, k), g in zip(names, grads):
                first.setdefault(n, {})[k] = g.detach().clone()
        count = t + 1
        alpha = noam(lr, warmup, t) * math.sqrt(1.0 - B2**count) / (1.0 - B1**count)
        with torch.no_grad():
            for p, g, m, v in zip(leaves, grads, mu, nu):
                m.mul_(B1).add_(g, alpha=1.0 - B1)
                v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
                p.sub_(alpha * m / (torch.sqrt(v) + EPS))
            for name, (mean, var) in stats.items():
                s = bn[name]
                s["mean"] = model.BN_MOMENTUM * s["mean"] + (1.0 - model.BN_MOMENTUM) * mean.to(dtype)
                s["var"] = model.BN_MOMENTUM * s["var"] + (1.0 - model.BN_MOMENTUM) * var.to(dtype)
        del pred, loss, grads, stats
    out = {n: {k: v.detach() for k, v in d.items()} for n, d in params.items()}
    return Steps(losses, first, out, bn)
