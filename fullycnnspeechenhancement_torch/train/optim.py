"""Optimizer and LR schedule with TF-1.14 semantics.

Counterpart of `fullycnnspeechenhancement_tpu/train/optim.py`.  The
reference trains with `tf.train.AdamOptimizer` under a Noam warmup
schedule.  Two fidelity details:

  * TF Adam's epsilon sits *outside* the bias-corrected sqrt:
    theta -= lr * sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps).
    `torch.optim.Adam` applies eps to the corrected v_hat instead, which
    changes the effective epsilon by 1/sqrt(1-b2^t) in early steps, so it
    is not this optimizer.
  * The reference feeds lr = init_lr on the very first step.  We use
    lr(t) = noam(t) for all t, which matches the reference from step 1
    onward; only step 0 differs (init_lr vs init_lr/warmup).  Documented
    departure, the same as the JAX package's.

The optimizer is plain functions on the parameter dicts: `tf_adam_init`
makes the moments, `tf_adam_update` updates parameters and moments in
place (the port's one departure from the JAX package's pure functions: it
saves a copy of every leaf per step).  The step count and the learning
rate stay on the tensors' device, so a step never waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def noam_schedule(init_lr: float, warmup_steps: float):
    """lr(step) = init_lr * warmup^0.5 * min((step+1)*warmup^-1.5,
    (step+1)^-0.5).  `step` is a number or a tensor (float32 out).

    A tensor step is evaluated in float64 and rounded to float32 once, as
    the JAX package's schedule is under `jax_enable_x64` (there `step + 1.0`
    is float64 and Adam's float32 bias correction rounds it).  Evaluated
    in float32 (a reciprocal square root and three products) it lay up to
    1.9e-7 from that value, a systematic difference in every update that a
    float64 trajectory amplifies (tests/test_torch_trajectory.py)."""

    def schedule(step):
        if isinstance(step, torch.Tensor):
            s = step.to(torch.float64) + 1.0
            lr = init_lr * warmup_steps**0.5 * torch.minimum(s * warmup_steps**-1.5, s**-0.5)
            return lr.to(torch.float32)
        s = step + 1.0
        return init_lr * warmup_steps**0.5 * min(s * warmup_steps**-1.5, s**-0.5)

    return schedule


class TFAdamState(NamedTuple):
    count: torch.Tensor  # 0-dim int64, updates applied so far
    mu: dict  # first moments, shaped like the params
    nu: dict  # second moments


def _leaves(tree: dict):
    return [t for name in sorted(tree) for _, t in sorted(tree[name].items())]


def tf_adam_init(params: dict) -> TFAdamState:
    device = _leaves(params)[0].device
    zeros = lambda: {  # noqa: E731
        name: {k: torch.zeros_like(v) for k, v in p.items()} for name, p in params.items()
    }
    return TFAdamState(torch.zeros((), dtype=torch.int64, device=device), zeros(), zeros())


@torch.no_grad()
def tf_adam_update(
    params: dict,
    grads: dict,
    state: TFAdamState,
    learning_rate,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> TFAdamState:
    """One TF Adam step, in place on `params` and the moments.

    `learning_rate` is a float or a schedule fn(step) -> lr, evaluated at
    the count *before* this update, like the JAX package.  Returns the new
    state (the same moment dicts, count + 1)."""
    count = state.count + 1
    t = count.to(torch.float32)
    lr = learning_rate(state.count) if callable(learning_rate) else learning_rate
    # The bias correction in float32, as the JAX package computes it; its
    # square root taken in float64 and rounded once, which is the correctly
    # rounded float32 root (torch's float32 sqrt on the CPU is one ulp off
    # at some counts: 51, 68, 138 and 145 among the first 150).
    root = torch.sqrt((1.0 - torch.pow(b2, t)).to(torch.float64)).to(torch.float32)
    alpha = lr * root / (1.0 - torch.pow(b1, t))
    p_l, g_l = _leaves(params), _leaves(grads)
    m_l, v_l = _leaves(state.mu), _leaves(state.nu)
    torch._foreach_mul_(m_l, b1)
    torch._foreach_add_(m_l, g_l, alpha=1.0 - b1)
    torch._foreach_mul_(v_l, b2)
    torch._foreach_addcmul_(v_l, g_l, g_l, value=1.0 - b2)
    denom = torch._foreach_sqrt(v_l)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(m_l, denom)
    torch._foreach_mul_(step, -alpha)
    torch._foreach_add_(p_l, step)
    return TFAdamState(count, state.mu, state.nu)
