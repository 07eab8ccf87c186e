"""How `correct` is decided: the plain reference worked out again from the
benchmark's own inputs, and the numbers that hold the program's outputs
against it.  Each number has its limit in `limits/<cell>.json`.

Training (`train_numbers`), over the first three steps, which the
program runs through the window's own call and feed:
  * loss_gap: the largest |loss - loss_ref| / |loss_ref| of a step;
  * grad_gap: the worst leaf's |‖g‖ - ‖g_ref‖| over the larger of
    ‖g_ref‖ and the median leaf's, g the first gradient as Adam got it
    (its first moment after one step over 1 - beta1);
  * grad_err: ‖g - g_ref‖ / ‖g_ref‖ over all those leaves together, so
    that rounding, which is unbiased, averages out where a wrong gradient
    (of the wrong sign or size, or half of the batch's) does not;
  * change_gap: the same for the parameters' change over the three;
  * bn_gap: the same for the BN running statistics' change;
  * bn_err: ‖b - b_ref‖ / ‖b_ref‖ of that change over all the statistics
    together.
Leaves whose reference gradient is under a thousandth of the median
leaf's (the conv biases before a training-mode BN, whose gradient is
zero but for rounding) are left out of grad_gap and change_gap.

Serving (`serve_numbers`), over the checked requests, y the waveform the
window's call returned:
  * wave_err_q999: the largest 99.9th percentile of |y - y_ref| over a
    request's samples, over max|y_ref|;
  * wave_err: the largest max|y - y_ref| / max|y_ref|.
The maximum is not a sound number to hold: a frame whose DC bin has a
real part within rounding of 0 has no defined phase, so float32 and the
reference can give it opposite signs, and the rebuild then differs by
that bin's predicted magnitude over the frame's 128 samples and the
de-emphasis tail (about a thousand samples).  The 99.9th percentile
leaves such a frame out of a long request, and not an answer that is
wrong throughout.

The controls are the same reference computed one precision below the
configuration's (`CONTROL_BITS`), held to the reference by the same
numbers.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from portbench.reference import dsp, mixing, model, train

# mantissa bits of the control for a stated precision: TF32 for float32,
# fp8 e4m3 for bfloat16
CONTROL_BITS = {"float32": 10, "bfloat16": 3}
# the training reference's dtype for a stated precision
REFERENCE_DTYPE = {"float32": torch.float64, "bfloat16": torch.float32}
EXCLUDE_BELOW = 1e-3


def _leaves(tree) -> dict:
    return {(n, k): v.detach().double().cpu().numpy() for n, d in tree.items() for k, v in d.items()}


def _norm_gap(prog: dict, ref: dict, keep) -> float:
    norms = {k: float(np.linalg.norm(ref[k])) for k in keep}
    med = float(np.median(list(norms.values())))
    return max(abs(float(np.linalg.norm(prog[k])) - norms[k]) / max(norms[k], med, 1e-300) for k in keep)


def _rel_err(prog: dict, ref: dict, keep) -> float:
    num = sum(float(np.sum((prog[k] - ref[k]) ** 2)) for k in keep)
    return float(np.sqrt(num / max(sum(float(np.sum(ref[k] ** 2)) for k in keep), 1e-300)))


def train_numbers(prog: dict, ref_p0, ref_bn0, ref: train.Steps) -> dict:
    """`prog`: the program's "losses" of the three steps, and its "params0",
    "bn0" (before them), "mu1" (Adam's first moment after one), "params3"
    and "bn3" (after three), as {layer: {leaf: tensor}}."""
    g_ref = _leaves(ref.grads)
    g_prog = {k: v / (1.0 - train.B1) for k, v in _leaves(prog["mu1"]).items()}
    med = float(np.median([np.linalg.norm(v) for v in g_ref.values()]))
    keep = [k for k, v in g_ref.items() if np.linalg.norm(v) >= EXCLUDE_BELOW * med]
    p0, p3 = _leaves(prog["params0"]), _leaves(prog["params3"])
    r0, r3 = _leaves(ref_p0), _leaves(ref.params)
    b0, b3 = _leaves(prog["bn0"]), _leaves(prog["bn3"])
    q0, q3 = _leaves(ref_bn0), _leaves(ref.bn)
    losses = zip(prog["losses"], ref.losses)
    db, dq = {k: b3[k] - b0[k] for k in q0}, {k: q3[k] - q0[k] for k in q0}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in losses),
        "grad_gap": _norm_gap(g_prog, g_ref, keep),
        "grad_err": _rel_err(g_prog, g_ref, keep),
        "change_gap": _norm_gap({k: p3[k] - p0[k] for k in keep}, {k: r3[k] - r0[k] for k in keep}, keep),
        "bn_gap": _norm_gap(db, dq, list(q0)),
        "bn_err": _rel_err(db, dq, list(q0)),
    }


def training_reference(layers, seed: int, ini: dict, corpus, batches, device,
                       dsp_bits: Optional[int] = None, model_bits: Optional[int] = None,
                       half_batch: bool = False):
    """(params0, bn0, Steps) of the reference over `batches` ([dataset
    indices] of each step, all drawn in epoch 0), made from the corpus's
    int16 audio and the run's seed, in `REFERENCE_DTYPE` of the
    configuration's compute precision: float64 for float32, float32
    without TF32 for bf16 (a million times finer than its rounding, and
    several times faster on the card than float64).  The bits make a
    control, computed in float32 without TF32; `half_batch` is the fault
    that leaves half of each batch out and takes the mean over the rest
    (the kept half, twice)."""
    prec = ini["model"].get("compute_dtype", "float32")
    if prec not in REFERENCE_DTYPE:
        raise ValueError(f"no training reference for compute_dtype {prec!r}")
    dtype = REFERENCE_DTYPE[prec] if dsp_bits is None and model_bits is None else torch.float32
    clean = [c.astype(np.float64) / 32768.0 for c in corpus.clean]
    noise = [c.astype(np.float64) / 32768.0 for c in corpus.noise]
    steps = []
    for idxs in batches:
        pairs = mixing.training_pairs(clean, noise, idxs, seed, 0, float(ini["data"]["snr"]))
        if half_batch:
            pairs = pairs[: len(pairs) // 2] * 2
        mix_mag = dsp.analyze([m for m, _ in pairs], bits=dsp_bits)[0]
        clean_mag = dsp.analyze([c for _, c in pairs], bits=dsp_bits)[0]
        steps.append((mix_mag, clean_mag))
    p0, bn0 = model.init_params(layers, seed)
    t = ini["training"]
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = train.run_steps(
            layers, p0, bn0, steps, int(t["batch_size"]), float(t["lr"]), float(t["warmup_steps"]),
            dtype=dtype, device=device, bits=model_bits, remat=True,
        )
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return p0, bn0, out


def serving_reference(layers, seed: int, signal: np.ndarray, device,
                      dsp_bits: Optional[int] = None, model_bits: Optional[int] = None) -> np.ndarray:
    """The denoised waveform of one request, BN in inference mode, with
    the weights the run's seed makes."""
    dtype = torch.float64 if dsp_bits is None and model_bits is None else torch.float32
    p, bn = model.init_params(layers, seed)
    p, bn = model.cast(p, dtype, device), model.cast(bn, dtype, device)
    mag, pre, pim = dsp.analyze([np.asarray(signal, np.float64)], bits=dsp_bits)
    with torch.no_grad():
        x = torch.as_tensor(mag, dtype=dtype, device=device)
        pred = model.forward(layers, p, bn, x, training=False, bits=model_bits)[0][0]
    return dsp.rebuild(pred.double().cpu().numpy(), pre[0], pim[0], len(signal), bits=dsp_bits)


def serve_numbers(pairs) -> dict:
    """The serving numbers over [(y, y_ref)] of the checked requests."""
    gaps = [(np.abs(np.asarray(y, np.float64) - ref), np.max(np.abs(ref))) for y, ref in pairs]
    return {
        "wave_err_q999": max(float(np.quantile(d, 0.999)) / m for d, m in gaps),
        "wave_err": max(float(np.max(d)) / m for d, m in gaps),
    }


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers the cell's
    limits name (a cell compares only numbers that separate its sound
    runs from its control and faults): correct when each is at or under
    its limit; a number that is not finite fails, and is reported as
    null."""
    compared = {k: numbers[k] for k in limits}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in compared.items())
    checks = {
        k: {"value": float(v) if np.isfinite(v) else None, "limit": float(limits[k])}
        for k, v in compared.items()
    }
    return bool(ok), checks
