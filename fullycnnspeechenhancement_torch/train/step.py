"""Train and eval steps.

Counterpart of `fullycnnspeechenhancement_tpu/train/step.py`.  One step
takes raw waveform batches and does STFT analysis, the model forward, the
loss, the backward and the optimizer update on the batch's device; the
host only decodes and mixes audio.  Utterance lengths ride in as a
`lengths` vector.  Nothing in a step copies to the host: the loss and the
learning rate stay device scalars until the trainer fetches many steps'
worth at once.

Loss (reference contract, trainer.py:143-153): the sum of squared error
over the padded [B, T, F, 1] block, divided by the *configured* batch
size.  The reference pads each batch to its own max frame count, so pad
frames of shorter utterances do enter its loss and its BN statistics.
Static bucket padding adds slack frames at T >= batch-max that the
reference never sees; the parity step masks them out of the BN moments and
the loss (`batch_max_frame_mask`).  `mask_loss=True` switches to the fully
masked, frame-count-normalised loss with per-utterance BN masking (the
documented corrected mode).

`compute_dtype` (float32 or bfloat16) is the activations' dtype, as in
the JAX package: the params, the BN state, the optimizer's moments and
the STFT analysis stay float32; the model's input is cast to it and its
prediction back to float32 before the loss, so the params receive float32
gradients through the casts' backward.  The eval step's fused branch runs
the float32 stack kernel whatever `compute_dtype` says, as JAX's does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from fullycnnspeechenhancement_torch.config import Config
from fullycnnspeechenhancement_torch.dsp.features import SpectrogramExtractor
from fullycnnspeechenhancement_torch.device import resolve_device
from fullycnnspeechenhancement_torch.models.rced import ModelDef
from fullycnnspeechenhancement_torch.train.optim import (
    TFAdamState,
    noam_schedule,
    tf_adam_init,
    tf_adam_update,
)


class TrainState(NamedTuple):
    params: dict  # leaf tensors with requires_grad, updated in place
    bn_state: dict
    opt_state: TFAdamState
    step: torch.Tensor  # 0-dim int64 on the params' device


class Batch(NamedTuple):
    """Raw-waveform batch: the device does the DSP.

    Waveforms are float32, or int16 when the loader ships
    `int16_transport` batches: then `wav_scale` carries the [B]
    per-utterance peak normalization and the step rebuilds the waveform
    on the device (`_as_wav`)."""

    mix_wav: torch.Tensor  # [B, L] float32 or int16, zero-padded
    clean_wav: torch.Tensor  # [B, L]
    lengths: torch.Tensor  # [B] int32 sample counts
    wav_scale: Optional[torch.Tensor] = None  # [B] float32, int16 mode only


def _as_wav(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """int16 transport -> float32 waveform; float32 passes through."""
    if not x.dtype.is_floating_point:
        wav = x.to(torch.float32) / 32768.0
        return wav if scale is None else wav * scale[:, None]
    return x


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(config: Config) -> torch.dtype:
    """The activations' dtype named by `model.compute_dtype`."""
    name = config.model.compute_dtype
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={name}: one of {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def create_train_state(
    config: Config,
    model: ModelDef,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> TrainState:
    """Fresh state on `device` (the card unless the caller asks for the
    CPU): Glorot init drawn from `generator` (a CPU generator; default
    seeded with `config.train.seed`), zero Adam moments, step 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(config.train.seed)
    params, bn_state = model.init(generator, device=dev)
    return state_from_tensors(params, bn_state)


def state_from_tensors(params, bn_state, opt_state=None, step=None) -> TrainState:
    """A TrainState around existing tensors: params become leaves that
    require grad; missing optimizer state and step start at zero."""
    for p in params.values():
        for v in p.values():
            v.requires_grad_(True)
    if opt_state is None:
        opt_state = tf_adam_init(params)
    if step is None:
        step = opt_state.count.clone()
    return TrainState(params, bn_state, opt_state, step)


def spectral_l2_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    batch_size: int,
    mask: Optional[torch.Tensor] = None,
    normalize_mask: bool = False,
    reduce=None,
) -> torch.Tensor:
    """sum((target - pred)^2) / configured_batch_size (trainer.py:146-147).

    `mask` ([B, T] or [1, T]) restricts the error to masked frames.  The
    parity default passes the batch-max mask unnormalized;
    `normalize_mask=True` also divides by the real-frame fraction (the
    corrected `mask_loss` mode).  Under data parallelism the inputs are
    this rank's rows, the result is its share of the global loss, and
    `reduce` (a sum over the ranks) makes the real-frame fraction the
    global batch's."""
    sq = torch.square(target - pred)
    if mask is None:
        return sq.sum() / batch_size
    m = mask[:, :, None, None]
    total = (sq * m).sum()
    if not normalize_mask:
        return total / batch_size
    if reduce is None:
        frac = m.mean()
    else:
        real, count = reduce(torch.stack([m.sum(), m.new_tensor(m.numel())]))
        frac = real / count
    return total / (batch_size * torch.clamp(frac, min=1e-8))


def _model_forward(config: Config, model: ModelDef):
    """Forward fn honouring `model.blocked_compute` (the freq-to-depth
    form, models/blocked.py) and `model.dw_pallas` (its dW kernel)."""
    if config.model.blocked_compute:
        from fullycnnspeechenhancement_torch.models.blocked import apply_blocked

        return functools.partial(
            apply_blocked, model, fb=config.model.blocked_fb, dw_pallas=config.model.dw_pallas
        )
    return model.apply


def make_train_step(config: Config, model: ModelDef, dp=None):
    """-> step(state, batch) -> (state, metrics {"loss", "lr", "step"}),
    each metric a device scalar.  Parameters and moments update in place;
    the returned state holds the new BN statistics and step.

    `dp` (a `parallel.dp.DataParallel`) makes the step one rank's of a
    data-parallel group: `batch` is the rank's rows of the global batch,
    the batch-max frame count, the BN moments and the `mask_loss` mask
    mean are the global batch's, the gradients and the loss metric are
    summed over the ranks before the update.  The global batch
    (`config.train.batch_size`) must divide by the group's size.  The
    multi-step and cached steps built over this step are the same rank's
    (`make_multi_step`, `train.cached_step`)."""
    if dp is not None:
        dp.rows(config.train.batch_size)  # raises unless divisible
    ext = SpectrogramExtractor(config.dsp)
    schedule = noam_schedule(config.train.lr, config.train.warmup_steps)
    batch_size = config.train.batch_size
    mask_loss = config.train.mask_loss
    compute_dtype = compute_dtype_of(config)
    forward = _model_forward(config, model)
    reduce = None if dp is None else dp.sum
    reduce_max = None if dp is None else dp.max

    def train_step(state: TrainState, batch: Batch):
        with torch.no_grad():
            mix_mag = ext(_as_wav(batch.mix_wav, batch.wav_scale), batch.lengths)
            clean_mag = ext(_as_wav(batch.clean_wav, batch.wav_scale), batch.lengths)
            T = mix_mag.shape[1]
            if mask_loss:
                mask = ext.frame_mask(batch.lengths, T)
            else:
                mask = ext.batch_max_frame_mask(batch.lengths, T, reduce_max)
        x = mix_mag[..., None].to(compute_dtype)
        with torch.enable_grad():
            pred, new_bn = forward(
                state.params, state.bn_state, x, is_training=True, frame_mask=mask,
                reduce=reduce,
            )
            loss = spectral_l2_loss(
                pred.to(torch.float32), clean_mag[..., None], batch_size, mask,
                normalize_mask=mask_loss, reduce=reduce,
            )
            names = [(n, k) for n in sorted(state.params) for k in sorted(state.params[n])]
            leaves = [state.params[n][k] for n, k in names]
            flat = torch.autograd.grad(loss, leaves)
        if dp is not None:
            *flat, loss = dp.sum_flat(list(flat) + [loss])
        grads = {}
        for (n, k), g in zip(names, flat):
            grads.setdefault(n, {})[k] = g
        lr = schedule(state.step)
        opt_state = tf_adam_update(state.params, grads, state.opt_state, schedule)
        new_state = TrainState(state.params, new_bn, opt_state, state.step + 1)
        return new_state, {"loss": loss.detach(), "lr": lr, "step": state.step}

    return train_step


def pack_step_metrics(metrics) -> torch.Tensor:
    """Stack the per-step scalar metrics into one [2] tensor (loss, lr), so
    many steps' metrics come to the host in one copy."""
    return torch.stack([metrics["loss"], metrics["lr"]])


def make_multi_step(step_fn):
    """K steps over a batch with leading steps axis:
    (state, Batch of [K, B, ...] tensors) -> (state, packed metrics [K, 2]).
    Any named tuple of [K, ...] tensors with a `lengths` field serves as
    the batch (train/cached_step.py passes its `Meta`); step k gets the
    same tuple of each field's k-th slice.

    The JAX package scans the K steps in one device program; here they are
    a Python loop of K steps whose metrics stay on the device."""

    def multi_step(state: TrainState, batches: Batch):
        packed = []
        for k in range(batches.lengths.shape[0]):
            b = type(batches)(*(None if f is None else f[k] for f in batches))
            state, m = step_fn(state, b)
            packed.append(pack_step_metrics(m))
        return state, torch.stack(packed)

    return multi_step


def make_eval_step(config: Config, model: ModelDef, is_training: bool = False):
    """(params, bn_state, mix_wav, lengths) -> (pred_mag, phase_re, phase_im).

    The standalone tester runs BN in inference mode; the reference's
    in-training validation runs BN in batch-stats mode over the batch-max
    region.  `is_training` selects which.  With `model.fused_inference`
    (and BN in inference mode) the inner layers run in the fused kernel
    (ops/rced_stack.py) in float32, whatever `compute_dtype` says (JAX's
    `make_eval_step` calls its fused forward without a dtype too)."""
    ext = SpectrogramExtractor(config.dsp)
    compute_dtype = compute_dtype_of(config)
    use_fused = config.model.fused_inference and not is_training
    forward = _model_forward(config, model)

    @torch.no_grad()
    def eval_step(params, bn_state, mix_wav, lengths):
        mag, phase_re, phase_im = ext.magnitude_and_phase(mix_wav, lengths)
        if use_fused:
            from fullycnnspeechenhancement_torch.ops.rced_stack import fused_inference_forward

            pred = fused_inference_forward(model, params, bn_state, mag)
            return pred.to(torch.float32), phase_re, phase_im
        x = mag[..., None].to(compute_dtype)
        fmask = ext.batch_max_frame_mask(lengths, mag.shape[1]) if is_training else None
        pred, _ = forward(params, bn_state, x, is_training=is_training, frame_mask=fmask)
        return pred[..., 0].to(torch.float32), phase_re, phase_im

    return eval_step
