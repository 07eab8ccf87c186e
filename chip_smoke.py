#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (written
for an H100) and `nvcc`.  It imports only the port
(`fullycnnspeechenhancement_torch`), never JAX, and in order:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels for sm_90a, one `nvcc` per source, started
     together (`ops/csrc/rced_stack.cu`, `ops/csrc/blocked_dw.cu`,
     `ops/csrc/freq_conv.cu`), and prints their ptxas lines and build
     times; beside them the native host runtime (g++, `runtime/*.cc`:
     decode, resample, mixing, PESQ) and a probe of mma.sync's TF32 rate
     (MMA_RATE_SRC), measured once here and used by phases 7 and 11 (both
     kernels issue mma.sync in 3xTF32);

  The serving path (the fused inference kernel, `rced_stack`):
  3. builds two V2 inference engines at full width from one npz of random
     weights (torch.Generator seed 0, randomised BN state): one with
     `fused_inference=True` (the kernel path), one without (cuDNN layer by
     layer, TF32 off);
  4. serves three requests (1.5 s, 6 s, 30 s: the 2, 8 and 32 s buckets)
     and one wav file through the fused engine, with the kernel's launch
     count set to 0 just before and read just after: it must be 4;
  5. holds each output against the unfused engine's at
     atol = 1e-4 * max|reference|;
  6. holds the kernel against its plain torch version on the card for
     V1/V2/V3 at B=2, T=70 and T=45 (rtol 1e-4, atol 1e-5), and at the
     shapes the requests gave it (rtol 1e-4, atol 1e-5 * max|plain|);
  7. times the kernel, its plain version and the layer-by-layer cuDNN
     inner stack at 64 x 8 s with CUDA events, beside the kernel's 3xTF32
     bound (and the float32 one), the products its m16n8k8 tiles pad in
     and the floor mma.sync's measured rate sets; prints its launch plan;
     then the stages of one 8 s request, and each request's host time and
     device-busy time (from torch.profiler) through both engines;

  The training path (the blocked dW kernel, `blocked_dw`):
  8. writes a corpus (512 speech-like utterances of 6.5-8.0 s, all in the
     512-frame bucket, 8 noise recordings of 30 s, and 64 premixed
     validation utterances of 2-8 s) and an INI with the TPU training
     profile's settings in float32 (V2, batch 64, steps_per_call 8,
     blocked_compute with fb 8, dw_pallas, host loader), 2 epochs,
     `val_manifest_path` and `valid_every_epochs=2`; runs
     `cli.train.main(["--cfg", ini])` with the kernel's launch count set to
     0 just before and read just after: it must be 14 per logged step (16
     steps); every loss finite, both epochs' checkpoints written; the one
     validation pass (after epoch 2, in the fork pool while the CUDA
     context is live) logs `valid_stoi`, `valid_sdr` and `valid_pesq`, and
     neither `valid_pesq_proxy` nor `valid_score_failures`, scores with the
     `p862-native` PESQ, never degrades to threads, and writes the 64
     `_de.wav` files under `<audio_save_path>/1/`; its wall time and
     audio-s/s are logged; the last checkpoint then serves one 6 s request
     through a fused engine;
  9. parity: two trainers from one numpy initial state on the same 4
     batches of 64 x 8 s, with and without `dw_pallas` (cuDNN autograd):
     per-step losses within rtol 1e-3, Adam's moments after each step
     within 1e-3 of their global scale (a comparison of each step's
     gradients), and the params' change over the 4 steps within 0.2 of
     its norm;
 10. holds the kernel against its plain version for V2's 14 layer shapes
     at B*T = 32,768 and at B=3, T=37 (rtol 1e-4, atol 1e-4 *
     max|plain|), and the gradients through `blocked_freq_conv` and
     through the blocked model against autograd of the raw conv;
 11. times the kernel over the 14 layers of one step, its plain version
     and `torch.nn.grad.conv2d_weight` (cuDNN backward-filter, the
     yardstick) with CUDA events, beside the kernel's 3xTF32 bound (and
     the float32 one), the products its launch plan pads in, and the
     floor set by mma.sync's TF32 rate on this card (phase 2); then the
     whole train step
     with dw_pallas on and off, the device-busy time of one
     steps_per_call=8 dispatch, and which ops launch cuDNN's layout
     conversions in one train step;

  The kernel-probe path (the frequency-conv kernels, `freq_conv` and
  `freq_conv_stack`):
 12. runs every probe of `fullycnnspeechenhancement_torch.probes` (the
     counterparts of `benchmarks/micro_pallas_*.py`) once at its script's
     shapes, with both launch counts set to 0 just before and read just
     after: 12 `freq_conv` and 5 `freq_conv_stack` launches; holds each
     output against its plain version on the card (rtol 1e-5, atol 1e-5 *
     max|plain|) and, for the zero-boundary probes, cuDNN's F.conv2d; times
     each (kernel, plain and library device time per call from
     torch.profiler, and the kernel's and F.conv2d's call times back to
     back with CUDA events) beside its bounds: for both kernels (3xTF32
     `mma.sync`) the 3xTF32 bound, the float32 one, and the floor that
     mma.sync's measured rate sets on the products its launch plan
     computes, with the padded product ratio; prints each launch plan
     (`freq_conv`: grid, blocks per SM, tile, warps, m16 tiles skipped;
     `freq_conv_stack`: cluster, grid, n8 and m16 tiles, warps, K split,
     blocks per SM and clusters the card holds); then runs the probes'
     CLI once;
 13. holds `freq_conv` against its plain version and F.conv2d on V2's 14
     inner layer shapes at 64 x 8 s (NCHW activations, weights through
     `params_from_numpy`) and times each against both, its bounds and
     floor, with its launch plan, and under two other plans (one block
     per row; one m16 tile a warp); logs the 14-layer sums beside
     `rced_stack` and the cuDNN stack of phase 7;
 14. times `freq_conv_stack` against `depth` launches of `freq_conv` and
     its plain version at roll2's shape, depths 1, 4, 8 and 16, after
     holding all three equal, beside its 3xTF32 bound, the mma.sync floor
     of its launch plan and the padded product ratio; and, at depth 16,
     under one other plan (one block a frame);

  The evaluation path (`cli/test`, the fused stack kernel again):
 15. writes a test set (256 speech-like utterances of 2-8 s and a noise
     manifest) and a test INI with the settings of
     `work/aishell_1/cfg/fully_cnn_test.cfg` (batch 2, snr 0, on-the-fly
     mixing) for V2 at full width and phase 8's last checkpoint; runs
     `cli.test.main` with `fused_inference=True` and without, each with
     `rced_stack`'s launch count set to 0 just before and read just after:
     one launch per evaluation batch, and none without; logs each run's
     wall time and audio-s/s, then runs it again under torch.profiler for
     its device-busy share alone; holds the kernel against its plain
     version on the card at every (B, T) the fused run gave it, on the
     first input of each shape (rtol 1e-4, atol 1e-5 * max|plain|); the
     two runs' printed averages within STOI 1e-4, SDR 1e-2 dB and PESQ
     1e-2 (the differences are logged), PESQ `p862-native`, 256 `_de.wav`
     files each;
 16. prints a `kernels` JSON line (four kernels; `rced_stack`'s launches
     are the serving path's and the evaluation path's, each also by
     path; its max_abs_err covers phases 6, 7 and 15), the card line
     again, and last the line {"ok": true, "device": {...}}.

Each phase prints its wall time.  Any failed phase raises, so the script
exits non-zero and prints no last line.  Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): float32 without tensor cores, TF32
# on them.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
MAIN_TOL = 1e-4  # engine outputs: atol = MAIN_TOL * max|reference|
SR = 8000
# The training profile: batch 64 of 8 s utterances (the 512-frame bucket),
# 8 batches per epoch, so one steps_per_call=8 dispatch per epoch.
B_TRAIN = 64
N_UTTS = 8 * B_TRAIN
T_BUCKET = 512
EPOCHS = 2
# Validation once, after the last epoch, on N_VAL premixed utterances.
VALID_EVERY = 2
N_VAL = 64
PARITY_STEPS = 4
# dw_pallas on against off: Adam moments against their global scale after
# each step, and the params' change over the steps against its norm.
PARITY_MOMENT_TOL = 1e-3
PARITY_UPDATE_TOL = 0.2
DW_TOL = 1e-4  # blocked_dw against plain: rtol, and atol = DW_TOL * max|plain|
# freq_conv / freq_conv_stack against plain (and cuDNN): rtol, and atol =
# PROBE_TOL * max|plain|; float32 sums of up to 352 terms in another order
# (freq_conv's products in 3xTF32, each within about 2^-21 of float32's).
PROBE_TOL = 1e-5


def phase(name: str, t0: float) -> None:
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s wall")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of `fn` in ms over `reps` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_close(name, got, ref, rtol, atol) -> float:
    """Raise unless |got - ref| <= atol + rtol*|ref| everywhere; returns
    the largest absolute difference."""
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off, max abs err {err.max().item():.3e} "
            f"(rtol {rtol}, atol {atol:.3e})"
        )
    return err.max().item()


def randomized_bn(bn, seed):
    """BN statistics moved off their init: means shifted by U(-0.5, 0.5),
    variances scaled by U(1, 2).  Centred, so the ReLUs stay alive: a
    shift of U(0, 1) left V2's inner stack at 0 everywhere on phase 7's
    inputs, and every comparison of it vacuous."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in bn.items():
        shift = rng.random(v["mean"].shape, dtype=np.float32) - 0.5
        mean = v["mean"] + torch.as_tensor(shift).to(v["mean"].device)
        var = v["var"] * (1 + torch.as_tensor(rng.random(v["var"].shape, dtype=np.float32)).to(v["var"].device))
        out[k] = {"mean": mean, "var": var}
    return out


def speech_like(rng, seconds, sr=8000):
    """Harmonics of a wandering pitch under a syllable-rate envelope, plus
    white noise."""
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 12))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.5 * t) ** 2
    sig = 0.15 * env * voiced + 0.05 * rng.standard_normal(len(t))
    return sig.astype(np.float32)


def inner_stack_cudnn(folded, x):
    """The inner layers one cuDNN conv at a time, on the folded weights
    (`fold_bn_inference`'s list, whose first entry is layer 1 and whose
    output `x` is): the yardstick beside the kernel."""
    from fullycnnspeechenhancement_torch.models.blocks import conv2d_same

    taps = {folded[0][0].name: x}
    h = x
    for spec, w, b in folded[1:-1]:
        y = conv2d_same(h, w, b)
        if spec.skip_from is not None:
            y = y + taps[spec.skip_from]
        if spec.use_act:
            y = torch.relu(y)
        if spec.add_from is not None:
            y = y + taps[spec.add_from]
        taps[spec.name] = y
        h = y
    return h


def device_busy_ms(fn, reps: int, top: int = 0):
    """(host ms, device-busy ms, device events) per call of `fn` over
    `reps` calls after one warm-up, under torch.profiler: busy is the
    summed duration of the device's own events (kernels, copies, memsets;
    one stream, so they do not overlap), host time the clock around the
    calls up to a synchronize.  Busy is None when the profiler saw no
    device event.  With `top`, logs the `top` device events by summed
    time per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return host_ms, None, 0
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3 / reps
    by_name = {}
    for e in device:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"  device {us / 1e3 / reps:9.3f} ms ({100 * us / 1e3 / reps / busy_ms:4.1f}%) "
            f"in {n / reps:5.0f} events: {name[:100]}")
    return host_ms, busy_ms, len(device) / reps


def layout_conversions(fn, names=("nchwToNhwc", "nhwcToNchw"), top: int = 12):
    """Profile one call of `fn` (after one warm-up) and attribute the
    device kernels whose names contain one of `names` (cuDNN's layout
    conversions) to the op that launched them, its first input's shape,
    and the autograd node (or outermost op) around it.  Logs the `top`
    sources by device time; returns (kernels, ms) per call, or None when
    the profiler linked no kernel to an op."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    tally, linked = {}, False
    for e in prof.events():
        linked = linked or bool(e.kernels)
        hits = [k for k in e.kernels if any(n in k.name for n in names)]
        if not hits:
            continue
        outer, node = e, None
        while outer.cpu_parent is not None:
            outer = outer.cpu_parent
            if node is None and outer.name.startswith("autograd::engine::evaluate_function"):
                node = outer.name.split(": ", 1)[-1]
        shape = list(e.input_shapes[0]) if e.input_shapes else None
        key = (node or outer.name, e.name, str(shape))
        n, us = tally.get(key, (0, 0.0))
        tally[key] = (n + len(hits), us + sum(k.duration for k in hits))
    if not linked:
        return None
    count = sum(n for n, _ in tally.values())
    ms = sum(us for _, us in tally.values()) / 1e3
    for (node, op, shape), (n, us) in sorted(tally.items(), key=lambda kv: -kv[1][1])[:top]:
        log(f"  layout conversions: {n} kernels, {us / 1e3:.3f} ms from {op} on {shape} in {node}")
    return count, ms


def stack_work(packed, B, T):
    """(FLOP, bytes) the inner stack needs on [B, c_in, T, 129]: products
    only against real inputs (tap j of a layer with kw taps meets
    129 - |j - lo| bins; the rest fall on the zero halo, as `conv_work`
    counts them), each input read once, each output and weight moved
    once."""
    macs = 0
    for lay in packed.layers:
        lo = (lay.kw - 1) // 2
        macs += lay.cin * lay.cout * sum(129 - abs(j - lo) for j in range(lay.kw))
    flop = 2.0 * B * T * macs
    nbytes = 4.0 * B * T * 129 * (packed.c_in + packed.c_out) + 4.0 * packed.weights.numel()
    return flop, nbytes


def run_serving(dev, tmp: str, mma_rate: float) -> dict:
    """Phases 3-7: the serving path through the fused kernel.  Returns the
    `rced_stack` entry of the `kernels` line."""
    from fullycnnspeechenhancement_torch import Config, ModelConfig
    from fullycnnspeechenhancement_torch.data.audio_io import read_wav, write_wav
    from fullycnnspeechenhancement_torch.infer import InferenceEngine
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.models.blocks import conv2d_same
    from fullycnnspeechenhancement_torch.ops import rced_stack
    from fullycnnspeechenhancement_torch.train.checkpoint import export_params_npz

    # -- 3. engines ----------------------------------------------------
    model = get_model("FullyCNNV2")
    params, bn = model.init(torch.Generator().manual_seed(0), device=dev)
    bn = randomized_bn(bn, seed=0)
    npz = os.path.join(tmp, "v2.npz")
    export_params_npz(npz, params, bn)
    fused = InferenceEngine(
        Config(model=ModelConfig(net_work="FullyCNNV2", fused_inference=True)),
        checkpoint=npz, device="cuda",
    )
    plain = InferenceEngine(
        Config(model=ModelConfig(net_work="FullyCNNV2")), checkpoint=npz, device="cuda"
    )

    # -- 4. the main path ------------------------------------------------
    rng = np.random.default_rng(0)
    requests = [speech_like(rng, s) for s in (1.5, 6.0, 30.0)]
    wav_in = os.path.join(tmp, "noisy.wav")
    write_wav(wav_in, speech_like(rng, 3.0), 8000)
    rced_stack.launches = 0
    outs = []
    for sig in requests:
        t0 = time.perf_counter()
        outs.append(fused.denoise_array(sig))
        log(f"request {len(sig) / 8000:.1f} s: {1e3 * (time.perf_counter() - t0):.1f} ms (first call)")
    out_path = fused.denoise(wav_in, save_path=os.path.join(tmp, "fused"))
    launches = rced_stack.launches
    log(f"main path: rced_stack launches {launches}")
    if launches != 4:
        raise AssertionError(f"rced_stack launched {launches} times on the main path, expected 4")

    # -- 5. outputs against the unfused engine ---------------------------
    for sig, got in zip(requests, outs):
        ref = torch.as_tensor(plain.denoise_array(sig))
        got = torch.as_tensor(got)
        if got.shape != (len(sig),):
            raise AssertionError(f"output length {got.shape} for {len(sig)} samples")
        err = check_close(f"engine {len(sig)}", got, ref, 0.0, MAIN_TOL * ref.abs().max().item())
        log(f"engine {len(sig) / 8000:.1f} s: fused vs cuDNN max abs err {err:.3e} "
            f"(max|ref| {ref.abs().max().item():.3e})")
    ref_path = plain.denoise(wav_in, save_path=os.path.join(tmp, "plain"))
    got_w, _ = read_wav(out_path)
    ref_w, _ = read_wav(ref_path)
    src, _ = read_wav(wav_in)
    if len(got_w) != len(src):
        raise AssertionError(f"{out_path}: {len(got_w)} samples, input has {len(src)}")
    # one int16 step on top: both files are rounded to 16-bit PCM
    err = check_close("file", torch.as_tensor(got_w), torch.as_tensor(ref_w), 0.0,
                      MAIN_TOL * np.abs(ref_w).max() + 1.0 / 32767)
    log(f"file {os.path.basename(out_path)}: {len(got_w)} samples, max abs err {err:.3e}")

    # -- 6. kernel against its plain version -----------------------------
    max_err = 0.0
    for name in ("FullyCNN", "FullyCNNV2", "FullyCNNV3"):
        m = get_model(name)
        p, s = m.init(torch.Generator().manual_seed(1), device=dev)
        s = randomized_bn(s, seed=2)
        pk = rced_stack.pack_inference_stack(m, p, s)
        for T in (70, 45):
            mag = torch.as_tensor(np.random.default_rng(T).random((2, T, 129), dtype=np.float32), device=dev)
            y1 = torch.relu(conv2d_same(mag[:, None], *pk.first[1:])).contiguous()
            e = check_close(f"{name} T={T}", rced_stack.stack_forward(pk, y1),
                            rced_stack.stack_forward_plain(pk, y1), 1e-4, 1e-5)
            ref_apply = m.apply(p, s, mag[..., None])[0][..., 0]
            check_close(f"{name} T={T} fused vs apply",
                        rced_stack.fused_inference_forward(m, p, s, mag, packed=pk),
                        ref_apply, 1e-4, 1e-5)
            max_err = max(max_err, e)
            log(f"kernel {name} B=2 T={T}: max abs err vs plain {e:.3e}")
    pk = fused._packed
    for n in sorted({len(x) for x in requests} | {len(src)}):
        T = fused.ext.num_frames(fused._pad_len(n))
        mag = torch.as_tensor(rng.random((1, T, 129), dtype=np.float32) * 10, device=dev)
        y1 = torch.relu(conv2d_same(mag[:, None], *pk.first[1:])).contiguous()
        ref = rced_stack.stack_forward_plain(pk, y1)
        e = check_close(f"V2 B=1 T={T}", rced_stack.stack_forward(pk, y1), ref,
                        1e-4, 1e-5 * ref.abs().max().item())
        max_err = max(max_err, e)
        log(f"kernel V2 B=1 T={T}: max abs err vs plain {e:.3e}")

    # -- 7. timings --------------------------------------------------------
    B, T = 64, fused.ext.num_frames(8 * 8000)
    mag = torch.as_tensor(np.random.default_rng(7).random((B, T, 129), dtype=np.float32), device=dev)
    y1 = torch.relu(conv2d_same(mag[:, None], *pk.first[1:])).contiguous()
    got = rced_stack.stack_forward(pk, y1)
    ref = rced_stack.stack_forward_plain(pk, y1)
    e = check_close(f"V2 B={B} T={T}", got, ref, 1e-4, 1e-5 * ref.abs().max().item())
    max_err = max(max_err, e)
    folded = rced_stack.fold_bn_inference(fused.model, fused.params, fused.bn_state)
    check_close(f"V2 B={B} T={T} cuDNN stack", inner_stack_cudnn(folded, y1), ref,
                1e-4, 1e-5 * ref.abs().max().item())
    del got, ref
    kernel_ms = cuda_ms(lambda: rced_stack.stack_forward(pk, y1), reps=20)
    plain_ms = cuda_ms(lambda: rced_stack.stack_forward_plain(pk, y1), reps=3, warmup=1)
    cudnn_ms = cuda_ms(lambda: inner_stack_cudnn(folded, y1), reps=10)
    kernel_ms_2 = cuda_ms(lambda: rced_stack.stack_forward(pk, y1), reps=20)
    flop, nbytes = stack_work(pk, B, T)
    # 3xTF32 issues three TF32 products for each float32 one
    t_ops, t_simt = 3 * flop / PEAK_TF32_FLOPS * 1e3, flop / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    plan = rced_stack.launch_plan(pk, rced_stack.card_blocks_per_sm(pk.smem_floats * 4, dev))
    padded = plan.padded_product_ratio
    floor_ms = 3 * flop * padded / (mma_rate * 1e12) * 1e3
    log(f"timing V2 inner stack at {B} x 8 s (T={T}): kernel {kernel_ms:.3f} / {kernel_ms_2:.3f} ms, "
        f"plain {plain_ms:.3f} ms, cuDNN layer by layer {cudnn_ms:.3f} ms")
    log(f"bound: {flop:.4e} FLOP -> {t_ops:.3f} ms in 3xTF32 at 495 TFLOP/s ({t_simt:.3f} ms in float32 "
        f"at 67 TFLOP/s); {nbytes:.4e} B -> {t_bytes:.3f} ms at 3.35 TB/s; kernel at "
        f"{100 * bound_ms / kernel_ms:.1f}% of the 3xTF32 bound, {100 * t_simt / kernel_ms:.1f}% of the "
        f"float32 one")
    log(f"m16n8k8 tiles pad the products {padded:.4f}x; at mma.sync's {mma_rate:.1f} TFLOP/s the floor is "
        f"{floor_ms:.3f} ms (kernel at {100 * floor_ms / kernel_ms:.1f}% of it)")
    log(f"launch plan (one block per frame, {B * T} blocks at {B} x 8 s): {plan._asdict()}")

    # stages of one 8 s request, fused engine
    sig = requests[1]
    n = len(sig)
    wav = torch.zeros(1, fused._pad_len(n), device=dev)
    wav[0, :n] = torch.as_tensor(sig, device=dev)
    lengths = torch.tensor([n], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        mag1, pre, pim = fused.ext.magnitude_and_phase(wav, lengths)
        y1r = torch.relu(conv2d_same(mag1[:, None], *pk.first[1:])).contiguous()
        zr = rced_stack.stack_forward(pk, y1r)
        pred = conv2d_same(zr, *pk.last[1:])[:, 0]
        stages = {
            "analysis": cuda_ms(lambda: fused.ext.magnitude_and_phase(wav, lengths), 20),
            "layer1_cudnn": cuda_ms(lambda: conv2d_same(mag1[:, None], *pk.first[1:]), 20),
            "inner_kernel": cuda_ms(lambda: rced_stack.stack_forward(pk, y1r), 20),
            "last_cudnn": cuda_ms(lambda: conv2d_same(zr, *pk.last[1:]), 20),
            "rebuild": cuda_ms(lambda: fused.reb(pred, pre, pim), 20),
            "inner_cudnn_layerwise": cuda_ms(lambda: inner_stack_cudnn(folded, y1r), 20),
        }
    log("stages of one 8 s request (ms): " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    # whole requests, untraced (host clock per call; each call ends in a
    # copy to the host), then traced for the device-busy time
    for label, eng in (("fused", fused), ("cudnn", plain)):
        for sig in requests:
            eng.denoise_array(sig)
            times = []
            for _ in range(40):
                t0 = time.perf_counter()
                eng.denoise_array(sig)
                times.append((time.perf_counter() - t0) * 1e3)
            med, p75, mean = np.median(times), np.percentile(times, 75), np.mean(times)
            traced_ms, busy_ms, events = device_busy_ms(lambda: eng.denoise_array(sig), reps=20)
            busy = "device busy not measured" if busy_ms is None else (
                f"device busy {busy_ms:.3f} ms in {events:.0f} device events, "
                f"idle share {1 - busy_ms / mean:.3f}")
            log(f"request {label} {len(sig) / 8000:.1f} s: host ms median {med:.3f} p75 {p75:.3f} "
                f"mean {mean:.3f} (n=40), {len(sig) / 8000 / med * 1e3:.1f} audio-s/s; "
                f"traced {traced_ms:.3f} ms, {busy}")

    return {
        "name": "rced_stack",
        "route": "cuda",
        "source": "fullycnnspeechenhancement_torch/ops/csrc/rced_stack.cu",
        "replaces": "fullycnnspeechenhancement_tpu/ops/pallas_rced.py:135",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations, 3xTF32 tensor cores" if t_ops >= t_bytes else "bytes",
        # No single PyTorch call computes the stack; the cuDNN
        # layer-by-layer stack (14 convs plus adds) is its own key.
        "library_ms": None,
        "cudnn_stack_ms": cudnn_ms,
        "mma_sync_tf32_tflops": mma_rate,
        # computed from this run's inputs and the rate above, not timed
        "derived": {
            "bound_fp32_simt_ms": max(t_simt, t_bytes),
            "padded_product_ratio": padded,
            "mma_sync_floor_ms": floor_ms,
        },
    }


# -- the training path ---------------------------------------------------


def noise_like(rng, seconds, sr=SR):
    """White noise through a one-pole filter of random colour, under a slow
    level wander."""
    from scipy.signal import lfilter

    n = int(seconds * sr)
    colored = lfilter([1.0], [1.0, -rng.uniform(-0.9, 0.95)], rng.standard_normal(n))
    colored *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.05, 0.3) * np.arange(n) / sr)
    return (0.1 * colored / np.abs(colored).max()).astype(np.float32)


def write_corpus(root: str, rng) -> dict:
    """N_UTTS speech-like clean utterances of 6.5-8.0 s (all in the
    512-frame bucket), 8 noise recordings of 30 s, N_VAL premixed
    validation utterances of 2-8 s (speech-like plus coloured noise at
    0 dB), and their manifests."""
    from fullycnnspeechenhancement_torch.data import write_manifest, write_wav

    os.makedirs(root, exist_ok=True)
    clean, noise, val = [], [], []
    for i in range(N_UTTS):
        sig = speech_like(rng, rng.uniform(6.5, 8.0))
        path = os.path.join(root, f"clean_{i}.wav")
        write_wav(path, sig, SR)
        clean.append({"audio_filepath": path, "duration": len(sig) / SR})
    for i in range(8):
        sig = noise_like(rng, 30.0)
        path = os.path.join(root, f"noise_{i}.wav")
        write_wav(path, sig, SR)
        noise.append({"audio_filepath": path, "duration": len(sig) / SR})
    for i in range(N_VAL):
        sig = speech_like(rng, rng.uniform(2.0, 8.0))
        nz = noise_like(rng, len(sig) / SR)
        mix = sig + nz * np.sqrt((sig ** 2).sum() / (nz ** 2).sum())
        c, m = os.path.join(root, f"val_{i}.wav"), os.path.join(root, f"val_{i}_in.wav")
        write_wav(c, sig, SR)
        write_wav(m, mix, SR)
        val.append({"clean_audio_filepath": c, "mix_audio_filepath": m, "duration": len(sig) / SR})
    paths = {k: os.path.join(root, f"train.{k}") for k in ("clean", "noise", "val")}
    write_manifest(paths["clean"], clean)
    write_manifest(paths["noise"], noise)
    write_manifest(paths["val"], val)
    paths["val_seconds"] = sum(e["duration"] for e in val)
    return paths


def write_train_ini(path: str, root: str, corpus: dict, dw_pallas: bool = True,
                    base_checkpoint: str = "") -> str:
    """The TPU training profile (work/aishell_1/cfg/fully_cnn_train_tpu.cfg)
    in float32, with dw_pallas, the host loader, EPOCHS epochs, validation
    every VALID_EVERY epochs on the premixed validation manifest, and paths
    under `root`."""
    with open(path, "w") as f:
        f.write(
            "[training]\n"
            f"epochs={EPOCHS}\nbatch_size={B_TRAIN}\nlr=0.0015\nwarmup_steps=10000\n"
            f"continue_train={not base_checkpoint}\n"
            f"checkpoints_path={root}/checkpoints\nbase_checkpoint_file={base_checkpoint}\n"
            f"num_iter_print=50\nlog_dir={root}/log\nsteps_per_call=8\n"
            f"valid_every_epochs={VALID_EVERY}\n"
            "[model]\nnet_arch=RCED\nnet_work=FullyCNNV2\ncompute_dtype=float32\n"
            f"blocked_compute=True\nblocked_fb=8\ndw_pallas={dw_pallas}\n"
            f"[data]\ntrain_manifest_path={corpus['clean']}\n"
            f"train_noise_manifest={corpus['noise']}\n"
            f"val_manifest_path={corpus['val']}\naudio_save_path={root}/denoise\n"
            "snr=0\nsample_rate=8000\nwindow_ms=32\nstride_ms=16\nuse_device_cache=False\n"
        )
    return path


def numpy_init(model, seed: int):
    """(params, bn_state) of `model` from numpy: Glorot-range OIHW kernels,
    small biases and BN affine, randomised BN statistics."""
    rng = np.random.default_rng(seed)
    params, bn, ch = {}, {}, 1
    for spec in model.layers:
        kh, kw = spec.kernel
        lim = np.sqrt(6.0 / (kh * kw * (ch + spec.out_ch)))
        p = {"w": rng.uniform(-lim, lim, (spec.out_ch, ch, kh, kw)),
             "b": 0.1 * rng.standard_normal(spec.out_ch)}
        if spec.use_norm:
            p["gamma"] = 1 + 0.1 * rng.standard_normal(spec.out_ch)
            p["beta"] = 0.1 * rng.standard_normal(spec.out_ch)
            bn[spec.name] = {"mean": rng.random(spec.out_ch), "var": 1 + rng.random(spec.out_ch)}
        params[spec.name] = p
        ch = spec.out_ch
    as_t = lambda d: {k: torch.tensor(v, dtype=torch.float32) for k, v in d.items()}  # noqa: E731
    return {n: as_t(p) for n, p in params.items()}, {n: as_t(s) for n, s in bn.items()}


def flat_leaves(tree):
    """{(layer, leaf): float64 host array} of a params-shaped tree."""
    return {(n, k): v.detach().double().cpu().numpy() for n, d in tree.items() for k, v in d.items()}


def global_err(got, ref):
    """max |got - ref| over all leaves over max |ref| over all leaves: a
    global scale, because the biases under training-mode BN have gradients
    that cancel analytically and a per-leaf scale would blow their rounding
    noise up."""
    scale = max(np.abs(v).max() for v in ref.values())
    return max(np.abs(got[k] - ref[k]).max() for k in ref) / scale


def update_err(after, ref_after, before):
    """|d - d_ref| / |d_ref| for the params' change d = after - before, all
    leaves as one vector: 1 for steps that leave the params where they
    were, 2 for a sign-flipped update."""
    keys = sorted(ref_after)
    d = np.concatenate([(after[k] - before[k]).ravel() for k in keys])
    d_ref = np.concatenate([(ref_after[k] - before[k]).ravel() for k in keys])
    return float(np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref))


def dw_layer_shapes(model, fb: int = 8):
    """(name, Ci, Co) of the model's inner (1, k) layers in blocked form."""
    shapes, cin = [], model.layers[0].out_ch
    for spec in model.layers[1:-1]:
        shapes.append((spec.name, fb * cin, fb * spec.out_ch))
        cin = spec.out_ch
    return shapes


def dw_work(shapes, rows: int, nb: int, kb: int, dc: int):
    """(FLOP, bytes) the dW contractions of `shapes` over `rows` rows need:
    tap d pairs only the NB - |d - dc| blocks whose shifted z block is real
    (the others meet the zero halo), z and dy are read once and dW written
    once, per layer."""
    pairs = sum(max(0, nb - abs(d - dc)) for d in range(kb))
    flop = sum(2.0 * rows * pairs * ci * co for _, ci, co in shapes)
    nbytes = sum(4.0 * (rows * nb * (ci + co) + kb * ci * co) for _, ci, co in shapes)
    return flop, nbytes


def run_training(dev, tmp: str, rate: float):
    """Phases 8-11: the training path through the dW kernel, with one
    validation pass.  Returns the `blocked_dw` entry of the `kernels` line
    and the last checkpoint."""
    from fullycnnspeechenhancement_torch import Config, ModelConfig, load_ini_config
    from fullycnnspeechenhancement_torch.cli import train as train_cli
    from fullycnnspeechenhancement_torch.infer import InferenceEngine
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.models.blocked import _block_index_map, apply_blocked
    from fullycnnspeechenhancement_torch.ops import blocked_dw
    from fullycnnspeechenhancement_torch.train.checkpoint import export_params_npz
    from fullycnnspeechenhancement_torch.eval.metrics import PESQ
    from fullycnnspeechenhancement_torch.train import trainer as trainer_mod
    from fullycnnspeechenhancement_torch.train.trainer import Trainer

    rng = np.random.default_rng(1)
    model = get_model("FullyCNNV2")
    # the inner (1, k) layers, whose dW the kernel computes: 14 for V2
    n_dw = sum(1 for spec in model.layers if spec.kernel[0] == 1 and spec.kernel[1] < 129)

    # -- 8. the training main path ------------------------------------------
    t0 = time.perf_counter()
    corpus = write_corpus(os.path.join(tmp, "corpus"), rng)
    log(f"corpus: {N_UTTS} utterances, 8 noise recordings and {N_VAL} validation utterances "
        f"({corpus['val_seconds']:.1f} s) in {time.perf_counter() - t0:.1f} s")
    root = os.path.join(tmp, "train")
    ini = write_train_ini(os.path.join(tmp, "train.cfg"), root, corpus)
    validations = []
    real_validate = trainer_mod.Trainer.validate

    def timed_validate(self, loader, epoch, log=None):
        v0 = time.perf_counter()
        out = real_validate(self, loader, epoch, log)
        validations.append((epoch, time.perf_counter() - v0, out))
        return out

    t0 = time.perf_counter()
    blocked_dw.launches = 0
    trainer_mod.Trainer.validate = timed_validate
    try:
        trainer = train_cli.main(["--cfg", ini])
    finally:
        trainer_mod.Trainer.validate = real_validate
    torch.cuda.synchronize()
    launches = blocked_dw.launches
    main_s = time.perf_counter() - t0
    run_dir = trainer.ckpt.dir
    with open(os.path.join(root, "log", "scalars_RCED_FullyCNNV2.jsonl")) as f:
        all_rows = [json.loads(line) for line in f]
    rows = [r for r in all_rows if "loss" in r]
    valid = [r for r in all_rows if any(k.startswith("valid_") for k in r)]
    steps = len(rows)
    log(f"training main path: {steps} steps in {main_s:.1f} s, blocked_dw launches {launches}, "
        f"losses {[round(r['loss'], 3) for r in rows]}")
    if steps != EPOCHS * N_UTTS // B_TRAIN or [r["step"] for r in rows] != list(range(steps)):
        raise AssertionError(f"logged steps {[r['step'] for r in rows]}, expected {EPOCHS * N_UTTS // B_TRAIN}")
    if launches != n_dw * steps:
        raise AssertionError(f"blocked_dw launched {launches} times in {steps} steps, expected {n_dw * steps}")
    if not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError("a logged loss is not finite")
    files = sorted(os.listdir(run_dir))
    if files != [f"epoch_{e}.pt" for e in range(EPOCHS)]:
        raise AssertionError(f"checkpoints {files} in {run_dir}")
    # the validation pass: once, after epoch VALID_EVERY - 1, in the fork
    # pool (the CUDA context live in the parent), with the native PESQ
    log(f"validation scalars: {valid}")
    epochs_validated = [e for e, _, _ in validations]
    if epochs_validated != [VALID_EVERY - 1] or len(valid) != 1 or valid[0]["epoch"] != VALID_EVERY - 1:
        raise AssertionError(f"validated after epochs {epochs_validated}, scalars {valid}")
    keys = sorted(k for k in valid[0] if k != "epoch")
    if keys != ["valid_pesq", "valid_sdr", "valid_stoi"]:
        raise AssertionError(f"validation scalars {keys}: want pesq, sdr and stoi, no proxy, no failures")
    if not all(np.isfinite(valid[0][k]) for k in keys):
        raise AssertionError(f"a validation score is not finite: {valid[0]}")
    if trainer.evaluator.scoring != "process":
        raise AssertionError(f"validation scored in {trainer.evaluator.scoring}: the fork pool broke")
    implementation = PESQ(sr=SR).implementation
    if implementation != "p862-native":
        raise AssertionError(f"PESQ implementation {implementation}, expected p862-native")
    de = [f for f in os.listdir(os.path.join(root, "denoise", str(VALID_EVERY - 1))) if f.endswith("_de.wav")]
    if len(de) != N_VAL:
        raise AssertionError(f"{len(de)} _de.wav files under denoise/{VALID_EVERY - 1}, expected {N_VAL}")
    val_s = validations[0][1]
    log(f"validation pass: {N_VAL} utterances ({corpus['val_seconds']:.1f} audio-s) in {val_s:.2f} s, "
        f"{corpus['val_seconds'] / val_s:.1f} audio-s/s; PESQ {implementation}; {len(de)} _de.wav files")
    last = os.path.join(run_dir, f"epoch_{EPOCHS - 1}.pt")
    engines = [
        InferenceEngine(Config(model=ModelConfig(net_work="FullyCNNV2", fused_inference=fused)),
                        checkpoint=last, device="cuda")
        for fused in (True, False)
    ]
    sig = speech_like(rng, 6.0)
    out, ref = (torch.as_tensor(e.denoise_array(sig)) for e in engines)
    err = check_close("served from the checkpoint", out, ref, 0.0, MAIN_TOL * ref.abs().max().item())
    if not torch.equal(engines[0].params["decode_4"]["w"], trainer.state.params["decode_4"]["w"].detach()):
        raise AssertionError("the checkpoint's weights differ from the trainer's")
    log(f"checkpoint {os.path.basename(last)} served 6 s: fused vs cuDNN max abs err {err:.3e}")
    phase("training main path", t0)

    # -- 9. parity: dw_pallas on and off from one numpy state ---------------
    t0 = time.perf_counter()
    params, bn = numpy_init(model, seed=3)
    npz = os.path.join(tmp, "parity_init.npz")
    export_params_npz(npz, params, bn)
    loader, _ = train_cli.build_loaders(load_ini_config(ini), 4)
    loader.set_epoch(0)
    batches = list(loader)
    trainers, losses, moments = {}, {}, {}
    p_before = flat_leaves(params)
    for dw in (True, False):
        cfg = load_ini_config(write_train_ini(
            os.path.join(tmp, f"parity_{dw}.cfg"), os.path.join(tmp, f"parity_{dw}"), corpus,
            dw_pallas=dw, base_checkpoint=npz,
        ))
        tr = Trainer(cfg, device="cuda")
        losses[dw], moments[dw] = [], []
        for b in batches[:PARITY_STEPS]:
            tr.state, m = tr._step(tr.state, tr._prep_single(b))
            losses[dw].append(m["loss"])
            moments[dw].append({name: flat_leaves(getattr(tr.state.opt_state, name))
                                for name in ("mu", "nu")})
        losses[dw] = torch.stack(losses[dw]).cpu().numpy()
        trainers[dw] = tr
    log(f"parity losses dw_pallas on {losses[True].tolist()} off {losses[False].tolist()}")
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-3)
    # Each step's Adam moments fold that step's gradient in: held against
    # their global scale after every step, they compare the gradients.
    for k in range(PARITY_STEPS):
        errs = {m: global_err(moments[True][k][m], moments[False][k][m]) for m in ("mu", "nu")}
        log(f"parity step {k}: Adam mu off by {errs['mu']:.3e}, nu by {errs['nu']:.3e} "
            f"of their global scale")
        if max(errs.values()) > PARITY_MOMENT_TOL:
            raise AssertionError(f"parity step {k}: moments differ by {errs} of their scale")
    after = {dw: flat_leaves(trainers[dw].state.params) for dw in (True, False)}
    err = update_err(after[True], after[False], p_before)
    log(f"parity params after {PARITY_STEPS} steps: their change differs by {err:.3e} of its norm")
    if err > PARITY_UPDATE_TOL:
        raise AssertionError(f"parity: the param update differs by {err:.3e} of its norm")
    phase("parity", t0)

    # -- 10. the kernel against its plain version ----------------------------
    t0 = time.perf_counter()
    J, dc = _block_index_map(5, 8)
    kb = J.shape[0]
    if any(_block_index_map(spec.kernel[1], 8)[0].shape[0] != kb for spec in model.layers[1:-1]):
        raise AssertionError("V2's inner layers do not share one KB at fb=8")
    nb = -(-129 // 8)
    shapes = dw_layer_shapes(model)
    gen = torch.Generator(device=dev).manual_seed(5)
    max_err = 0.0
    for B, T in ((B_TRAIN, T_BUCKET), (3, 37)):
        for name, ci, co in shapes:
            z = torch.randn(B, T, nb, ci, device=dev, generator=gen)
            dy = torch.randn(B, T, nb, co, device=dev, generator=gen)
            got = blocked_dw.blocked_dw(z, dy, kb, dc)
            ref = blocked_dw.blocked_dw_plain(z, dy, kb, dc)
            e = check_close(f"blocked_dw {name} B={B} T={T}", got, ref, DW_TOL,
                            DW_TOL * ref.abs().max().item())
            max_err = max(max_err, e)
            # no atomics: a second launch repeats the first bit for bit
            if not torch.equal(blocked_dw.blocked_dw(z, dy, kb, dc), got):
                raise AssertionError(f"blocked_dw {name} B={B} T={T}: a second launch differs")
        log(f"blocked_dw vs plain, 14 layers at B={B} T={T}: max abs err {max_err:.3e}, "
            f"each launch repeated bit for bit")
    # the Function against autograd of the raw conv (tests/test_pallas_dw.py:48-50)
    z0 = torch.randn(2, 9, 5, 24, device=dev, generator=gen)
    w0 = 0.1 * torch.randn(1, 4, 24, 16, device=dev, generator=gen)
    g = torch.randn(2, 9, 5, 16, device=dev, generator=gen)
    grads = []
    for fn in (lambda z, w: blocked_dw.blocked_freq_conv(z, w, 2),
               lambda z, w: blocked_dw.conv_nhwc(z, w, ((0, 0), (2, 1)))):
        z, w = z0.clone().requires_grad_(), w0.clone().requires_grad_()
        (fn(z, w) * g).sum().backward()
        grads.append((z.grad, w.grad))
    check_close("Function dz", grads[0][0], grads[1][0], 1e-5, 1e-5)
    check_close("Function dW", grads[0][1], grads[1][1], 1e-5, 1e-4)
    # the blocked model with and without the Function, normalised by the
    # global gradient scale (tests/test_pallas_dw.py:144-156)
    params, bn = numpy_init(model, seed=4)
    x = torch.randn(2, 12, 129, 1, device=dev, generator=gen)
    model_grads = []
    for dw in (True, False):
        p = {n: {k: v.to(dev).requires_grad_() for k, v in d.items()} for n, d in params.items()}
        s = {n: {k: v.to(dev) for k, v in d.items()} for n, d in bn.items()}
        y, _ = apply_blocked(model, p, s, x, is_training=True, dw_pallas=dw)
        torch.square(y).sum().backward()
        model_grads.append({(n, k): v.grad for n, d in p.items() for k, v in d.items()})
    gscale = max(v.abs().max().item() for v in model_grads[1].values())
    worst = max(check_close(f"model grad {key}", model_grads[0][key] / gscale,
                            model_grads[1][key] / gscale, 1e-5, 1e-6)
                for key in model_grads[1])
    log(f"gradients: Function and blocked model match autograd (worst {worst:.3e} of the gradient scale)")
    phase("dw kernel checks", t0)

    # -- 11. timings -----------------------------------------------------------
    t0 = time.perf_counter()
    rows_full = B_TRAIN * T_BUCKET
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    k_ms = p_ms = lib_ms = 0.0
    for name, ci, co in shapes:
        z = torch.randn(B_TRAIN, T_BUCKET, nb, ci, device=dev, generator=gen)
        dy = torch.randn(B_TRAIN, T_BUCKET, nb, co, device=dev, generator=gen)
        zpad = torch.nn.functional.pad(z.permute(0, 3, 1, 2), (dc, kb - 1 - dc, 0, 0))
        go = dy.permute(0, 3, 1, 2)
        lib = torch.nn.grad.conv2d_weight(zpad, (co, ci, 1, kb), go)
        got = blocked_dw.blocked_dw(z, dy, kb, dc)
        check_close(f"conv2d_weight {name}", lib, got.permute(3, 2, 0, 1), DW_TOL,
                    DW_TOL * got.abs().max().item())
        layer_k = cuda_ms(lambda: blocked_dw.blocked_dw(z, dy, kb, dc), reps=10)
        layer_p = cuda_ms(lambda: blocked_dw.blocked_dw_plain(z, dy, kb, dc), reps=2, warmup=1)
        layer_lib = cuda_ms(lambda: torch.nn.grad.conv2d_weight(zpad, (co, ci, 1, kb), go), reps=10)
        plan = blocked_dw.launch_plan(rows_full, nb, ci, co, kb, sm_count,
                                      blocked_dw.card_blocks_per_sm(kb, dev))
        blocks, slots = plan.tiles * plan.splits, sm_count * plan.blocks_per_sm
        log(f"  {name} Ci={ci} Co={co}: kernel {layer_k:.3f} ms, plain {layer_p:.3f} ms, "
            f"conv2d_weight {layer_lib:.3f} ms; plan {plan.tiles} tiles x {plan.splits} splits "
            f"of {plan.rows_per_split} rows, {plan.blocks_per_sm} blocks per SM at "
            f"{plan.smem_bytes} B, {blocks / (-(-blocks // slots) * slots):.3f} of the waves' slots")
        k_ms, p_ms, lib_ms = k_ms + layer_k, p_ms + layer_p, lib_ms + layer_lib
        del z, dy, zpad, go, lib, got
    flop, nbytes = dw_work(shapes, rows_full, nb, kb, dc)
    # 3xTF32 issues three TF32 products for each float32 one
    t_ops, t_simt = 3 * flop / PEAK_TF32_FLOPS * 1e3, flop / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    # the products the kernel computes: its tiles pad Ci and Co to TILE,
    # and each row's nbp = NB + KB - 1 staged positions run all KB taps
    tile = blocked_dw.TILE
    padded = sum(-(-ci // tile) * -(-co // tile) * tile * tile for _, ci, co in shapes) / sum(
        ci * co for _, ci, co in shapes)
    nbp = nb + kb - 1
    computed = padded * nbp * kb / sum(max(0, nb - abs(d - dc)) for d in range(kb))
    floor_ms = 3 * flop * computed / (rate * 1e12) * 1e3
    log(f"timing blocked_dw over V2's 14 layers at {B_TRAIN} x 8 s (B*T={rows_full}): kernel {k_ms:.3f} ms, "
        f"plain {p_ms:.3f} ms, conv2d_weight (cuDNN) {lib_ms:.3f} ms")
    log(f"bound: {flop:.4e} FLOP -> {t_ops:.3f} ms in 3xTF32 at 495 TFLOP/s ({t_simt:.3f} ms in float32 "
        f"at 67 TFLOP/s); {nbytes:.4e} B -> {t_bytes:.3f} ms at 3.35 TB/s; kernel at "
        f"{100 * bound_ms / k_ms:.1f}% of the 3xTF32 bound, {100 * t_simt / k_ms:.1f}% of the float32 one")
    log(f"launch plan: tiles pad the products {padded:.4f}x, staging pads K {nbp / nb:.4f}x "
        f"(nbp {nbp} / NB {nb}); the kernel computes {computed:.4f}x the needed products; "
        f"mma.sync TF32 alone runs at {rate:.1f} TFLOP/s here, so its floor is {floor_ms:.3f} ms "
        f"(kernel at {100 * floor_ms / k_ms:.1f}% of it)")

    # whole train steps, dw_pallas on and off in turns (on, off, off, on)
    audio_s = float(sum(b.lengths.sum() for b in batches[:1])) / SR
    payload = {dw: trainers[dw]._prep_single(batches[0]) for dw in (True, False)}
    step_ms = {True: [], False: []}
    for dw in (True, False, False, True):
        tr = trainers[dw]
        tr.state, _ = tr._step(tr.state, payload[dw])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            tr.state, _ = tr._step(tr.state, payload[dw])
        torch.cuda.synchronize()
        step_ms[dw].append((time.perf_counter() - t1) * 1e3 / 3)
    for dw in (True, False):
        ms = float(np.mean(step_ms[dw]))
        log(f"train step {B_TRAIN} x 8 s, dw_pallas={dw}: {step_ms[dw][0]:.2f} / {step_ms[dw][1]:.2f} ms "
            f"(mean {ms:.2f} ms, {audio_s / ms * 1e3:.1f} audio-s/s)")
    # one steps_per_call=8 dispatch under the profiler
    tr = trainers[True]
    stacked = tr._prep_multi(batches[:8])
    dispatch_audio = float(sum(b.lengths.sum() for b in batches[:8])) / SR

    def dispatch():
        tr.state, packed = tr._multi_step(tr.state, stacked)
        return packed

    host_ms, busy_ms, events = device_busy_ms(dispatch, reps=2, top=15)
    busy = "device busy not measured" if busy_ms is None else (
        f"device busy {busy_ms:.2f} ms in {events:.0f} device events, idle share {1 - busy_ms / host_ms:.3f}")
    log(f"one steps_per_call=8 dispatch (8 x {B_TRAIN} x 8 s): host {host_ms:.2f} ms traced, "
        f"{dispatch_audio / host_ms * 1e3:.1f} audio-s/s, {busy}")
    # where cuDNN converts layouts inside one train step
    conv = layout_conversions(lambda: tr._step(tr.state, payload[True]))
    log("layout conversions of one train step: not linked to ops by the profiler" if conv is None
        else f"layout conversions of one train step: {conv[0]} kernels, {conv[1]:.3f} ms")
    phase("dw timings", t0)
    for tr in trainers.values():
        tr.ckpt.close()

    entry = {
        "name": "blocked_dw",
        "route": "cuda",
        "source": "fullycnnspeechenhancement_torch/ops/csrc/blocked_dw.cu",
        "replaces": "fullycnnspeechenhancement_tpu/ops/pallas_dw.py:51",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations, 3xTF32 tensor cores" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms,
        "mma_sync_tf32_tflops": rate,
        # computed from this run's inputs and the rate above, not timed
        "derived": {
            "bound_fp32_simt_ms": max(t_simt, t_bytes),
            "padded_product_ratio": padded,
            "k_padding_ratio": nbp / nb,
            "mma_sync_floor_ms": floor_ms,
        },
    }
    return entry, last


# -- the kernel-probe path -------------------------------------------------


def distinct_elements(t) -> int:
    """Elements a view reads from memory: a stride-0 dimension repeats."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n


def conv_work(x, w, options, out_numel: int):
    """(FLOP, bytes) of one `freq_conv` on x [B, R, P, C] and w [K, C, D]:
    products only at live output positions and only against real inputs
    (a zero-boundary tap that falls off the row meets no input); x and w
    read once, y written once."""
    B, R, P, C = x.shape
    K, _, D = w.shape
    lo = options.get("lo", (K - 1) // 2)
    dil = options.get("dilation", 1)
    period = options.get("period", 0)
    p = np.arange(P)
    live = (p % period < options.get("valid", 0)) if period else np.ones(P, bool)
    if options.get("circular", False):
        taps = np.full(P, K)
    else:
        q = p[:, None] + np.arange(K)[None, :] * dil - lo
        taps = ((q >= 0) & (q < P)).sum(1)
    flop = 2.0 * B * R * C * D * taps[live].sum()
    nbytes = 4.0 * (distinct_elements(x) + distinct_elements(w) + out_numel)
    return flop, nbytes


def chain_work(x, w, options):
    """(FLOP, bytes) of one `freq_conv_stack` on x [C, N]: layer 1 reads
    real lanes at every tap of the live lanes; later layers' taps count only
    where they meet a live lane (the rest is the mask's zeros)."""
    from fullycnnspeechenhancement_torch.ops.freq_conv import FRAME, VALID

    C, N = x.shape
    K = w.shape[0]
    frame, valid = options.get("frame", FRAME), options.get("valid", VALID)
    q = np.arange(valid)[:, None] + np.arange(K)[None, :] - (K - 1) // 2
    inner = int(((q >= 0) & (q < valid)).sum())
    macs = (N // frame) * C * C * (valid * K + (options["depth"] - 1) * inner)
    return 2.0 * macs, 4.0 * (2 * x.numel() + distinct_elements(w))


def bound_of(flop, nbytes):
    """(bound ms, what bounds it) at the H100's float32 and memory peaks."""
    t_ops, t_bytes = flop / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def tf32_bound_of(flop, nbytes):
    """(bound ms, what bounds it) of a 3xTF32 kernel: three TF32 products
    for each float32 one at the data sheet's 495 TFLOP/s, or the bytes."""
    t_ops, t_bytes = 3 * flop / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations, 3xTF32 tensor cores" if t_ops >= t_bytes else "bytes")


def conv_plan_fields(plan, rate):
    """The launch-plan fields phases 12 and 13 print for a `freq_conv`
    launch, and the floor (ms) that mma.sync's measured TF32 rate `rate`
    (TFLOP/s) sets on the products the plan computes (three a multiply-add
    pair of its m16n8k8 tiles)."""
    floor_ms = 3 * 2.0 * plan.padded_macs / (rate * 1e12) * 1e3
    fields = {
        "grid": plan.grid, "blocks_per_sm": plan.blocks_per_sm, "threads": plan.threads,
        "tile": plan.tile, "m16_tiles_a_warp": plan.mb, "k_split": plan.ksplit,
        "persistent": plan.buffers == 2, "staging": "channel-major" if plan.channel_major else "position-major",
        "computed_m16_tiles": plan.computed_tiles, "skipped_m16_tiles": plan.skipped_tiles,
        "smem_bytes": plan.smem_bytes,
    }
    return fields, floor_ms


def stack_plan_fields(plan, depth: int, rate):
    """The launch-plan fields phases 12 and 14 print for a
    `freq_conv_stack` launch, and the floor (ms) that mma.sync's measured
    TF32 rate `rate` (TFLOP/s) sets on the products the plan computes in a
    chain of `depth` layers (three a multiply-add pair of its m16n8k8
    tiles)."""
    floor_ms = 3 * 2.0 * plan.padded_macs(depth) / (rate * 1e12) * 1e3
    fields = {
        "cluster": plan.cluster, "grid": plan.grid, "blocks_per_sm": plan.blocks_per_sm,
        "clusters_on_card": plan.clusters_on_card, "threads": plan.threads,
        "n8_tiles_a_block": plan.tiles, "m16_tiles": plan.mtiles, "m16_tiles_a_warp": plan.mb,
        "k_split": plan.ksplit, "k8_chunks": plan.chunks, "smem_bytes": plan.smem_bytes,
    }
    return fields, floor_ms


def conv2d_call(x, w, options):
    """The one PyTorch call that computes a `freq_conv` on (x, w): cuDNN's
    F.conv2d on the NCHW view, for a zero boundary with symmetric padding
    and no epilogue; else (None, why not)."""
    import torch.nn.functional as F

    K = w.shape[0]
    lo = options.get("lo", (K - 1) // 2)
    dil = options.get("dilation", 1)
    if options.get("circular"):
        return None, "circular boundary: no single PyTorch call (F.pad circular + conv2d is two)"
    if options.get("period") or options.get("relu") or options.get("scale", 1.0) != 1.0:
        return None, "masked epilogue: no single PyTorch call"
    if 2 * lo != (K - 1) * dil:
        return None, "asymmetric padding: no single PyTorch call"
    xn = x.permute(0, 3, 1, 2)
    wo = w.permute(2, 1, 0)[:, :, None, :].contiguous()
    return (lambda: F.conv2d(xn, wo, padding=(0, lo), dilation=(1, dil)).permute(0, 2, 3, 1)), None


def busy_ms(fn, reps: int = 20, tries: int = 3):
    """Device time per call of `fn` (torch.profiler), or None.  A short
    profile now and then records no device event (2 of 51 in one run on
    the H100), so it is taken again, up to `tries` times."""
    for _ in range(tries):
        ms = device_busy_ms(fn, reps)[1]
        if ms is not None:
            return ms
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def run_probe_path(dev, rate: float) -> dict:
    """Phase 12: every probe of `fullycnnspeechenhancement_torch.probes` at
    its script's shapes.  Returns per-kernel summaries (launches, errors)
    and the rows."""
    from fullycnnspeechenhancement_torch.ops import freq_conv as fc
    from fullycnnspeechenhancement_torch.probes import __main__ as probes_main
    from fullycnnspeechenhancement_torch.probes import all_probes

    rng = np.random.default_rng(20)
    arrays, calls = {}, []
    for module, probe in all_probes():
        short = module.__name__.rsplit(".", 1)[-1]
        if short not in arrays:
            arrays[short] = module.inputs(rng)
        calls.append((probe, [torch.as_tensor(arrays[short][a], device=dev) for a in probe.args]))
    want = {k: sum(p.kernel == k for p, _ in calls) for k in ("freq_conv", "freq_conv_stack")}

    # -- the main path: each probe once ------------------------------------
    fc.launches = fc.stack_launches = 0
    outs = [probe(*args) for probe, args in calls]
    torch.cuda.synchronize()
    got = {"freq_conv": fc.launches, "freq_conv_stack": fc.stack_launches}
    log(f"probe path: {len(calls)} probes, launches {got}")
    if got != want:
        raise AssertionError(f"probe path launched {got}, expected {want}")

    summary = {k: {"launches": got[k], "max_abs_err": 0.0, "max_rel_err": 0.0} for k in got}
    rows = []
    for (probe, args), out in zip(calls, outs):
        ref = probe(*args, plain=True)
        scale = ref.abs().max().item()
        err = check_close(probe.name, out, ref, PROBE_TOL, PROBE_TOL * scale)
        s = summary[probe.kernel]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["max_rel_err"] = max(s["max_rel_err"], err / scale)
        x, w = probe.operands(*args)
        if probe.kernel == "freq_conv":
            flop, nbytes = conv_work(x, w, probe.options, out.numel())
            lib, why = conv2d_call(x, w, probe.options)
        else:
            flop, nbytes = chain_work(x, w, probe.options)
            lib, why = None, "a chain of layers: no single PyTorch call"
        if lib is not None:
            check_close(f"{probe.name} conv2d", probe.result(lib()), out, PROBE_TOL, PROBE_TOL * scale)
        lib_ms = busy_ms(lib) if lib is not None else None
        if lib is not None and lib_ms is None:
            why = "not measured: the profiler recorded no device event"
        row = {
            "name": probe.name, "row": probe.row, "kernel": probe.kernel, "launches": 1,
            "max_abs_err": err,
            "ms": busy_ms(lambda: probe(*args)),
            "plain_ms": busy_ms(lambda: probe(*args, plain=True), reps=5),
            "library_ms": lib_ms,
            "call_ms": cuda_ms(lambda: probe(*args), reps=50),
            "library_call_ms": cuda_ms(lib, reps=50) if lib is not None else None,
            "flop": flop,
        }
        if probe.kernel == "freq_conv":
            # 3xTF32 mma.sync: its bound, the float32 one, and mma.sync's floor
            row["bound_ms"], row["bound_by"] = tf32_bound_of(flop, nbytes)
            row["bound_fp32_simt_ms"] = bound_of(flop, nbytes)[0]
            plan = fc.launch_plan(x, w, **{k: v for k, v in probe.options.items() if k != "scale"})
            row["plan"], row["mma_sync_floor_ms"] = conv_plan_fields(plan, rate)
            log(f"launch plan {probe.name}: " + json.dumps(row["plan"]))
        else:
            row["bound_ms"], row["bound_by"] = tf32_bound_of(flop, nbytes)
            row["bound_fp32_simt_ms"] = bound_of(flop, nbytes)[0]
            plan = fc.stack_launch_plan(x, w, frame=probe.options["frame"], valid=probe.options["valid"])
            row["plan"], row["mma_sync_floor_ms"] = stack_plan_fields(plan, probe.options["depth"], rate)
            row["padded_product_ratio"] = 2 * plan.padded_macs(probe.options["depth"]) / flop
            log(f"launch plan {probe.name}: " + json.dumps(row["plan"]))
        if why:
            row["library"] = why
        rows.append(row)
        log("probe " + json.dumps(row))
    log("probe CLI (python -m fullycnnspeechenhancement_torch.probes --reps 10):")
    probes_main.main(["--reps", "10"])
    return {"summary": summary, "rows": rows}


# The launch plans phase 13 times beside freq_conv's own, by the module
# constants that choose them: one block per row instead of persistent
# blocks, and one m16 tile a warp instead of pairs.
PLAN_ALTERNATIVES = {
    "one_block_per_row_ms": {"PERSISTENT_RATIO": 1 << 40},
    "one_m16_tile_a_warp_ms": {"PAIR_MTILES": 1 << 40},
}


def plan_alternatives(fc, call, alternatives=PLAN_ALTERNATIVES, timer=None) -> dict:
    """Device ms per `call` under each plan of `alternatives`, then the
    module's own constants and plans again."""
    out = {}
    for name, consts in alternatives.items():
        saved = {k: getattr(fc, k) for k in consts}
        try:
            for k, v in consts.items():
                setattr(fc, k, v)
            fc.replan()
            out[name] = (timer or (lambda f: cuda_ms(f, reps=10)))(call)
        finally:
            for k, v in saved.items():
                setattr(fc, k, v)
            fc.replan()
    return out


def run_v2_layers(dev, stack_entry: dict, rate: float) -> dict:
    """Phase 13: `freq_conv` on V2's 14 inner layer shapes at 64 x 8 s
    (NCHW activations [B, C, T, 129] viewed as [B, T, 129, C]), weights
    drawn with numpy in HWIO and brought over by `params_from_numpy`;
    against its plain version, cuDNN's F.conv2d, its bounds and the floor
    mma.sync's measured rate `rate` sets on its launch plan."""
    import torch.nn.functional as F

    from fullycnnspeechenhancement_torch.config import DSPConfig
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.ops import freq_conv as fc
    from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy

    model = get_model("FullyCNNV2")
    rng = np.random.default_rng(30)
    hwio, ch = {}, 1
    for spec in model.layers:
        kh, kw = spec.kernel
        lim = np.sqrt(6.0 / (kh * kw * (ch + spec.out_ch)))
        hwio[spec.name] = {"w": rng.uniform(-lim, lim, (kh, kw, ch, spec.out_ch)).astype(np.float32),
                           "b": np.zeros(spec.out_ch, np.float32)}
        ch = spec.out_ch
    params, _ = params_from_numpy(hwio, {}, device=dev)
    B, T = 64, DSPConfig().num_frames(8 * SR)
    gen = torch.Generator(device=dev).manual_seed(31)
    cin = model.layers[0].out_ch
    tot = {"ms": 0.0, "plain_ms": 0.0, "cudnn_ms": 0.0, "flop": 0.0, "bytes": 0.0, "max_abs_err": 0.0,
           "bound_3xtf32_ms": 0.0, "mma_sync_floor_ms": 0.0, "padded_macs": 0.0}
    for spec in model.layers[1:-1]:
        w_oihw = params[spec.name]["w"]
        kw = w_oihw.shape[-1]
        w = w_oihw[:, :, 0, :].permute(2, 1, 0)  # [kw, Cin, Cout] view
        x = torch.randn(B, cin, T, 129, device=dev, generator=gen)
        xv = x.permute(0, 2, 3, 1)
        got = fc.freq_conv(xv, w)
        ref = fc.freq_conv_plain(xv, w)
        lib = F.conv2d(x, w_oihw, padding=(0, (kw - 1) // 2)).permute(0, 2, 3, 1)
        atol = PROBE_TOL * ref.abs().max().item()
        err = check_close(f"V2 {spec.name}", got, ref, PROBE_TOL, atol)
        check_close(f"V2 {spec.name} conv2d", lib, got, PROBE_TOL, atol)
        del ref, lib
        k_ms = cuda_ms(lambda: fc.freq_conv(xv, w), reps=10)
        c_ms = cuda_ms(lambda: F.conv2d(x, w_oihw, padding=(0, (kw - 1) // 2)), reps=10)
        alt = plan_alternatives(fc, lambda: fc.freq_conv(xv, w))
        k_ms_2 = cuda_ms(lambda: fc.freq_conv(xv, w), reps=10)
        p_ms = cuda_ms(lambda: fc.freq_conv_plain(xv, w), reps=2, warmup=1)
        flop, nbytes = conv_work(xv, w, {}, got.numel())
        bound, _ = bound_of(flop, nbytes)
        bound3, by3 = tf32_bound_of(flop, nbytes)
        plan = fc.launch_plan(xv, w)
        fields, floor_ms = conv_plan_fields(plan, rate)
        log(f"  V2 {spec.name} {cin}->{spec.out_ch} kw={kw}: freq_conv {k_ms:.4f} / {k_ms_2:.4f} ms, "
            f"cuDNN conv2d {c_ms:.4f} ms, plain {p_ms:.4f} ms; bounds {bound3:.4f} ms 3xTF32 ({by3}), "
            f"{bound:.4f} ms float32 ({flop:.4e} FLOP); mma.sync floor {floor_ms:.4f} ms; kernel at "
            f"{100 * bound3 / (k_ms + k_ms_2) * 2:.1f}% of the 3xTF32 bound, "
            f"{100 * floor_ms / (k_ms + k_ms_2) * 2:.1f}% of the floor; max abs err {err:.3e}; plan "
            + json.dumps(fields) + "; other plans (ms): " + json.dumps({k: round(v, 4) for k, v in alt.items()}))
        for name, ms in alt.items():
            tot[name] = tot.get(name, 0.0) + ms
        tot["bound_3xtf32_ms"] += bound3
        tot["mma_sync_floor_ms"] += floor_ms
        tot["padded_macs"] += plan.padded_macs
        tot["ms"] += (k_ms + k_ms_2) / 2
        tot["plain_ms"] += p_ms
        tot["cudnn_ms"] += c_ms
        tot["flop"] += flop
        tot["bytes"] += nbytes
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        cin = spec.out_ch
        del x, xv, got
    tot["bound_fp32_simt_ms"] = bound_of(tot["flop"], tot["bytes"])[0]
    tot["bound_ms"], tot["bound_by"] = tf32_bound_of(tot["flop"], tot["bytes"])
    tot["padded_product_ratio"] = 2 * tot["padded_macs"] / tot["flop"]
    log(f"V2 14 inner layers at {B} x 8 s (T={T}): freq_conv sum {tot['ms']:.3f} ms, cuDNN conv2d sum "
        f"{tot['cudnn_ms']:.3f} ms, plain sum {tot['plain_ms']:.3f} ms; bound {tot['bound_ms']:.3f} ms "
        f"({tot['bound_by']}; {tot['flop']:.4e} FLOP, {tot['bytes']:.4e} B; float32 {tot['bound_fp32_simt_ms']:.3f} "
        f"ms), sum of per-layer 3xTF32 bounds {tot['bound_3xtf32_ms']:.3f} ms; the tiles compute "
        f"{tot['padded_product_ratio']:.4f}x the products, mma.sync floor {tot['mma_sync_floor_ms']:.3f} ms at "
        f"{rate:.1f} TFLOP/s (kernel at {100 * tot['mma_sync_floor_ms'] / tot['ms']:.1f}% of it); same run: "
        f"rced_stack {stack_entry['ms']:.3f} ms, cuDNN stack {stack_entry['cudnn_stack_ms']:.3f} ms; "
        f"other plans, summed: " + json.dumps({k: round(tot[k], 3) for k in PLAN_ALTERNATIVES}))
    return tot


# The launch plan phase 14 times beside freq_conv_stack's own at the
# deepest chain, by the module constant that chooses it: one block a frame
# instead of a cluster of two.
STACK_PLAN_ALTERNATIVES = {"one_block_per_frame_ms": {"STACK_CLUSTER": 1}}


def run_chain(dev, rate: float) -> dict:
    """Phase 14: `freq_conv_stack` against `depth` launches of `freq_conv`
    at roll2's shape (x [32, 64 * 256], im2col weights), depths 1-16,
    beside its bounds, the floor mma.sync's measured rate `rate` sets on
    its launch plan, and at the deepest chain under the plan of
    STACK_PLAN_ALTERNATIVES."""
    from fullycnnspeechenhancement_torch.ops import freq_conv as fc
    from fullycnnspeechenhancement_torch.probes import roll

    arrays = roll.inputs(np.random.default_rng(40))
    x0 = torch.as_tensor(arrays["x"], device=dev)
    wcol = torch.as_tensor(arrays["wcol"], device=dev)
    out = {}
    for depth in roll.DEPTHS:
        probe = roll.im2col_stack(depth)
        x, w = probe.operands(x0, wcol)

        def chained():
            h = x
            for _ in range(depth):
                h = fc.freq_conv(h.t()[None, None], w, circular=True, period=fc.FRAME,
                                 valid=fc.VALID, relu=True)[0, 0].t()
            return h

        def stack():
            return fc.freq_conv_stack(x, w, depth)

        got = stack()
        ref = fc.freq_conv_stack_plain(x, w, depth)
        scale = ref.abs().max().item()
        err = check_close(f"chain depth {depth}", got, ref, PROBE_TOL, PROBE_TOL * scale)
        check_close(f"chain depth {depth} vs chained launches", chained(), got, PROBE_TOL, PROBE_TOL * scale)
        s_ms = cuda_ms(stack, reps=50)
        a_ms = cuda_ms(chained, reps=50)
        s_busy, a_busy = busy_ms(stack), busy_ms(chained)
        alt = {}
        if depth == max(roll.DEPTHS):
            alt = plan_alternatives(fc, stack, STACK_PLAN_ALTERNATIVES, busy_ms)
        s_busy_2 = busy_ms(stack)
        p_ms = cuda_ms(lambda: fc.freq_conv_stack_plain(x, w, depth), reps=5)
        flop, nbytes = chain_work(x, w, probe.options)
        bound3, by3 = tf32_bound_of(flop, nbytes)
        bound = bound_of(flop, nbytes)[0]
        plan = fc.stack_launch_plan(x, w)
        fields, floor_ms = stack_plan_fields(plan, depth, rate)
        ratio = 2 * plan.padded_macs(depth) / flop
        device = [v for v in (s_busy, s_busy_2) if v is not None]
        dev_ms = sum(device) / len(device) if device else None
        log(f"chain depth {depth}: freq_conv_stack {s_ms:.4f} ms (device {fmt_ms(s_busy)} / {fmt_ms(s_busy_2)}), "
            f"{depth} x freq_conv {a_ms:.4f} ms (device {fmt_ms(a_busy)}), plain {p_ms:.4f} ms; bounds "
            f"{bound3:.4f} ms 3xTF32 ({by3}), {bound:.4f} ms float32 ({flop:.4e} FLOP, {nbytes:.4e} B); the tiles "
            f"compute {ratio:.4f}x the products, mma.sync floor {floor_ms:.4f} ms at {rate:.1f} TFLOP/s"
            + (f" (kernel at {100 * floor_ms / dev_ms:.1f}% of it, {100 * bound3 / dev_ms:.1f}% of the "
               "3xTF32 bound)" if dev_ms else "")
            + f"; max abs err {err:.3e} of max|plain| {scale:.3e}; plan " + json.dumps(fields)
            + (("; other plan, device ms: " + json.dumps(alt)) if alt else ""))
        out[depth] = {"ms": s_ms, "device_ms": dev_ms, "chained_ms": a_ms, "chained_device_ms": a_busy,
                      "plain_ms": p_ms, "bound_ms": bound3, "bound_by": by3, "bound_fp32_simt_ms": bound,
                      "mma_sync_floor_ms": floor_ms, "padded_product_ratio": ratio, "max_abs_err": err,
                      "max_rel_err": err / scale, **alt}
    return out


# -- the evaluation path ---------------------------------------------------


# cli.test with and without the fused stack: averages within these.
EVAL_TOL = {"stoi": 1e-4, "sdr": 1e-2, "pesq": 1e-2}
N_TEST = 256


def write_test_set(root: str, rng) -> dict:
    """N_TEST speech-like clean utterances of 2-8 s and 4 noise recordings
    of 30 s, and their manifests (the shipped test configs mix on the fly
    at snr 0)."""
    from fullycnnspeechenhancement_torch.data import write_manifest, write_wav

    os.makedirs(root, exist_ok=True)
    clean, noise = [], []
    for i in range(N_TEST):
        sig = speech_like(rng, rng.uniform(2.0, 8.0))
        path = os.path.join(root, f"test_{i}.wav")
        write_wav(path, sig, SR)
        clean.append({"audio_filepath": path, "duration": len(sig) / SR})
    for i in range(4):
        sig = noise_like(rng, 30.0)
        path = os.path.join(root, f"test_noise_{i}.wav")
        write_wav(path, sig, SR)
        noise.append({"audio_filepath": path, "duration": len(sig) / SR})
    paths = {"clean": os.path.join(root, "test.clean"), "noise": os.path.join(root, "test.noise")}
    write_manifest(paths["clean"], clean)
    write_manifest(paths["noise"], noise)
    paths["seconds"] = sum(e["duration"] for e in clean)
    return paths


def write_test_ini(path: str, root: str, test_set: dict, checkpoint: str, fused: bool) -> str:
    """work/aishell_1/cfg/fully_cnn_test.cfg's settings for V2 at full
    width, with the made-up test set and `checkpoint`."""
    with open(path, "w") as f:
        f.write(
            f"[testing]\nbatch_size=2\ncheckpoint_filepath={checkpoint}\nnum_iter_print=1\n"
            f"[model]\nnet_arch=RCED\nnet_work=FullyCNNV2\nfused_inference={fused}\n"
            f"[training]\nlog_dir={root}/log\n"
            f"[data]\ntest_manifest_path={test_set['clean']}\n"
            f"test_noise_manifest={test_set['noise']}\nsnr=0\nsample_rate=8000\nnfft=256\n"
            "feature_dim=129\nwindow_ms=32\nstride_ms=16\nwindows=hanning\n"
            f"audio_save_path={root}/denoise\n"
        )
    return path


def run_evaluation(dev, tmp: str, checkpoint: str) -> dict:
    """Phase 15: `cli.test` on N_TEST utterances from phase 8's last
    checkpoint, with and without `fused_inference`, each twice.  The first
    pass is the main path, without a profiler: its wall time and
    audio-s/s, `rced_stack`'s launches (one per evaluation batch, none
    without) and, fused, each (B, T) the kernel was given, with the first
    input of that shape.  The second pass runs under torch.profiler for
    the device-busy share alone.  Then the kernel against its plain
    version on those inputs, the two runs' averages within EVAL_TOL, and
    the PESQ implementation.  Returns the fused main path's launches and
    the kernel's largest difference from its plain version."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fullycnnspeechenhancement_torch import load_ini_config
    from fullycnnspeechenhancement_torch.cli import test as test_cli
    from fullycnnspeechenhancement_torch.data import DataLoader, SpeechDataset
    from fullycnnspeechenhancement_torch.eval.metrics import PESQ
    from fullycnnspeechenhancement_torch.ops import rced_stack

    t0 = time.perf_counter()
    test_set = write_test_set(os.path.join(tmp, "test_set"), np.random.default_rng(4))
    log(f"test set: {N_TEST} utterances ({test_set['seconds']:.1f} s) in {time.perf_counter() - t0:.1f} s")
    implementation = PESQ(sr=SR).implementation
    if implementation != "p862-native":
        raise AssertionError(f"PESQ implementation {implementation}, expected p862-native")
    # (B, T) -> (packed stack, first input of that shape) on the fused main path
    given = {}
    real_forward = rced_stack.stack_forward

    def recording_forward(packed, x):
        if (x.shape[0], x.shape[2]) not in given:
            given[(x.shape[0], x.shape[2])] = (packed, x.clone())
        return real_forward(packed, x)

    runs = {}
    for fused in (True, False):
        root = os.path.join(tmp, f"test_{'fused' if fused else 'cudnn'}")
        ini = write_test_ini(os.path.join(tmp, f"test_{fused}.cfg"), root, test_set, checkpoint, fused)
        cfg = load_ini_config(ini)
        n_batches = len(DataLoader(SpeechDataset.from_config(cfg.data, cfg.dsp, "test"), cfg.dsp,
                                   cfg.eval.batch_size, bucket_frames=cfg.data.bucket_frames,
                                   shuffle=False))
        torch.cuda.synchronize()
        rced_stack.stack_forward = recording_forward if fused else real_forward
        try:
            rced_stack.launches = 0
            w0 = time.perf_counter()
            results = test_cli.main(["--cfg", ini])
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
            launches = rced_stack.launches
        finally:
            rced_stack.stack_forward = real_forward
        de = [f for f in os.listdir(os.path.join(root, "denoise")) if f.endswith("_de.wav")]
        log(f"cli.test fused_inference={fused}: {results}; {n_batches} batches, rced_stack launches "
            f"{launches}; {test_set['seconds']:.1f} audio-s in {wall:.2f} s, "
            f"{test_set['seconds'] / wall:.1f} audio-s/s; {len(de)} _de.wav files")
        if launches != (n_batches if fused else 0):
            raise AssertionError(f"fused_inference={fused}: rced_stack launched {launches} times "
                                 f"in {n_batches} batches")
        if sorted(results) != ["pesq", "sdr", "stoi"] or not all(np.isfinite(v) for v in results.values()):
            raise AssertionError(f"cli.test printed {results}: want finite pesq, sdr and stoi only")
        if len(de) != N_TEST:
            raise AssertionError(f"{len(de)} _de.wav files, expected {N_TEST}")
        runs[fused] = (results, launches)
        # device activity only: CPU op events of a whole pass take longer to
        # collect than the pass
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            test_cli.main(["--cfg", ini])
            torch.cuda.synchronize()
            traced = time.perf_counter() - w0
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy_s = sum(e.time_range.elapsed_us() for e in device) / 1e6
        log(f"cli.test fused_inference={fused} under torch.profiler: {traced:.2f} s, " + (
            f"device busy {busy_s:.3f} s in {len(device)} device events, busy share {busy_s / traced:.4f}"
            if device else "device busy not measured"))
    # the kernel against its plain version at every shape the fused main
    # path gave it, on the first input of each
    if not given:
        raise AssertionError("the fused main path never called rced_stack.stack_forward")
    max_err = 0.0
    for (B, T), (packed, x) in sorted(given.items()):
        ref = rced_stack.stack_forward_plain(packed, x)
        scale = ref.abs().max().item()
        if scale == 0.0:
            raise AssertionError(f"eval V2 B={B} T={T}: the plain stack is 0 everywhere")
        e = check_close(f"eval V2 B={B} T={T}", rced_stack.stack_forward(packed, x), ref, 1e-4, 1e-5 * scale)
        max_err = max(max_err, e)
        log(f"kernel V2 B={B} T={T} (evaluation input): max abs err vs plain {e:.3e} of max|plain| {scale:.3e}")
    diffs = {k: abs(runs[True][0][k] - runs[False][0][k]) for k in EVAL_TOL}
    log(f"cli.test fused against cuDNN: |diff| {diffs} (limits {EVAL_TOL}); PESQ {implementation}")
    bad = {k: d for k, d in diffs.items() if d > EVAL_TOL[k]}
    if bad:
        raise AssertionError(f"cli.test averages differ fused against cuDNN: {bad}")
    return {"launches": runs[True][1], "max_abs_err": max_err}


# The rate of independent mma.sync.m16n8k8 TF32 products when nothing else
# is issued, A and B from 2 and 8 register sets as in blocked_dw.cu: the
# most that kernel's instruction could give, beside the data sheet's 495
# TFLOP/s (which wgmma reaches).
MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(128) mma_rate(float* out, int iters) {
  uint32_t a[2][4], b[8][2];
  for (int i = 0; i < 2; ++i) for (int c = 0; c < 4; ++c) a[i][c] = threadIdx.x * (i + 3) + c;
  for (int i = 0; i < 8; ++i) for (int c = 0; c < 2; ++c) b[i][c] = threadIdx.x * (i + 5) + c;
  float acc[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                   : "+f"(acc[n][0]), "+f"(acc[n][1]), "+f"(acc[n][2]), "+f"(acc[n][3])
                   : "r"(a[n / 8][0]), "r"(a[n / 8][1]), "r"(a[n / 8][2]), "r"(a[n / 8][3]),
                     "r"(b[n % 8][0]), "r"(b[n % 8][1]));
    a[it & 1][0] ^= it;
    b[it & 7][0] ^= it;
  }
  float s = 0.f;
  for (int n = 0; n < 16; ++n) s += acc[n][0] + acc[n][1] + acc[n][2] + acc[n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(float* out, int blocks, int iters) {
  mma_rate<<<blocks, 128>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def build_mma_rate() -> str:
    """Compiles MMA_RATE_SRC into the package's build directory."""
    from fullycnnspeechenhancement_torch.ops import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = build.BUILD_DIR / "mma_rate.cu", build.BUILD_DIR / "libmma_rate.so"
    src.write_text(MMA_RATE_SRC)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    return str(lib)


def mma_sync_tf32_tflops(lib_path: str) -> float:
    """TFLOP/s of MMA_RATE_SRC's kernel: 16 warps per SM, 16 independent
    accumulators each, timed with CUDA events after a warm-up."""
    import ctypes

    lib = ctypes.CDLL(lib_path)
    lib.mma_rate_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 128, device="cuda")
    iters = 10000
    if lib.mma_rate_launch(out.data_ptr(), blocks, 100) != 0:
        raise RuntimeError("mma_rate launch failed")
    ms = cuda_ms(lambda: lib.mma_rate_launch(out.data_ptr(), blocks, iters), reps=3, warmup=1)
    return blocks * 4 * iters * 16 * 2048 / ms / 1e9


def build_kernels() -> str:
    """Phase 2: one nvcc per CUDA source, all started together, the native
    runtime's g++ and the mma.sync rate probe beside them; returns the
    probe's library."""
    from concurrent.futures import ThreadPoolExecutor

    from fullycnnspeechenhancement_torch.data import native
    from fullycnnspeechenhancement_torch.ops import blocked_dw, build, freq_conv, rced_stack

    names = ("rced_stack", "blocked_dw", "freq_conv")

    def timed_build(name):
        t0 = time.perf_counter()
        build.build(name)
        return time.perf_counter() - t0

    def timed_runtime():
        t0 = time.perf_counter()
        native.build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(names) + 2) as pool:
        probe = pool.submit(build_mma_rate)
        runtime = pool.submit(timed_runtime)
        seconds = dict(zip(names, pool.map(timed_build, names)))
        probe_lib = probe.result()
        runtime_s = runtime.result()
    if not native.native_available():
        raise RuntimeError("the native runtime built but does not load")
    log(f"build: native runtime (g++, fcse_runtime.cc + pesq862.cc) in {runtime_s:.1f} s")
    rced_stack.load_library()
    blocked_dw.load_library()
    freq_conv.load_library()
    for name in names:
        log(f"build: {name}.cu in {seconds[name]:.1f} s")
        log_path = f"{build.library_path(name)}.log"
        if os.path.exists(log_path):
            for line in open(log_path).read().splitlines():
                if "registers" in line or "smem" in line or "spill" in line or "entry function" in line:
                    log(f"  ptxas: {line.strip()}")
    return probe_lib


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1

    from fullycnnspeechenhancement_torch.device import disable_tf32

    dev = torch.device("cuda")
    disable_tf32()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    mma_rate = mma_sync_tf32_tflops(build_kernels())
    log(f"mma.sync m16n8k8 TF32 alone: {mma_rate:.1f} TFLOP/s")
    phase("build", t0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        stack_entry = run_serving(dev, tmp, mma_rate)
        phase("serving", t0)
        dw_entry, last_checkpoint = run_training(dev, tmp, mma_rate)
        t0 = time.perf_counter()
        probe_path = run_probe_path(dev, mma_rate)
        phase("probe path", t0)
        t0 = time.perf_counter()
        v2 = run_v2_layers(dev, stack_entry, mma_rate)
        phase("freq_conv at V2 width", t0)
        t0 = time.perf_counter()
        chain = run_chain(dev, mma_rate)
        phase("chains", t0)
        t0 = time.perf_counter()
        evaluation = run_evaluation(dev, tmp, last_checkpoint)
        phase("evaluation path", t0)
    stack_entry["launches_by_path"] = {"serving": stack_entry["launches"], "evaluation": evaluation["launches"]}
    stack_entry["launches"] += evaluation["launches"]
    stack_entry["max_abs_err"] = max(stack_entry["max_abs_err"], evaluation["max_abs_err"])

    conv_sum, stack_sum = probe_path["summary"]["freq_conv"], probe_path["summary"]["freq_conv_stack"]
    conv_entry = {
        "name": "freq_conv",
        "route": "cuda",
        "source": "fullycnnspeechenhancement_torch/ops/csrc/freq_conv.cu",
        "replaces": "benchmarks/micro_pallas_conv.py:54",
        "also_replaces": [p["name"] for p in probe_path["rows"] if p["kernel"] == "freq_conv"],
        "launches": conv_sum["launches"],
        "max_abs_err": max(conv_sum["max_abs_err"], v2["max_abs_err"]),
        "ms": v2["ms"],
        "plain_ms": v2["plain_ms"],
        "bound_ms": v2["bound_ms"],
        "bound_by": v2["bound_by"],
        "library_ms": v2["cudnn_ms"],
        "library": "F.conv2d (cuDNN, TF32 off), one call per layer",
        "mma_sync_tf32_tflops": mma_rate,
        # computed from this run's inputs, plans and the rate above, not timed
        "derived": {
            "bound_fp32_simt_ms": v2["bound_fp32_simt_ms"],
            "padded_product_ratio": v2["padded_product_ratio"],
            "mma_sync_floor_ms": v2["mma_sync_floor_ms"],
        },
        "at": "V2's 14 inner layers at 64 x 8 s, summed; launches on the probe path",
    }
    deep = chain[max(chain)]
    chain_entry = {
        "name": "freq_conv_stack",
        "route": "cuda",
        "source": "fullycnnspeechenhancement_torch/ops/csrc/freq_conv.cu",
        "replaces": "benchmarks/micro_pallas_roll.py:73",
        "also_replaces": [p["name"] for p in probe_path["rows"] if p["kernel"] == "freq_conv_stack"],
        "launches": stack_sum["launches"],
        "max_abs_err": max(stack_sum["max_abs_err"], deep["max_abs_err"]),
        "max_rel_err": max(stack_sum["max_rel_err"], deep["max_rel_err"]),
        "ms": deep["ms"],
        "device_ms": deep["device_ms"],
        "plain_ms": deep["plain_ms"],
        "bound_ms": deep["bound_ms"],
        "bound_by": deep["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes a chain of masked circular convs",
        "chained_freq_conv_ms": deep["chained_ms"],
        "chained_freq_conv_device_ms": deep["chained_device_ms"],
        "other_plans_device_ms": {k: deep[k] for k in STACK_PLAN_ALTERNATIVES},
        # computed from this run's inputs, plan and mma.sync's rate, not timed
        "derived": {
            "bound_fp32_simt_ms": deep["bound_fp32_simt_ms"],
            "padded_product_ratio": deep["padded_product_ratio"],
            "mma_sync_floor_ms": deep["mma_sync_floor_ms"],
        },
        "at": f"roll2's shape, depth {max(chain)}; launches on the probe path",
    }
    entries = [stack_entry, dw_entry, conv_entry, chain_entry]
    for e in entries:
        e["kernel_ms"] = e["ms"]
    kernels = {"kernels": entries}
    log(json.dumps(kernels))
    log(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
