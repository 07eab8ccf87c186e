#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (written
for an H100) and `nvcc`.  It imports only the port
(`fullycnnspeechenhancement_torch`), never JAX, and in order:

  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels for sm_90a, one `nvcc` per source, started
     together (`ops/csrc/rced_stack.cu`, `ops/csrc/rced_edges.cu`,
     `ops/csrc/blocked_dw.cu`, `ops/csrc/freq_conv.cu`), and prints their ptxas lines and build
     times; beside them the native host runtime (g++, `runtime/*.cc`:
     decode, resample, mixing, PESQ) and a probe of mma.sync's TF32 and
     bf16 rates and of wgmma's bf16 rate (MMA_RATE_SRC), measured once here
     and used by phases 7, 7b, 11 and 11c (both kernels issue mma.sync in
     3xTF32, conv_layer_bf16 mma.sync in bf16, the bf16 stack and dW
     kernels wgmma); and holds wgmma's K-major descriptors without swizzle,
     as the bf16 stack kernel builds them, against their model
     (WG_PROBE_CASES: overlapping and pad blocks among them), exactly;

  The serving path (the fused inference kernel, `rced_stack`):
  3. builds two V2 inference engines at full width from one npz of random
     weights (torch.Generator seed 0, randomised BN state): one with
     `fused_inference=True` (the kernel path), one without (cuDNN layer by
     layer, TF32 off);
  4. serves three requests (1.5 s, 6 s, 30 s: the 2, 8 and 32 s buckets)
     and one wav file through the fused engine, with the kernel's launch
     count and the two edge kernels' set to 0 just before and read just
     after: each must be 4;
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
 7b. the stack's bf16 operand mode, which `fused_inference_forward(dtype=
     "bfloat16")` reaches (as in JAX, no engine or config routes to it):
     the three requests through it with both bf16 launch counts set to 0
     just before and read just after (3 of the wgmma kernel, 0 of
     conv_layer_bf16), each output within 0.05 * max of the float32 fused
     forward's; the wgmma kernel against its plain bf16 mode and against
     conv_layer_bf16 (`stack_forward_mma_sync`) at the requests' B=1 shapes,
     for V1/V2/V3 at B=2, T=70 and T=45 and at 64 x 8 s (median difference
     within 1e-6 of max|plain|, none past 2^-6 of it: see BF16_STACK_*),
     each launch repeated bit for bit, one inner layer at rtol 1e-4, atol
     1e-5 * max|plain| (both kernels); its time at 64 x 8 s beside
     conv_layer_bf16, the 3xTF32 kernel, the plain bf16 mode and cuDNN's
     stack in bf16, the bf16 bound, its padded products and the floor
     wgmma's rate sets, conv_layer_bf16's mma.sync floor, and both launch
     plans;
 7c. the fused forward's edge kernels (`ops/csrc/rced_edges.cu`: layer 1
     and the (1, 129) projection, float32 on the CUDA cores) at B=1,
     T=25,999 (a 416 s call), T=124 (2 s) and 64 x 8 s: each against its
     plain version (`conv2d_same`, and the ReLU, through cuDNN with TF32
     off) at atol 1e-5 * max|plain|, each launch repeated bit for bit;
     each one's device time a call (torch.profiler) and back-to-back call
     time (CUDA events) beside `conv2d_same` through cuDNN (`library_ms`),
     the plain version and the float32 SIMT floor of the products that
     meet a real input (67 TFLOP/s) and its bytes (3.35 TB/s); their
     launch plans;

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
 11a. a second `cli.train` with the TPU training profile's own dtype,
     `compute_dtype=bfloat16` (with the host loader; phase 17 runs the
     profile's device cache), one epoch
     on phase 8's corpus with validation after it, the bf16 dW kernels'
     launch counts set to 0 just before and read just after: 14 per step
     (8 steps) through the wgmma kernel, none through the bf16 mma.sync
     one, no float32 launch, every loss finite, the checkpoint written,
     params float32, the validation pass's scores finite;
 11b. bf16 parity: two trainers from phase 9's initial state on its 4
     batches under bf16, with and without dw_pallas: losses within rtol
     1e-2, Adam's moments within PARITY_MOMENT_TOL_BF16 of their scale;
     the per-step loss difference from phase 9's float32 run is logged,
     not gated;
 11c. the bf16 dW kernel (wgmma, fed by TMA) against its plain version
     for V2's 14 layers at 64 x 8 s and at B=3, T=37 (rtol 1e-4, atol
     1e-4 * max|plain|), each launch repeated bit for bit, no launch of
     the bf16 mma.sync kernel; its time over the 14 layers beside that
     kernel (`blocked_dw_mma_sync`, held against it within DW_TOL), the
     3xTF32 kernel's (phase 11), its plain version and `conv2d_weight` on
     bf16 inputs, its launch plan per layer (tile, ring of stages, splits,
     cluster), its bf16 bound (bytes), the floor wgmma's rate (phase 2)
     sets on the products it computes, and the mma.sync design's floor;
     the bf16 train step with dw_pallas on and off beside phase 11's
     float32 step, and one bf16 dispatch's device-busy time;
 11d. `ops.bn_chain` alone on V2's 15 BN layers in bf16 at 64 x 384
     frames with a batch-max mask of 281 (the training cell's batch):
     each layer's output, BN state and gradients (y, b, gamma, beta,
     skip) against the plain chain (`chain_plain`) in float64 on the
     same values, within the card tests' CHAIN_TOL; each stage's device
     time (moments, apply, grad sums, grad apply) beside its least bytes
     at 3.35 TB/s, the chain's forward and backward beside the plain
     chain's, and the least time `bn_chain_roofline` counts.  Phases 8,
     11a, 17 and 19 require each of its four launch counts at 15 a step
     (one a BN layer), and each validation pass the forward's two at 15
     a batch;
 11e. `ops.proj_train` (the final (1, 129) projection of the bf16 blocked
     step) alone at 64 x 384 frames: its forward, dX, dW and db against
     the plain projection in float64 within the card tests' PROJ_TOL, dX's
     pad band 0, each kernel's device time beside the three passes' least
     time (bytes) and cuDNN's forward and backward (`library_ms`).  Phases
     11a, 17 and 19's bf16 run require one forward, one dX and one dW
     launch a step and each validation pass forward launches alone; phases
     8 and 19's float32 run (the projection on cuDNN) none;

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
  The streaming path (`streaming.py`, `cli/stream`; plain torch, as the
  JAX streamer calls `model.apply`):
 16. builds a `StreamingDenoiser` on the card with phase 3's V2 weights,
     pushes a 30 s speech-like recording at 8 frames (1,024 samples) a
     push and holds the stream against the whole-utterance overlap-add
     path on the card (analysis, the model in eval mode,
     `WaveformRebuilder(mode="overlap_add")`; rtol 1e-3, atol 2e-3, the
     tolerances of tests/test_streaming.py), against the same streamer on
     the CPU and against 4 frames a push (atol 1e-5 * max|reference|);
     logs the push times; then runs `cli.stream.main` on a 6 s wav and
     logs its report (rtf, push p50 and p95, budget, latency);

  The device-cache training path (`data/device_cache.py`,
  `train/cached_step.py`; the bf16 dW kernel on `wgmma` again):
 17. on phase 8's corpus, `cli.train` with the TPU training profile as
     written (`use_device_cache=True`, bf16, blocked, batch 64,
     steps_per_call 8) plus dw_pallas, the bf16 dW kernels' launch counts
     set to 0 just before and read just after each run: (a) the resident
     cache, two epochs with validation after the second: 14 launches a
     step through the wgmma kernel, none through the bf16 mma.sync one,
     none float32; two 8-step dispatches; every loss finite, the
     checkpoints written, the validation scores finite; one cached
     steps_per_call=8 dispatch's idle share under the profiler; (b) the
     rotating cache over the corpus listed three times, its budget set for
     3 shards of at least 8 batches of one bucket each, spilled under the
     temp dir, two epochs: the same launch counts, floor(batches / 8)
     8-step dispatches a shard, every manifest item trained once an
     epoch, `generation` once per commit, every loss finite,
     `torch.cuda.max_memory_allocated` logged; (c) parity in float32 from
     phase 9's initial state: every batch the cache rebuilds on the card
     against the host loader's (clean bit for bit, the mix within 2
     float32 spacings of its largest term), then an epoch each: losses
     within rtol 1e-3, params within rtol 1e-3, atol 1e-4; logs each
     cached epoch's audio-s/s with its cache build and commit seconds,
     beside phase 11a's host-loader epoch and the ceiling phase 11c's bf16
     step sets, not gated;

  The export path (`export.py`, `cli/export`):
 18. `cli.export.main` from phase 8's last checkpoint writes the npz and
     the `torch.export` artefact; each, reloaded on the card, gives the
     engine's plain forward on a 6 s request within 1e-5 of max|ref|;
  The data-parallel path (`parallel/`, the DP `Trainer`; the dW kernel on
  every rank), time-sharded serving and dataset preparation:
 19. two ranks spawned on the one card join a gloo group (NCCL refuses
     two ranks on one device; the log says so) and each runs `cli.train`
     with `data_parallel=2`: phase 8's float32 profile for its 16 steps
     (32 rows a rank, the host loader), then the bf16 `_tpu` profile as
     written (the resident device cache) for 8 steps, each rank's dW
     launch counts set to 0 just before and read just after each run:
     14 `blocked_dw` launches a step a rank in float32, 14
     `dw_wgmma_kernel` ones in bf16, none of the others; the float32 run
     against phase 8's single-process run from the same initial state on
     the same global batches (per-step losses rtol 1e-3; Adam's moments
     within PARITY_MOMENT_TOL of their global scale, the params' change
     over the run within PARITY_UPDATE_TOL of its norm, every parameter
     within twice the run's summed lr of phase 8's, the BN moving
     statistics rtol 1e-3, atol 1e-5, each leaf's largest error logged),
     the bf16 run against phase 17a's first epoch (losses, Adam's
     moments and each BN statistic against its scale within phase 11b's
     budget, the params' change within PARITY_UPDATE_TOL); each rank's
     step time, all-reduces and their time in one step, and rank 0's idle
     share, for the record only (two ranks on one card measure no
     scaling);
     then a one-rank NCCL group all-reduces on the card;
 20. phase 3's fused V2 engine built with `mesh=make_mesh(4, devices=
     [cuda:0] * 4)`: a 60 s request (past the 32 s top bucket) through the
     time-sharded halo forward, within 1e-4 of max|ref| of the meshless
     engine's; a 6 s request through the bucketed path, equal to the
     meshless engine's bit for bit; both timed, not gated;
 21. an aishell_1-shaped tree and a noise tree of made-up 16 kHz wavs
     through the port's `data.prepare.aishell_1` and `noise` to 8 kHz
     manifests, read back through `SpeechDataset` (host code, a quick
     check);
  The quality path (`quality.py`: does the port learn?  Run before 22's
  line is printed):
 23. `quality.run_quality` (benchmarks/quality_run.py's recipe: 32
     speech-like utterances of 2 s and a 10 s noise file, V2 with blocked
     compute, batch 8, lr 1.5e-3, warmup 100, steps_per_call 4, through
     the Trainer) with dw_pallas and fused scoring (QUALITY_RUNS): bf16
     from the resident cache for 60 epochs (240 steps), bf16 from the
     rotating cache (3 shards) for 60 epochs (300 steps) and float32 from
     the resident cache (240 steps), each from the v5e's start (the JAX
     Trainer's PRNGKey(0) init, tests/fixtures/
     quality_v2_init_jax_prngkey0.npz) and again from the port's own init,
     every kernel's launch counts set to 0 just before each run and read
     just after: 14 `dw_wgmma_kernel` launches a step and none of the bf16
     mma.sync or float32 dW kernels under bf16, 14 3xTF32 `blocked_dw`
     launches a step and no bf16 one in float32, and one float32
     `rced_stack` launch a scoring call (4 held-out utterances, untrained
     and trained: 8), none bf16; every run scores PESQ with `p862-native`
     and holds each fused held-out prediction within MAIN_TOL of
     max|unfused| of the unfused float32 forward; the runs from the v5e's
     start must meet tests/test_quality.py's three margins (the last loss
     under 0.75x the first, held-out SDR more than 0.7 dB and STOI more
     than 0.06 over the mix's), the runs from the port's own init record
     theirs; each run's JSON line is printed beside the TPU v5e's table
     from benchmarks/PERF_NOTES.md, marked as a TPU's reference;
 22. prints a `kernels` JSON line (ten entries: `rced_stack` in float32
     and in bf16, each with its "dtype", the bf16 `rced_stack` the wgmma
     kernel with conv_layer_bf16's time as `mma_sync_ms`, the edge kernels
     `rced_first` and `rced_proj` (phase 7c; launches phase 4's), then
     `blocked_dw` in float32 and in bf16, `freq_conv`,
     `freq_conv_stack`, `bn_chain` and `proj_train`, the last two with
     their launches by path; the float32 `rced_stack`'s
     launches are the serving path's and the evaluation path's, each also
     by path, and its max_abs_err covers phases 6, 7 and 15; the bf16
     `blocked_dw`'s launches are the host loader's (11a) and both device
     caches' (17a, 17b) and the DP ranks' (19), each also by path; the
     float32 `blocked_dw`'s the single-process run's (8) and the DP
     ranks' (19); phase 23's runs are `quality_*` paths of the three,
     its scoring under `rced_stack`), the card line again, and
     last the line {"ok": true, "device": {...}}.

Each phase prints its wall time.  Any failed phase raises, so the script
exits non-zero and prints no last line.  Without CUDA it exits 1 at once.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): float32 without tensor cores, TF32
# and bf16 on them.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
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
# bf16 training (phases 11a-11c): one epoch, validation after it.
EPOCHS_BF16 = 1
# dw_pallas on against off under bf16: losses (rtol) and Adam's moments
# against their global scale after each step.  Both round dW to bf16, the
# kernel from float32 sums and cuDNN from its own, so a dW differs by one
# bf16 ulp (at most 2^-8 of the largest) where its sum lies near a
# rounding boundary, and later steps' forward passes drift from there.
# Measured on an H100: at most 6.4e-4 of the moments' scale over 4 steps.
PARITY_LOSS_RTOL_BF16 = 1e-2
PARITY_MOMENT_TOL_BF16 = 2.0**-8
# The bf16 stack against its plain bf16 mode (tests/test_torch_cuda.py,
# BF16_STACK_*): each layer rounds its float32 input to bf16, and where the
# two float32 sums differ in the last bit at a rounding boundary an
# operand differs by one bf16 ulp: the median difference stays at
# float32's level, no difference past 2^-6 of max|plain|.
BF16_STACK_MEDIAN = 1e-6
BF16_STACK_MAX = 2.0**-6
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


def chain_launches() -> tuple:
    """`ops.bn_chain`'s launch counts: moments, apply, grad sums, grad apply."""
    from fullycnnspeechenhancement_torch.ops import bn_chain

    return (bn_chain.launches_moments, bn_chain.launches_apply, bn_chain.launches_grad_sums,
            bn_chain.launches_grad_apply)


def proj_launches() -> tuple:
    """`ops.proj_train`'s launch counts: forward, dX, dW."""
    from fullycnnspeechenhancement_torch.ops import proj_train

    return proj_train.launches_fwd, proj_train.launches_dx, proj_train.launches_dw


def reset_chain_launches() -> None:
    """Sets `ops.bn_chain`'s and `ops.proj_train`'s launch counts to 0."""
    from fullycnnspeechenhancement_torch.ops import bn_chain, proj_train

    bn_chain.launches_moments = bn_chain.launches_apply = bn_chain.launches_grad_sums = 0
    bn_chain.launches_grad_apply = 0
    proj_train.launches_fwd = proj_train.launches_dx = proj_train.launches_dw = 0


# each training path's `ops.bn_chain` launches (all four stages), for the
# `kernels` line
CHAIN_LAUNCHES = {}


def check_chain_launches(what: str, launches: tuple, n_bn: int, steps: int, validations=()) -> None:
    """Raise unless each stage of `ops.bn_chain` ran once a BN layer a step
    besides the validation passes of `validations` (`timed_validation`'s
    entries), and each of those ran the forward's two stages (moments,
    apply) once a BN layer a batch and no backward stage."""
    for epoch, _, _, chain, _ in validations:
        m, a, gs, ga = chain
        if m != a or m < n_bn or m % n_bn or gs or ga:
            raise AssertionError(f"{what}: validation after epoch {epoch} launched bn_chain {chain} (moments, "
                                 f"apply, grad sums, grad apply), expected k * {n_bn}, k * {n_bn}, 0, 0 for k >= 1")
        launches = tuple(n - v for n, v in zip(launches, chain))
    if steps < 1 or any(n != n_bn * steps for n in launches):
        raise AssertionError(f"{what}: bn_chain launched {launches} (moments, apply, grad sums, grad apply) in "
                             f"{steps} steps besides validation, expected {n_bn * steps} each")
    CHAIN_LAUNCHES[what] = sum(launches)


# each training path's `ops.proj_train` launches (all three kernels), for
# the `kernels` line
PROJ_LAUNCHES = {}


def check_proj_launches(what: str, launches: tuple, steps: int, bf16: bool, validations=()) -> None:
    """Raise unless a bf16 path launched `ops.proj_train`'s forward, dX and
    dW once a step besides the validation passes of `validations`, and
    each of those the forward alone, once a batch; and unless a float32
    path (the projection on cuDNN) launched none."""
    for epoch, _, _, _, proj in validations:
        fwd, dx, dw = proj
        if dx or dw or (fwd < 1 if bf16 else fwd):
            raise AssertionError(f"{what}: validation after epoch {epoch} launched proj_train {proj} (forward, "
                                 f"dX, dW), expected ({'k >= 1' if bf16 else 0}, 0, 0)")
        launches = tuple(n - v for n, v in zip(launches, proj))
    want = (steps,) * 3 if bf16 else (0, 0, 0)
    if steps < 1 or tuple(launches) != want:
        raise AssertionError(f"{what}: proj_train launched {tuple(launches)} (forward, dX, dW) in {steps} steps "
                             f"besides validation, expected {want}")
    if bf16:
        PROJ_LAUNCHES[what] = sum(launches)


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


def check_bf16_stack(name, got, ref) -> float:
    """Raise unless the bf16 stack `got` is within BF16_STACK_MAX of
    max|ref| everywhere and its median difference over the elements where
    `ref` is not 0 within BF16_STACK_MEDIAN of it; returns the largest
    absolute difference."""
    got, ref = got.double(), ref.double()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}, or non-finite values")
    scale = ref.abs().max().item()
    err = (got - ref).abs()
    median = err[ref != 0].median().item()
    if err.max().item() > BF16_STACK_MAX * scale or median > BF16_STACK_MEDIAN * scale:
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e}, median {median:.3e} "
                             f"of max|plain| {scale:.3e}")
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


def run_serving(dev, tmp: str, mma_rate: float, rate_bf16: float, rate_wgmma: float):
    """Phases 3-7b: the serving path through the fused kernel, then the
    stack's bf16 mode.  Returns the `rced_stack` entries of the `kernels`
    line, float32 and bf16."""
    from fullycnnspeechenhancement_torch import Config, ModelConfig
    from fullycnnspeechenhancement_torch.data.audio_io import read_wav, write_wav
    from fullycnnspeechenhancement_torch.infer import InferenceEngine
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.models.blocks import conv2d_same
    from fullycnnspeechenhancement_torch.ops import rced_edges, rced_stack
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
    rced_edges.launches_first = rced_edges.launches_proj = 0
    outs = []
    for sig in requests:
        t0 = time.perf_counter()
        outs.append(fused.denoise_array(sig))
        log(f"request {len(sig) / 8000:.1f} s: {1e3 * (time.perf_counter() - t0):.1f} ms (first call)")
    out_path = fused.denoise(wav_in, save_path=os.path.join(tmp, "fused"))
    launches = rced_stack.launches
    edge_launches = (rced_edges.launches_first, rced_edges.launches_proj)
    log(f"main path: rced_stack launches {launches}, rced_first {edge_launches[0]}, rced_proj {edge_launches[1]}")
    if launches != 4 or edge_launches != (4, 4):
        raise AssertionError(f"rced_stack and the edge kernels launched {launches} and {edge_launches} times on "
                             "the main path, expected 4 each")

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
        y1r = rced_edges.first_forward(pk.edges, mag1)
        zr = rced_stack.stack_forward(pk, y1r)
        pred = rced_edges.proj_forward(pk.edges, zr)
        stages = {
            "analysis": cuda_ms(lambda: fused.ext.magnitude_and_phase(wav, lengths), 20),
            "layer1_kernel": cuda_ms(lambda: rced_edges.first_forward(pk.edges, mag1), 20),
            "layer1_cudnn": cuda_ms(lambda: conv2d_same(mag1[:, None], *pk.first[1:]), 20),
            "inner_kernel": cuda_ms(lambda: rced_stack.stack_forward(pk, y1r), 20),
            "last_kernel": cuda_ms(lambda: rced_edges.proj_forward(pk.edges, zr), 20),
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

    entry = {
        "name": "rced_stack",
        "dtype": "float32",
        "route": "cuda",
        "source": "fullycnnspeechenhancement_torch/ops/csrc/rced_stack.cu",
        "replaces": "fullycnnspeechenhancement_tpu/ops/pallas_rced.py:135",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_note": "3xTF32 on the tensor cores at the data sheet's TF32 rate",
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
    t0 = time.perf_counter()
    entry_bf16 = run_stack_bf16(dev, fused, requests, rate_bf16, rate_wgmma, pk)
    phase("stack bf16 mode", t0)
    t0 = time.perf_counter()
    edge_entries = run_edges(dev, fused, edge_launches)
    phase("edge kernels", t0)
    return entry, entry_bf16, edge_entries


def run_edges(dev, fused, launches) -> list:
    """Phase 7c: the fused forward's edge kernels on the fused engine's
    V2 pack, at a 416 s call, a 2 s request and 64 x 8 s; `launches` are
    phase 4's counts.  Returns their two entries of the `kernels` line."""
    from fullycnnspeechenhancement_torch.models.blocks import conv2d_same
    from fullycnnspeechenhancement_torch.ops import rced_edges

    e = fused._packed.edges
    g = torch.Generator().manual_seed(11)
    shapes = [(1, 25999), (1, fused.ext.num_frames(2 * 8000)), (64, fused.ext.num_frames(8 * 8000))]
    rows = {"rced_first": [], "rced_proj": []}
    for B, T in shapes:
        mag = (10 * torch.rand(B, T, 129, generator=g)).to(dev)
        z = (torch.rand(B, e.proj_channels, T, 129, generator=g) - 0.5).to(dev)
        macs = [B * m for m in rced_edges.edge_macs(e, T)]
        cases = (
            ("rced_first", lambda: rced_edges.first_forward(e, mag), lambda: rced_edges.first_plain(e, mag),
             lambda: conv2d_same(mag[:, None], e.w1, e.b1), macs[0], 4 * B * T * 129 * (1 + e.channels),
             rced_edges.first_plan(B, T)._asdict()),
            ("rced_proj", lambda: rced_edges.proj_forward(e, z), lambda: rced_edges.proj_plain(e, z),
             lambda: conv2d_same(z, e.w_last, e.b_last), macs[1], 4 * B * T * 129 * (e.proj_channels + 1),
             rced_edges.proj_plan(B, T)._asdict()),
        )
        for name, kern, plain, library, mac, nbytes, plan in cases:
            got, again, ref = kern(), kern(), plain()
            if not torch.equal(got, again):
                raise AssertionError(f"{name} B={B} T={T}: two launches differ")
            err = check_close(f"{name} B={B} T={T}", got, ref, 0.0, 1e-5 * ref.abs().max().item())
            reps = 20 if B * T > 4000 else 200
            row = {
                "B": B, "T": T, "max_abs_err": err, "max_abs_plain": ref.abs().max().item(),
                "ms": cuda_ms(kern, reps),
                "device_ms": device_busy_ms(kern, reps)[1],
                "library_ms": cuda_ms(library, reps),
                "library_device_ms": device_busy_ms(library, reps)[1],
                "plain_ms": cuda_ms(plain, reps),
                "fp32_simt_floor_ms": 2 * mac / PEAK_FP32_FLOPS * 1e3,
                "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                "macs": mac, "bytes": nbytes, "plan": plan,
            }
            bound = max(row["fp32_simt_floor_ms"], row["bytes_ms"])
            dev_ms = row["device_ms"] if row["device_ms"] is not None else row["ms"]
            log(f"{name} V2 B={B} T={T}: device {dev_ms * 1e3:.2f} us ({row['ms'] * 1e3:.2f} us a call back to "
                f"back), cuDNN conv2d_same {row['library_ms'] * 1e3:.2f} us (device "
                f"{(row['library_device_ms'] or float('nan')) * 1e3:.2f}), plain {row['plain_ms'] * 1e3:.2f} us; "
                f"float32 SIMT floor {row['fp32_simt_floor_ms'] * 1e3:.2f} us ({mac:.4e} multiply-adds), bytes "
                f"{row['bytes_ms'] * 1e3:.2f} us: {100 * bound / dev_ms:.1f}% of the floor; max abs err "
                f"{err:.3e} of max|plain| {row['max_abs_plain']:.3e}; plan {plan}")
            rows[name].append(row)
    entries = []
    for name, launched in zip(rows, launches):
        long = rows[name][0]
        bound = max(long["fp32_simt_floor_ms"], long["bytes_ms"])
        entries.append({
            "name": name,
            "dtype": "float32",
            "route": "cuda",
            "source": "fullycnnspeechenhancement_torch/ops/csrc/rced_edges.cu",
            "replaces": None,
            "replaces_note": "no TPU kernel: the JAX package leaves layer 1 and the projection to XLA convs",
            "launches": launched,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": long["device_ms"] if long["device_ms"] is not None else long["ms"],
            "plain_ms": long["plain_ms"],
            "bound_ms": bound,
            "bound_by": "operations" if long["fp32_simt_floor_ms"] >= long["bytes_ms"] else "bytes",
            "bound_note": "float32 on the CUDA cores at the data sheet's 67 TFLOP/s",
            "library_ms": long["library_ms"],
            "library": "conv2d_same (F.pad and F.conv2d, cuDNN, TF32 off)",
            "at": "V2, B = 1, T = 25,999 (a 416 s call); launches on the serving path",
            "by_shape": rows[name],
        })
    return entries


def against_mma_sync(name, pk, x, got) -> float:
    """Holds the wgmma kernel's output `got` on `x` against conv_layer_bf16
    (`stack_forward_mma_sync`, BF16_STACK_*) and a second launch of the
    wgmma kernel (bit for bit); returns the largest difference from
    conv_layer_bf16."""
    from fullycnnspeechenhancement_torch.ops import rced_stack

    if not torch.equal(rced_stack.stack_forward(pk, x), got):
        raise AssertionError(f"{name}: a second launch of the wgmma kernel differs")
    return check_bf16_stack(f"{name} vs conv_layer_bf16", got, rced_stack.stack_forward_mma_sync(pk, x))


def run_stack_bf16(dev, fused, requests, rate_bf16: float, rate_wgmma: float, pk32) -> dict:
    """Phase 7b: the fused stack's bf16 operand mode, which
    `fused_inference_forward(dtype="bfloat16")` reaches (as in JAX, no
    engine or config routes to it).  The main path: the three requests'
    magnitudes through it with the bf16 launch count set to 0 just before
    and read just after (3), each output finite and within 0.05 * max of
    the float32 fused forward's (the JAX package's bound for its bf16
    mode), and the kernel at each of those B=1 shapes against its plain
    bf16 mode (check_bf16_stack).  Then the same for V1/V2/V3 at
    B=2, T=70 and T=45 and at 64 x 8 s (check_bf16_stack), one inner layer
    at float32's tolerance, and its time at 64 x 8 s beside the float32
    kernel, the plain bf16 mode and cuDNN's stack in bf16, its bf16 bound,
    mma.sync's bf16 floor and the bf16 instance's launch plan (its
    occupancy from the CUDA calculator).  Returns its `kernels` entry."""
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.models.blocks import conv2d_same
    from fullycnnspeechenhancement_torch.models.rced import ConvSpec, ModelDef
    from fullycnnspeechenhancement_torch.ops import rced_stack

    model, params, bn = fused.model, fused.params, fused.bn_state
    pk = rced_stack.pack_inference_stack(model, params, bn, "bfloat16")
    mags = []
    for sig in requests:
        wav = torch.zeros(1, fused._pad_len(len(sig)), device=dev)
        wav[0, : len(sig)] = torch.as_tensor(sig, device=dev)
        mags.append(fused.ext(wav, torch.tensor([len(sig)], dtype=torch.int32, device=dev)))
    if not rced_stack.takes_wgmma(pk):
        raise AssertionError("V2's bf16 pack does not take the wgmma kernel")
    rced_stack.launches_bf16 = rced_stack.launches_bf16_wgmma = 0
    outs = [rced_stack.fused_inference_forward(model, params, bn, mag, packed=pk, dtype="bfloat16")
            for mag in mags]
    torch.cuda.synchronize()
    launches, launches_old = rced_stack.launches_bf16_wgmma, rced_stack.launches_bf16
    log(f"stack bf16 main path: rced_stack bf16 launches {launches} (wgmma kernel), {launches_old} (conv_layer_bf16)")
    if launches != len(mags) or launches_old != 0:
        raise AssertionError(f"rced_stack bf16 launched the wgmma kernel {launches} times and conv_layer_bf16 "
                             f"{launches_old} times for {len(mags)} calls, expected {len(mags)} and 0")
    max_err = 0.0
    for mag, out in zip(mags, outs):
        ref = rced_stack.fused_inference_forward(model, params, bn, mag, packed=pk32)
        err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
        log(f"fused bf16 T={mag.shape[1]}: {err:.3e} from the float32 fused forward ({err / scale:.3e} of max)")
        if not torch.isfinite(out).all() or err > 0.05 * scale:
            raise AssertionError(f"fused bf16 T={mag.shape[1]}: {err:.3e} from float32, max {scale:.3e}")
        # the kernel at the main path's own B=1 shape, against its plain bf16 mode
        y1 = torch.relu(conv2d_same(mag[:, None], *pk.first[1:])).contiguous()
        got = rced_stack.stack_forward(pk, y1)
        e = check_bf16_stack(f"V2 B=1 T={mag.shape[1]} bf16", got, rced_stack.stack_forward_plain(pk, y1))
        e_old = against_mma_sync(f"V2 B=1 T={mag.shape[1]}", pk, y1, got)
        max_err = max(max_err, e)
        log(f"kernel bf16 V2 B=1 T={mag.shape[1]}: max abs err vs plain bf16 {e:.3e}, vs conv_layer_bf16 "
            f"{e_old:.3e}; repeats bit for bit")

    for name in ("FullyCNN", "FullyCNNV2", "FullyCNNV3"):
        m = get_model(name)
        p, st = m.init(torch.Generator().manual_seed(1), device=dev)
        st = randomized_bn(st, seed=2)
        pkb = rced_stack.pack_inference_stack(m, p, st, "bfloat16")
        pkf = rced_stack.pack_inference_stack(m, p, st)
        for T in (70, 45):
            mag = torch.as_tensor(np.random.default_rng(T).random((2, T, 129), dtype=np.float32), device=dev)
            y1 = torch.relu(conv2d_same(mag[:, None], *pkb.first[1:])).contiguous()
            got = rced_stack.stack_forward(pkb, y1)
            e = check_bf16_stack(f"{name} T={T} bf16", got, rced_stack.stack_forward_plain(pkb, y1))
            e_old = against_mma_sync(f"{name} T={T}", pkb, y1, got)
            f32 = rced_stack.stack_forward_plain(pkf, y1)
            if (got - f32).abs().max() > 0.05 * f32.abs().max():
                raise AssertionError(f"{name} T={T}: bf16 stack past 0.05 * max of float32")
            max_err = max(max_err, e)
            log(f"kernel bf16 {name} B=2 T={T}: max abs err vs plain bf16 {e:.3e}, vs conv_layer_bf16 {e_old:.3e}")
    one = ModelDef("one_layer", (ConvSpec("a", 19, (8, 5)), ConvSpec("b", 32, (1, 13)),
                                 ConvSpec("c", 1, (1, 129), use_norm=False, use_act=False)))
    p1, s1 = one.init(torch.Generator().manual_seed(3), device=dev)
    pk1 = rced_stack.pack_inference_stack(one, p1, randomized_bn(s1, seed=4), "bfloat16")
    x1 = torch.rand(2, 19, 45, 129, generator=torch.Generator().manual_seed(5)).to(dev)
    ref1 = rced_stack.stack_forward_plain(pk1, x1)
    e = check_close("one layer bf16", rced_stack.stack_forward(pk1, x1), ref1, 1e-4, 1e-5 * ref1.abs().max().item())
    e_old = check_close("one layer bf16 conv_layer_bf16", rced_stack.stack_forward_mma_sync(pk1, x1), ref1, 1e-4,
                        1e-5 * ref1.abs().max().item())
    max_err = max(max_err, e)
    log(f"kernel bf16 one layer (kw 13, 19 -> 32 channels): max abs err vs plain bf16 {e:.3e} "
        f"(conv_layer_bf16 {e_old:.3e})")

    B, T = 64, fused.ext.num_frames(8 * 8000)
    mag = torch.as_tensor(np.random.default_rng(7).random((B, T, 129), dtype=np.float32), device=dev)
    y1 = torch.relu(conv2d_same(mag[:, None], *pk.first[1:])).contiguous()
    got = rced_stack.stack_forward(pk, y1)
    e = check_bf16_stack(f"V2 B={B} T={T} bf16", got, rced_stack.stack_forward_plain(pk, y1))
    e_old = against_mma_sync(f"V2 B={B} T={T}", pk, y1, got)
    log(f"kernel bf16 V2 B={B} T={T}: max abs err vs plain bf16 {e:.3e}, vs conv_layer_bf16 {e_old:.3e}; "
        f"repeats bit for bit")
    max_err = max(max_err, e)
    f32 = rced_stack.stack_forward(pk32, y1)
    if (got - f32).abs().max() > 0.05 * f32.abs().max():
        raise AssertionError("V2 64 x 8 s: bf16 stack past 0.05 * max of float32")
    folded = rced_stack.fold_bn_inference(model, params, bn)
    folded16 = [(spec, w.to(torch.bfloat16), b.to(torch.bfloat16)) for spec, w, b in folded]
    y1_16 = y1.to(torch.bfloat16)
    del got, f32
    # in turns: the wgmma kernel, conv_layer_bf16, the others, then both again
    kernel_ms = cuda_ms(lambda: rced_stack.stack_forward(pk, y1), reps=20)
    old_ms = cuda_ms(lambda: rced_stack.stack_forward_mma_sync(pk, y1), reps=20)
    f32_ms = cuda_ms(lambda: rced_stack.stack_forward(pk32, y1), reps=20)
    plain_ms = cuda_ms(lambda: rced_stack.stack_forward_plain(pk, y1), reps=3, warmup=1)
    cudnn_ms = cuda_ms(lambda: inner_stack_cudnn(folded16, y1_16), reps=10)
    old_ms_2 = cuda_ms(lambda: rced_stack.stack_forward_mma_sync(pk, y1), reps=20)
    kernel_ms_2 = cuda_ms(lambda: rced_stack.stack_forward(pk, y1), reps=20)
    flop, nbytes = stack_work(pk, B, T)
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    plan = rced_stack.wgmma_launch_plan(pk, B * T, rced_stack.card_wgmma_blocks_per_sm(pk.wg.smem_bytes, dev),
                                        torch.cuda.get_device_properties(0).multi_processor_count)
    # the wgmma tiles' products at wgmma's rate, the edge warp's at mma.sync's
    padded, by_wgmma, by_edge = rced_stack.wgmma_padded_product_ratio(pk)
    floor_ms = flop * (by_wgmma / rate_wgmma + by_edge / rate_bf16) / 1e12 * 1e3
    old_plan = rced_stack.launch_plan(pk, rced_stack.card_blocks_per_sm(pk.smem_floats * 4, dev, "bfloat16"))
    old_padded = old_plan.padded_product_ratio
    old_floor_ms = flop * old_padded / (rate_bf16 * 1e12) * 1e3
    log(f"timing V2 inner stack bf16 at {B} x 8 s (T={T}): wgmma kernel {kernel_ms:.3f} / {kernel_ms_2:.3f} ms, "
        f"conv_layer_bf16 (mma.sync) {old_ms:.3f} / {old_ms_2:.3f} ms ({old_ms / kernel_ms:.2f}x), 3xTF32 kernel "
        f"{f32_ms:.3f} ms, plain bf16 {plain_ms:.3f} ms, cuDNN layer by layer in bf16 {cudnn_ms:.3f} ms")
    log(f"bound bf16: {flop:.4e} FLOP -> {t_ops:.3f} ms at 989 TFLOP/s; {nbytes:.4e} B -> {t_bytes:.3f} ms "
        f"at 3.35 TB/s; wgmma kernel at {100 * bound_ms / kernel_ms:.1f}% of it; its tiles pad the products "
        f"{padded:.4f}x ({by_wgmma:.4f}x by wgmma, {by_edge:.4f}x by the edge warp's mma.sync), at wgmma's "
        f"{rate_wgmma:.1f} and mma.sync's {rate_bf16:.1f} TFLOP/s (phase 2) a floor of {floor_ms:.3f} ms (kernel "
        f"at {100 * floor_ms / kernel_ms:.1f}% of it); conv_layer_bf16's m16n8k16 tiles pad them {old_padded:.4f}x, "
        f"at mma.sync's bf16 {rate_bf16:.1f} TFLOP/s a floor of {old_floor_ms:.3f} ms "
        f"(conv_layer_bf16 at {100 * old_floor_ms / old_ms:.1f}% of it)")
    log(f"launch plan bf16, wgmma kernel ({B * T} frames at {B} x 8 s): {plan._asdict()}")
    log(f"launch plan bf16, conv_layer_bf16: {old_plan._asdict()}")
    return {
        "name": "rced_stack",
        "dtype": "bfloat16",
        "route": "cuda",
        "source": "fullycnnspeechenhancement_torch/ops/csrc/rced_stack.cu",
        "replaces": "fullycnnspeechenhancement_tpu/ops/pallas_rced.py:135",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "cudnn_stack_bf16_ms": cudnn_ms,
        "float32_kernel_ms": f32_ms,
        # conv_layer_bf16, the mma.sync design this kernel replaced on the
        # main path, timed beside it
        "mma_sync_ms": old_ms,
        "mma_sync_bf16_tflops": rate_bf16,
        "wgmma_bf16_tflops": rate_wgmma,
        # computed from this run's inputs and the rates above, not timed
        "derived": {
            "padded_product_ratio": padded,
            "padded_product_ratio_wgmma": by_wgmma,
            "padded_product_ratio_edge_mma_sync": by_edge,
            "wgmma_floor_ms": floor_ms,
            "mma_sync_padded_product_ratio": old_padded,
            "mma_sync_floor_ms": old_floor_ms,
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
                    base_checkpoint: str = "", compute_dtype: str = "float32",
                    epochs: int = EPOCHS, valid_every: int = VALID_EVERY,
                    use_device_cache: bool = False, extra_data: str = "", extra_train: str = "") -> str:
    """The TPU training profile (work/aishell_1/cfg/fully_cnn_train_tpu.cfg)
    in `compute_dtype` (the profile's is bfloat16), with dw_pallas, the
    host loader unless `use_device_cache` (the profile's setting), `epochs`
    epochs, validation every `valid_every` epochs on the premixed
    validation manifest, paths under `root`, and `extra_train` and
    `extra_data` lines in [training] and [data]."""
    with open(path, "w") as f:
        f.write(
            "[training]\n"
            f"epochs={epochs}\nbatch_size={B_TRAIN}\nlr=0.0015\nwarmup_steps=10000\n"
            f"continue_train={not base_checkpoint}\n"
            f"checkpoints_path={root}/checkpoints\nbase_checkpoint_file={base_checkpoint}\n"
            f"num_iter_print=50\nlog_dir={root}/log\nsteps_per_call=8\n"
            f"valid_every_epochs={valid_every}\n{extra_train}"
            f"[model]\nnet_arch=RCED\nnet_work=FullyCNNV2\ncompute_dtype={compute_dtype}\n"
            f"blocked_compute=True\nblocked_fb=8\ndw_pallas={dw_pallas}\n"
            f"[data]\ntrain_manifest_path={corpus['clean']}\n"
            f"train_noise_manifest={corpus['noise']}\n"
            f"val_manifest_path={corpus['val']}\naudio_save_path={root}/denoise\n"
            "snr=0\nsample_rate=8000\nwindow_ms=32\nstride_ms=16\n"
            f"use_device_cache={use_device_cache}\n{extra_data}"
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


def dw_work(shapes, rows: int, nb: int, kb: int, dc: int, in_bytes: int = 4):
    """(FLOP, bytes) the dW contractions of `shapes` over `rows` rows need:
    tap d pairs only the NB - |d - dc| blocks whose shifted z block is real
    (the others meet the zero halo), z and dy (`in_bytes` a value) are read
    once and dW (float32) written once, per layer."""
    pairs = sum(max(0, nb - abs(d - dc)) for d in range(kb))
    flop = sum(2.0 * rows * pairs * ci * co for _, ci, co in shapes)
    nbytes = sum(in_bytes * rows * nb * (ci + co) + 4.0 * kb * ci * co for _, ci, co in shapes)
    return flop, nbytes


def dw_against_plain(dev, shapes, kb: int, dc: int, nb: int, gen, dtype=torch.float32) -> float:
    """The dW kernel's `dtype` instance against its plain version on
    `shapes` at B*T = 32,768 and at B=3, T=37 (rtol DW_TOL, atol DW_TOL *
    max|plain|), each launch repeated bit for bit (no atomics); returns
    the largest difference."""
    from fullycnnspeechenhancement_torch.ops import blocked_dw

    label = "blocked_dw" + ("" if dtype == torch.float32 else " bf16")
    max_err = 0.0
    for B, T in ((B_TRAIN, T_BUCKET), (3, 37)):
        for name, ci, co in shapes:
            z = torch.randn(B, T, nb, ci, device=dev, generator=gen).to(dtype)
            dy = torch.randn(B, T, nb, co, device=dev, generator=gen).to(dtype)
            got = blocked_dw.blocked_dw(z, dy, kb, dc)
            ref = blocked_dw.blocked_dw_plain(z, dy, kb, dc)
            e = check_close(f"{label} {name} B={B} T={T}", got, ref, DW_TOL,
                            DW_TOL * ref.abs().max().item())
            max_err = max(max_err, e)
            if not torch.equal(blocked_dw.blocked_dw(z, dy, kb, dc), got):
                raise AssertionError(f"{label} {name} B={B} T={T}: a second launch differs")
        log(f"{label} vs plain, 14 layers at B={B} T={T}: max abs err {max_err:.3e}, "
            f"each launch repeated bit for bit")
    return max_err


def time_dw_layers(dev, shapes, kb: int, dc: int, nb: int, gen, dtype=torch.float32, other=None):
    """Per layer of `shapes` at 64 x 8 s: the dW kernel `blocked_dw` takes
    for `dtype` (in bf16 the wgmma one), its plain version,
    `torch.nn.grad.conv2d_weight` in `dtype` (cuDNN's backward-filter, the
    yardstick, held against the kernel first) and, if given, `other` (a
    function like `blocked_dw`, held against the kernel within DW_TOL) with
    CUDA events, and the kernel's launch plan.  Returns the sums over the
    layers (kernel, plain, library, other) in ms, and the products the
    plans compute over the products needed: the tiles pad Ci and Co, and
    each row's nbp staged positions run all KB taps."""
    from fullycnnspeechenhancement_torch.ops import blocked_dw

    # cuDNN sums in its own order and, in bf16, returns dW rounded to bf16
    lib_rtol, lib_atol = (DW_TOL, DW_TOL) if dtype == torch.float32 else (2.0**-6, 1e-3)
    label = "" if dtype == torch.float32 else "bf16 "
    rows = B_TRAIN * T_BUCKET
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    k_ms = p_ms = lib_ms = other_ms = 0.0
    padded_products = 0
    for name, ci, co in shapes:
        z = torch.randn(B_TRAIN, T_BUCKET, nb, ci, device=dev, generator=gen).to(dtype)
        dy = torch.randn(B_TRAIN, T_BUCKET, nb, co, device=dev, generator=gen).to(dtype)
        zpad = torch.nn.functional.pad(z.permute(0, 3, 1, 2), (dc, kb - 1 - dc, 0, 0))
        go = dy.permute(0, 3, 1, 2)
        lib = torch.nn.grad.conv2d_weight(zpad, (co, ci, 1, kb), go)
        got = blocked_dw.blocked_dw(z, dy, kb, dc)
        check_close(f"conv2d_weight {label}{name}", lib.float(), got.permute(3, 2, 0, 1), lib_rtol,
                    lib_atol * got.abs().max().item())
        if other is not None:
            check_close(f"{label}{name} other design", other(z, dy, kb, dc), got, DW_TOL,
                        DW_TOL * got.abs().max().item())
            other_ms += cuda_ms(lambda: other(z, dy, kb, dc), reps=10)
        layer_k = cuda_ms(lambda: blocked_dw.blocked_dw(z, dy, kb, dc), reps=10)
        layer_p = cuda_ms(lambda: blocked_dw.blocked_dw_plain(z, dy, kb, dc), reps=2, warmup=1)
        layer_lib = cuda_ms(lambda: torch.nn.grad.conv2d_weight(zpad, (co, ci, 1, kb), go), reps=10)
        if blocked_dw.takes_wgmma(z, dy, kb):
            plan = blocked_dw.wgmma_plan(rows, nb, ci, co, kb, sm_count,
                                         blocked_dw.card_blocks_per_sm(kb, dev, dtype, wgmma=True))
            tci, tco, nbp = plan.tile_ci, blocked_dw.TILE_CO_WGMMA, plan.nbp
            detail = (f"tile {tco} co x {tci} ci, {plan.tiles} tiles x {plan.splits} splits of "
                      f"{plan.rows_per_split} rows, a ring of {plan.stages} stages of "
                      f"{blocked_dw.STAGE_ROWS_WGMMA} rows x {nbp} positions, cluster 1 (no multicast)")
        else:
            plan = blocked_dw.launch_plan(rows, nb, ci, co, kb, sm_count,
                                          blocked_dw.card_blocks_per_sm(kb, dev, dtype), dtype)
            tci, tco, nbp = blocked_dw.TILE, blocked_dw.tile_co(dtype), nb + kb - 1
            detail = (f"{plan.tiles} tiles x {plan.splits} splits of {plan.rows_per_split} rows, "
                      f"stages of {plan.stage_rows} rows")
        blocks, slots = plan.tiles * plan.splits, sm_count * plan.blocks_per_sm
        log(f"  {label}{name} Ci={ci} Co={co}: kernel {layer_k:.3f} ms, plain {layer_p:.3f} ms, "
            f"conv2d_weight {layer_lib:.3f} ms; plan {detail}, {plan.blocks_per_sm} blocks per SM at "
            f"{plan.smem_bytes} B, {blocks / (-(-blocks // slots) * slots):.3f} of the waves' slots")
        k_ms, p_ms, lib_ms = k_ms + layer_k, p_ms + layer_p, lib_ms + layer_lib
        padded_products += -(-ci // tci) * -(-co // tco) * tci * tco * nbp
        del z, dy, zpad, go, lib, got
    needed = sum(ci * co for _, ci, co in shapes)
    padded = padded_products / (nbp * needed)
    computed = padded_products * kb / (needed * sum(max(0, nb - abs(d - dc)) for d in range(kb)))
    return k_ms, p_ms, lib_ms, other_ms, padded, computed


def time_steps(trainers: dict, batch) -> dict:
    """ms of a whole train step on `batch` with dw_pallas on and off, in
    turns (on, off, off, on; 3 steps each after one), by dw_pallas."""
    payload = {dw: trainers[dw]._prep_single(batch) for dw in (True, False)}
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
    return step_ms


@contextlib.contextmanager
def timed_validation(validations: list):
    """Within the block, each `Trainer.validate` appends (epoch, seconds,
    results, `ops.bn_chain`'s launches within it, `ops.proj_train`'s) to
    `validations`."""
    from fullycnnspeechenhancement_torch.train import trainer as trainer_mod

    real_validate = trainer_mod.Trainer.validate

    def timed_validate(self, loader, epoch, log=None):
        v0, c0, p0 = time.perf_counter(), chain_launches(), proj_launches()
        out = real_validate(self, loader, epoch, log)
        chain = tuple(n - n0 for n, n0 in zip(chain_launches(), c0))
        proj = tuple(n - n0 for n, n0 in zip(proj_launches(), p0))
        validations.append((epoch, time.perf_counter() - v0, out, chain, proj))
        return out

    trainer_mod.Trainer.validate = timed_validate
    try:
        yield
    finally:
        trainer_mod.Trainer.validate = real_validate


def run_training(dev, tmp: str, rate: float):
    """Phases 8-11: the training path through the dW kernel, with one
    validation pass.  Returns the `blocked_dw` entry of the `kernels` line,
    the last checkpoint, and what phases 11a-11c reuse: the corpus, the
    parity phase's initial state and batches, its float32 losses, and the
    float32 step and kernel times."""
    from fullycnnspeechenhancement_torch import Config, ModelConfig, load_ini_config
    from fullycnnspeechenhancement_torch.cli import train as train_cli
    from fullycnnspeechenhancement_torch.infer import InferenceEngine
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.models.blocked import _block_index_map, apply_blocked
    from fullycnnspeechenhancement_torch.ops import blocked_dw
    from fullycnnspeechenhancement_torch.train.checkpoint import export_params_npz
    from fullycnnspeechenhancement_torch.eval.metrics import PESQ
    from fullycnnspeechenhancement_torch.train.trainer import Trainer

    rng = np.random.default_rng(1)
    model = get_model("FullyCNNV2")
    # the inner (1, k) layers, whose dW the kernel computes: 14 for V2
    n_dw = sum(1 for spec in model.layers if spec.kernel[0] == 1 and spec.kernel[1] < 129)
    # the BN layers, whose chain ops.bn_chain runs: 15 for V2
    n_bn = sum(spec.use_norm for spec in model.layers)

    # -- 8. the training main path ------------------------------------------
    t0 = time.perf_counter()
    corpus = write_corpus(os.path.join(tmp, "corpus"), rng)
    log(f"corpus: {N_UTTS} utterances, 8 noise recordings and {N_VAL} validation utterances "
        f"({corpus['val_seconds']:.1f} s) in {time.perf_counter() - t0:.1f} s")
    root = os.path.join(tmp, "train")
    ini = write_train_ini(os.path.join(tmp, "train.cfg"), root, corpus)
    validations = []
    t0 = time.perf_counter()
    blocked_dw.launches = 0
    reset_chain_launches()
    with timed_validation(validations):
        trainer = train_cli.main(["--cfg", ini])
    torch.cuda.synchronize()
    launches = blocked_dw.launches
    chain = chain_launches()
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
    check_chain_launches("training main path", chain, n_bn, steps, validations)
    check_proj_launches("training main path", proj_launches(), steps, False, validations)
    log(f"training main path: bn_chain launches {chain} (moments, apply, grad sums, grad apply)")
    if not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError("a logged loss is not finite")
    files = sorted(os.listdir(run_dir))
    if files != [f"epoch_{e}.pt" for e in range(EPOCHS)]:
        raise AssertionError(f"checkpoints {files} in {run_dir}")
    # the validation pass: once, after epoch VALID_EVERY - 1, in the fork
    # pool (the CUDA context live in the parent), with the native PESQ
    log(f"validation scalars: {valid}")
    epochs_validated = [e for e, *_ in validations]
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
    max_err = dw_against_plain(dev, shapes, kb, dc, nb, gen)
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
    k_ms, p_ms, lib_ms, _, padded, computed = time_dw_layers(dev, shapes, kb, dc, nb, gen)
    flop, nbytes = dw_work(shapes, rows_full, nb, kb, dc)
    # 3xTF32 issues three TF32 products for each float32 one
    t_ops, t_simt = 3 * flop / PEAK_TF32_FLOPS * 1e3, flop / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    nbp = nb + kb - 1
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

    audio_s = float(sum(b.lengths.sum() for b in batches[:1])) / SR
    step_ms = time_steps(trainers, batches[0])
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
    payload = tr._prep_single(batches[0])
    conv = layout_conversions(lambda: tr._step(tr.state, payload))
    log("layout conversions of one train step: not linked to ops by the profiler" if conv is None
        else f"layout conversions of one train step: {conv[0]} kernels, {conv[1]:.3f} ms")
    phase("dw timings", t0)
    for tr in trainers.values():
        tr.ckpt.close()

    entry = {
        "name": "blocked_dw",
        "dtype": "float32",
        "route": "cuda",
        "source": "fullycnnspeechenhancement_torch/ops/csrc/blocked_dw.cu",
        "replaces": "fullycnnspeechenhancement_tpu/ops/pallas_dw.py:51",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_note": "3xTF32 on the tensor cores at the data sheet's TF32 rate",
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
    ctx = {"corpus": corpus, "npz": npz, "batches": batches[:PARITY_STEPS], "losses32": losses[True],
           "step_ms32": {dw: float(np.mean(v)) for dw, v in step_ms.items()}, "kernel_ms32": k_ms}
    return entry, last, ctx


def run_training_bf16(dev, tmp: str, ctx: dict, rate_bf16: float, rate_wgmma: float) -> dict:
    """Phases 11a-11c: the training path in bf16, through the bf16 dW
    kernel on wgmma.  Returns the bf16 `blocked_dw` entry of the `kernels`
    line."""
    from fullycnnspeechenhancement_torch import load_ini_config
    from fullycnnspeechenhancement_torch.cli import train as train_cli
    from fullycnnspeechenhancement_torch.eval.metrics import PESQ
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.models.blocked import _block_index_map
    from fullycnnspeechenhancement_torch.ops import blocked_dw
    from fullycnnspeechenhancement_torch.train.trainer import Trainer

    model = get_model("FullyCNNV2")
    n_dw = sum(1 for spec in model.layers if spec.kernel[0] == 1 and spec.kernel[1] < 129)
    corpus, bf16 = ctx["corpus"], torch.bfloat16

    # -- 11a. the bf16 training main path -------------------------------------
    t0 = time.perf_counter()
    root = os.path.join(tmp, "train_bf16")
    ini = write_train_ini(os.path.join(tmp, "train_bf16.cfg"), root, corpus, compute_dtype="bfloat16",
                          epochs=EPOCHS_BF16, valid_every=1)
    validations = []
    blocked_dw.launches = blocked_dw.launches_bf16 = blocked_dw.launches_bf16_mma_sync = 0
    reset_chain_launches()
    with timed_validation(validations):
        trainer = train_cli.main(["--cfg", ini])
    torch.cuda.synchronize()
    launches, launches32 = blocked_dw.launches_bf16, blocked_dw.launches
    launches_old = blocked_dw.launches_bf16_mma_sync
    chain = chain_launches()
    main_s = time.perf_counter() - t0
    with open(os.path.join(root, "log", "scalars_RCED_FullyCNNV2.jsonl")) as f:
        all_rows = [json.loads(line) for line in f]
    rows = [r for r in all_rows if "loss" in r]
    valid = [r for r in all_rows if any(k.startswith("valid_") for k in r)]
    steps = len(rows)
    log(f"bf16 training main path: {steps} steps in {main_s:.1f} s, blocked_dw bf16 launches {launches} "
        f"through the wgmma kernel ({launches_old} through the mma.sync one, float32 {launches32}), "
        f"losses {[round(r['loss'], 3) for r in rows]}")
    if steps != EPOCHS_BF16 * N_UTTS // B_TRAIN:
        raise AssertionError(f"bf16: {steps} logged steps, expected {EPOCHS_BF16 * N_UTTS // B_TRAIN}")
    if launches != n_dw * steps or launches32 != 0 or launches_old != 0:
        raise AssertionError(f"bf16: blocked_dw launched {launches} wgmma, {launches_old} bf16 mma.sync and "
                             f"{launches32} float32 times in {steps} steps, expected {n_dw * steps}, 0 and 0")
    check_chain_launches("bf16 training main path", chain, sum(spec.use_norm for spec in model.layers), steps,
                         validations)
    check_proj_launches("bf16 training main path", proj_launches(), steps, True, validations)
    log(f"bf16 training main path: proj_train launches {proj_launches()} (forward, dX, dW)")
    if not all(np.isfinite(r["loss"]) for r in rows):
        raise AssertionError("bf16: a logged loss is not finite")
    files = sorted(os.listdir(trainer.ckpt.dir))
    if files != [f"epoch_{e}.pt" for e in range(EPOCHS_BF16)]:
        raise AssertionError(f"bf16: checkpoints {files}")
    if any(v.dtype != torch.float32 for d in trainer.state.params.values() for v in d.values()):
        raise AssertionError("bf16: a param is not float32")
    log(f"bf16 validation scalars: {valid}")
    keys = sorted(k for k in valid[0] if k != "epoch") if len(valid) == 1 else []
    if [e for e, *_ in validations] != [0] or keys != ["valid_pesq", "valid_sdr", "valid_stoi"] \
            or not all(np.isfinite(valid[0][k]) for k in keys):
        raise AssertionError(f"bf16: validated after {validations}, scalars {valid}")
    if trainer.evaluator.scoring != "process" or PESQ(sr=SR).implementation != "p862-native":
        raise AssertionError("bf16: validation left the fork pool or the native PESQ")
    log(f"bf16 validation pass: {N_VAL} utterances ({corpus['val_seconds']:.1f} audio-s) in "
        f"{validations[0][1]:.2f} s, {corpus['val_seconds'] / validations[0][1]:.1f} audio-s/s")
    # the host loader's bf16 epoch, beside the device cache's (phase 17)
    ctx["epoch_rate_bf16"] = epoch_rates(root)[0][2]
    log(f"bf16 epoch with the host loader: {epoch_rates(root)}")
    phase("bf16 training main path", t0)

    # -- 11b. parity: dw_pallas on and off under bf16, and float32 -------------
    t0 = time.perf_counter()
    trainers, losses, moments = {}, {}, {}
    for dw in (True, False):
        cfg = load_ini_config(write_train_ini(
            os.path.join(tmp, f"parity_bf16_{dw}.cfg"), os.path.join(tmp, f"parity_bf16_{dw}"), corpus,
            dw_pallas=dw, base_checkpoint=ctx["npz"], compute_dtype="bfloat16",
        ))
        tr = Trainer(cfg, device="cuda")
        losses[dw], moments[dw] = [], []
        for b in ctx["batches"]:
            tr.state, m = tr._step(tr.state, tr._prep_single(b))
            losses[dw].append(m["loss"])
            moments[dw].append({name: flat_leaves(getattr(tr.state.opt_state, name)) for name in ("mu", "nu")})
        losses[dw] = torch.stack(losses[dw]).cpu().numpy()
        trainers[dw] = tr
    log(f"bf16 parity losses dw_pallas on {losses[True].tolist()} off {losses[False].tolist()}")
    np.testing.assert_allclose(losses[True], losses[False], rtol=PARITY_LOSS_RTOL_BF16)
    worst = 0.0
    for k in range(len(ctx["batches"])):
        errs = {m: global_err(moments[True][k][m], moments[False][k][m]) for m in ("mu", "nu")}
        worst = max(worst, *errs.values())
        log(f"bf16 parity step {k}: Adam mu off by {errs['mu']:.3e}, nu by {errs['nu']:.3e} of their global scale")
        if max(errs.values()) > PARITY_MOMENT_TOL_BF16:
            raise AssertionError(f"bf16 parity step {k}: moments differ by {errs} of their scale")
    diff = (losses[True] - ctx["losses32"]) / ctx["losses32"]
    log(f"bf16 against float32 from one state (dw_pallas on, the same {len(diff)} batches): "
        f"per-step loss difference {diff.tolist()} of the float32 loss (not gated)")
    phase("bf16 parity", t0)

    # -- 11c. the bf16 kernel against its plain version, and timings ----------
    t0 = time.perf_counter()
    J, dc = _block_index_map(5, 8)
    kb, nb = J.shape[0], -(-129 // 8)
    shapes = dw_layer_shapes(model)
    gen = torch.Generator(device=dev).manual_seed(6)
    if not all(blocked_dw.takes_wgmma(torch.empty(1, 1, nb, ci, dtype=bf16, device=dev),
                                      torch.empty(1, 1, nb, co, dtype=bf16, device=dev), kb)
               for _, ci, co in shapes):
        raise AssertionError("bf16: a V2 layer's shape does not go to the wgmma kernel")
    blocked_dw.launches_bf16 = blocked_dw.launches_bf16_mma_sync = 0
    max_err = dw_against_plain(dev, shapes, kb, dc, nb, gen, bf16)
    if blocked_dw.launches_bf16_mma_sync != 0:
        raise AssertionError("bf16: the dW checks launched the mma.sync kernel")
    k_ms, p_ms, lib_ms, old_ms, _, computed = time_dw_layers(dev, shapes, kb, dc, nb, gen, bf16,
                                                             other=blocked_dw.blocked_dw_mma_sync)
    flop, nbytes = dw_work(shapes, B_TRAIN * T_BUCKET, nb, kb, dc, in_bytes=2)
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    floor_ms = flop * computed / (rate_wgmma * 1e12) * 1e3
    # the mma.sync design's tiles (TILE ci by tile_co(bf16) co) and nbp
    tci, tco = blocked_dw.TILE, blocked_dw.tile_co(bf16)
    old_computed = sum(-(-ci // tci) * -(-co // tco) * tci * tco for _, ci, co in shapes) * (nb + kb - 1) * kb / (
        sum(ci * co for _, ci, co in shapes) * sum(max(0, nb - abs(d - dc)) for d in range(kb)))
    old_floor_ms = flop * old_computed / (rate_bf16 * 1e12) * 1e3
    log(f"timing blocked_dw bf16 over V2's 14 layers at {B_TRAIN} x 8 s: wgmma kernel {k_ms:.3f} ms, "
        f"the bf16 mma.sync design {old_ms:.3f} ms, the 3xTF32 kernel {ctx['kernel_ms32']:.3f} ms (phase 11), "
        f"plain {p_ms:.3f} ms, conv2d_weight in bf16 (cuDNN) {lib_ms:.3f} ms")
    log(f"bound bf16: {flop:.4e} FLOP -> {t_ops:.3f} ms at 989 TFLOP/s; {nbytes:.4e} B -> {t_bytes:.3f} ms at "
        f"3.35 TB/s; kernel at {100 * bound_ms / k_ms:.1f}% of it; it computes {computed:.4f}x the needed "
        f"products, at wgmma's {rate_wgmma:.1f} TFLOP/s (phase 2) a floor of {floor_ms:.3f} ms (kernel at "
        f"{100 * floor_ms / k_ms:.1f}% of it); the mma.sync design computes {old_computed:.4f}x, at mma.sync's "
        f"bf16 {rate_bf16:.1f} TFLOP/s a floor of {old_floor_ms:.3f} ms")
    # whole bf16 train steps, beside float32's
    audio_s = float(sum(b.lengths.sum() for b in ctx["batches"][:1])) / SR
    step_ms = time_steps(trainers, ctx["batches"][0])
    for dw in (True, False):
        ms = float(np.mean(step_ms[dw]))
        log(f"train step bf16 {B_TRAIN} x 8 s, dw_pallas={dw}: {step_ms[dw][0]:.2f} / {step_ms[dw][1]:.2f} ms "
            f"(mean {ms:.2f} ms, {audio_s / ms * 1e3:.1f} audio-s/s; float32 {ctx['step_ms32'][dw]:.2f} ms)")
    ctx["step_ms_bf16"] = float(np.mean(step_ms[True]))  # the device cache's ceiling (phase 17)
    tr = trainers[True]
    stacked = tr._prep_multi(ctx["batches"] * 2)

    def dispatch():
        tr.state, packed = tr._multi_step(tr.state, stacked)
        return packed

    host_ms, busy_ms, events = device_busy_ms(dispatch, reps=1, top=8)
    log(f"one steps_per_call=8 bf16 dispatch: host {host_ms:.2f} ms traced, " + (
        "device busy not measured" if busy_ms is None else
        f"device busy {busy_ms:.2f} ms in {events:.0f} device events, idle share {1 - busy_ms / host_ms:.3f}"))
    for t in trainers.values():
        t.ckpt.close()
    phase("bf16 dw kernel checks and timings", t0)
    return {
        "name": "blocked_dw",
        "dtype": "bfloat16",
        "route": "cuda",
        "source": "fullycnnspeechenhancement_torch/ops/csrc/blocked_dw.cu",
        "replaces": "fullycnnspeechenhancement_tpu/ops/pallas_dw.py:51",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": lib_ms,
        "library": "torch.nn.grad.conv2d_weight on bf16 (cuDNN backward-filter), one call per layer",
        "float32_kernel_ms": ctx["kernel_ms32"],
        "mma_sync_bf16_tflops": rate_bf16,
        "wgmma_bf16_tflops": rate_wgmma,
        "train_step_bf16_ms": {"dw_pallas": float(np.mean(step_ms[True])), "cudnn": float(np.mean(step_ms[False]))},
        # floors computed from this run's inputs, plans and the rates above,
        # and the bf16 mma.sync design timed beside the kernel (blocked_dw_mma_sync)
        "derived": {
            "computed_product_ratio": computed,
            "wgmma_floor_ms": floor_ms,
            "mma_sync_design_ms": old_ms,
            "mma_sync_design_product_ratio": old_computed,
            "mma_sync_floor_ms": old_floor_ms,
        },
    }


# -- the kernel-probe path -------------------------------------------------


def run_bn_chain(dev, B: int = 64, T: int = 384, real_t: int = 281, reps: int = 10) -> dict:
    """Phase 11d: `ops.bn_chain` alone on each of V2's 15 BN layers in bf16
    at the training cell's B x T = 64 x 384 frames under a batch-max mask
    of `real_t` frames (4.5 s utterances): each layer's results against
    the plain chain in float64 (`tests/test_torch_cuda.py`'s
    `chain_errors` within its CHAIN_TOL; raises on a miss), then each
    stage's device time (CUDA events around calls queued behind a spin
    kernel; a reduction with its partial sums' kernel) beside its
    least bytes at the data sheet's 3.35 TB/s (each operand read once and
    each result written once, over the real bins: the moments over the
    masked frames, the rest over every frame), the chain's forward and
    backward under autograd beside the plain chain's (`chain_plain`),
    device and host time, and the least time `portbench`'s
    `bn_chain_roofline` counts (the compute dtype over the batch-max
    frames: y, the skip and the output forward; g, y and dy backward).
    Returns the `kernels` line's entry."""
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.models.blocks import moments_from_sums
    from fullycnnspeechenhancement_torch.ops import bn_chain

    # The card tests' comparison, loaded from its file: a `tests` package
    # installed beside the interpreter may shadow the repository's folder.
    found = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "test_torch_cuda.py"))
    card = importlib.util.module_from_spec(found)
    found.loader.exec_module(card)

    t0 = time.perf_counter()
    bf16, f_dim, peak = torch.bfloat16, 129, 3.35e12
    gen = torch.Generator(device=dev).manual_seed(24)
    fm = (torch.arange(T, device=dev) < real_t).float()[None]
    batch = bn_chain.make_batch(B, T, f_dim, 8, bf16, dev, is_training=True, frame_mask=fm)

    def draw(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale + shift

    def fwd_bwd(fn, y, p, state, skip, g):
        leaves = [y.detach().requires_grad_(True)] + [v.detach().requires_grad_(True) for v in p.values()]
        if skip is not None:
            leaves.append(skip.detach().requires_grad_(True))
        out, _ = fn(leaves[0], dict(zip(p, leaves[1:4])), state, batch, skip=None if skip is None else leaves[4])
        return torch.autograd.grad(out, leaves, g)

    layers, groups, worst = [], [], 0.0
    for spec in get_model("FullyCNNV2").layers:
        if not spec.use_norm:
            continue
        C = spec.out_ch
        shape = (B, T, 17, 8 * C)
        y, g = draw(*shape, scale=0.8, shift=0.3).to(bf16), draw(*shape).to(bf16)
        skip = None if spec.skip_from is None else draw(*shape).to(bf16)
        p = {"b": draw(C, scale=0.1), "gamma": draw(C, scale=0.1, shift=1.0), "beta": draw(C, scale=0.1)}
        state = {"mean": torch.zeros(C, device=dev), "var": torch.ones(C, device=dev)}
        case = {"y": y, "p": p, "state": state, "skip": skip, "add": None, "g": g, "frame_mask": fm,
                "reduce": None, "batch": batch}
        errs = card.chain_errors(card.run_chain(bn_chain.bn_chain, case), card.plain_reference(case))
        bad = {k: v for k, v in errs.items() if not v <= card.CHAIN_TOL[bf16]}
        if bad:
            raise AssertionError(f"bn_chain {spec.name}: past {card.CHAIN_TOL[bf16]} of the float64 plain chain: "
                                 f"{bad}")
        worst = max(worst, *errs.values())
        del case
        s = bn_chain.moments(y, p["b"], batch)
        mean, var = moments_from_sums(s[0], s[1], batch.n)
        local = bn_chain.grad_sums(g, y, skip, p["b"], p["gamma"], p["beta"], mean, var, True, f_dim)
        stages = {
            "moments": lambda y=y, p=p: bn_chain.moments(y, p["b"], batch),
            "apply": lambda y=y, p=p, mean=mean, var=var, skip=skip: bn_chain.apply_chain(
                y, p["b"], p["gamma"], p["beta"], mean, var, skip, None, True, f_dim),
            "grad_sums": lambda g=g, y=y, p=p, mean=mean, var=var, skip=skip: bn_chain.grad_sums(
                g, y, skip, p["b"], p["gamma"], p["beta"], mean, var, True, f_dim),
            "grad_apply": lambda g=g, y=y, p=p, mean=mean, var=var, skip=skip, local=local, s=s: bn_chain.grad_apply(
                g, y, skip, p["b"], p["gamma"], p["beta"], mean, var, local, local, s[0], batch.n, batch, True),
            "chain": lambda g=g, y=y, p=p, state=state, skip=skip: fwd_bwd(bn_chain.bn_chain, y, p, state, skip, g),
            "plain": lambda g=g, y=y, p=p, state=state, skip=skip: fwd_bwd(bn_chain.chain_plain, y, p, state, skip,
                                                                            g),
        }
        value = 2 * f_dim * C  # bytes of one frame of one tensor's real bins
        links = int(skip is not None)
        least = {"moments": B * real_t * value, "apply": B * T * value * (2 + links),
                 "grad_sums": B * T * value * (2 + links), "grad_apply": B * T * value * (3 + 2 * links)}
        layers.append((spec.name, C, links, least, B * real_t * value * (2 + links + 3)))
        for name, fn in stages.items():
            fn()
            groups.append((f"{spec.name}/{name}", fn))
    # A stage alone is shorter than its launch, so a clock around a loop of
    # launches would time the host.  Each group's calls are launched behind
    # a spin kernel instead, between two CUDA events: where the host has
    # launched them all before the spin ends (the first event not yet
    # reached), the device runs them back to back, and the events time the
    # device alone; the spin is lengthened until it is.  (The profiler can
    # miss the device events launched soon after it starts, so it times
    # nothing here.)
    # The host time of each group is kept beside, and each group must move
    # `ops.bn_chain`'s launch counters by what it launches: one stage a
    # call, all four in the chain, none in the plain chain.
    launched = {"moments": (1, 0, 0, 0), "apply": (0, 1, 0, 0), "grad_sums": (0, 0, 1, 0),
                "grad_apply": (0, 0, 0, 1), "chain": (1, 1, 1, 1), "plain": (0, 0, 0, 0)}
    host, busy = {}, {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for label, fn in groups:
        for cycles in (10**7, 10**8, 10**9):
            torch.cuda.synchronize()
            before = chain_launches()
            torch.cuda._sleep(cycles)
            start.record()
            t1 = time.perf_counter()
            for _ in range(reps):
                fn()
            host[label] = (time.perf_counter() - t1) * 1e3 / reps
            ahead = not start.query()
            end.record()
            torch.cuda.synchronize()
            moved = tuple(n - n0 for n, n0 in zip(chain_launches(), before))
            want = tuple(k * reps for k in launched[label.split("/")[1]])
            if moved != want:
                raise AssertionError(f"bn_chain {label}: launch counters moved {moved}, expected {want}")
            if ahead:
                busy[label] = start.elapsed_time(end) / reps
                break
        else:
            raise AssertionError(f"bn_chain {label}: the host took {host[label]:.3f} ms a call, longer than the "
                                 "longest spin")
    totals = dict.fromkeys(("stages_ms", "chain_ms", "plain_ms", "least_ms", "metric_ms"), 0.0)
    for name, C, links, least, metric_bytes in layers:
        row = {"layer": name, "C": C, "skip": bool(links)}
        for stage, nbytes in least.items():
            ms = busy[f"{name}/{stage}"]
            row[f"{stage}_ms"] = ms
            row[f"{stage}_share_of_least_bytes"] = nbytes / peak * 1e3 / ms
            totals["stages_ms"] += ms
            totals["least_ms"] += nbytes / peak * 1e3
        for which in ("chain", "plain"):
            row[f"{which}_ms"], row[f"{which}_host_ms"] = busy[f"{name}/{which}"], host[f"{name}/{which}"]
            totals[f"{which}_ms"] += row[f"{which}_ms"]
        totals["metric_ms"] += metric_bytes / peak * 1e3
        log("bn_chain " + json.dumps(row))
    log(f"bn_chain, V2's 15 BN layers at {B} x {T} frames, bf16: the four stages {totals['stages_ms']:.3f} ms "
        f"(least bytes {totals['least_ms']:.3f} ms, {100 * totals['least_ms'] / totals['stages_ms']:.1f}%); forward "
        f"and backward under autograd {totals['chain_ms']:.3f} ms of device time against the plain chain's "
        f"{totals['plain_ms']:.3f} ms; bn_chain_roofline's least time {totals['metric_ms']:.3f} ms "
        f"({100 * totals['metric_ms'] / totals['stages_ms']:.1f}% of the stages)")
    phase("bn_chain alone", t0)
    return {
        "name": "bn_chain",
        "dtype": "bfloat16",
        "route": "cuda",
        "source": "fullycnnspeechenhancement_torch/ops/csrc/bn_chain.cu",
        "replaces": None,
        "ms": totals["stages_ms"],
        "chain_device_ms": totals["chain_ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["least_ms"],
        "bound_by": "bytes",
        "bound_note": "each stage's operands read once and results written once at 3.35 TB/s",
        "library_ms": None,
        "library": "none: no single PyTorch call computes the chain",
        "at": f"V2's 15 BN layers at {B} x {T} frames, batch-max mask of {real_t}, summed",
        "max_rel_err": worst,
    }


def run_proj_train(dev, B: int = 64, T: int = 384, reps: int = 20) -> dict:
    """Phase 11e: `ops.proj_train` alone at the training cell's shape (V2's
    projection, C = 10, B x T = 64 x 384 frames, bf16): the forward, dX,
    dW and db against the plain projection (`proj_plain`) in float64 on
    the same bf16 values within the card tests' PROJ_TOL (raises on a
    miss); then each kernel's device time (CUDA events around calls
    queued behind a spin kernel, as phase 11d; dW with its partial sums'
    kernel) beside the three passes' least time at the data sheet's rates
    (the bytes of `portbench`'s `proj_train_roofline` over every frame),
    the forward and backward under autograd beside cuDNN's
    (`proj_plain` in bf16, the route before the kernels: `library_ms`).
    Returns the `kernels` line's entry."""
    from fullycnnspeechenhancement_torch.ops import proj_train

    found = importlib.util.spec_from_file_location(
        "proj_tests", os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "test_torch_proj_train.py"))
    card = importlib.util.module_from_spec(found)
    sys.path.insert(0, os.path.dirname(found.origin))
    try:
        found.loader.exec_module(card)
    finally:
        sys.path.pop(0)

    t0 = time.perf_counter()
    f_dim = card.F_DIM
    z, w, b, dy = card._case("FullyCNNV2", B, T, torch.bfloat16, dev, seed=25)
    got = card._grads(proj_train.proj_train, z, w, b, dy)
    ref = card._grads(proj_train.proj_plain, z, w, b, dy, torch.float64)
    errs = card.proj_errors(got, ref)
    rel = {k: ((g.double() - r).abs().max() / r.abs().max()).item()
           for k, g, r in zip(("y", "dz", "dw", "db"), got, ref)}
    log(f"proj_train at {B} x {T}, V2, bf16: against the float64 plain projection, largest error over the bound "
        f"(1 = PROJ_TOL {card.PROJ_TOL}) {errs}, max|got - ref| / max|ref| {rel}")
    if any(not v <= 1.0 for v in errs.values()):
        raise AssertionError(f"proj_train past PROJ_TOL of the float64 plain projection: {errs}")
    if got[1].reshape(B, T, -1, 10)[:, :, f_dim:].any():
        raise AssertionError("proj_train: dX's pad band is not 0")
    dims = proj_train._checked(z, w, b, f_dim)
    dyc = dy.contiguous()

    def both(fn):
        leaves = [t.detach().requires_grad_(True) for t in (z, w, b)]
        return torch.autograd.grad(fn(*leaves, f_dim), leaves, dy)

    groups = {
        "forward": (lambda: proj_train.forward(z, w, b, dims), (1, 0, 0)),
        "dx": (lambda: proj_train.grad_input(dyc, w, dims), (0, 1, 0)),
        "dw": (lambda: proj_train.grad_weight(z, dyc, dims), (0, 0, 1)),
        "autograd": (lambda: both(proj_train.proj_train), (1, 1, 1)),
        "cudnn_forward": (lambda: proj_train.proj_plain(z, w, b, f_dim), (0, 0, 0)),
        "cudnn_autograd": (lambda: both(proj_train.proj_plain), (0, 0, 0)),
    }
    busy, host = {}, {}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for label, (fn, launched) in groups.items():
        fn()
        for cycles in (10**7, 10**8, 10**9, 10**10):
            torch.cuda.synchronize()
            before = proj_launches()
            torch.cuda._sleep(cycles)
            start.record()
            t1 = time.perf_counter()
            for _ in range(reps):
                fn()
            host[label] = (time.perf_counter() - t1) * 1e3 / reps
            ahead = not start.query()
            end.record()
            torch.cuda.synchronize()
            moved = tuple(n - n0 for n, n0 in zip(proj_launches(), before))
            if moved != tuple(k * reps for k in launched):
                raise AssertionError(f"proj_train {label}: launch counters moved {moved}, expected {launched} x {reps}")
            if ahead:
                busy[label] = start.elapsed_time(end) / reps
                break
        else:
            raise AssertionError(f"proj_train {label}: the host took {host[label]:.3f} ms a call, longer than the "
                                 "longest spin")
    from portbench import peaks, work
    from portbench.metrics import proj_train_roofline
    from portbench.reference.specs import MODELS

    flop, nbytes = proj_train_roofline.least_work(MODELS["FullyCNNV2"], B, T, 2)
    least_ms = work.roofline_s(flop, nbytes, peaks.PEAK_FLOP_S["bfloat16"], peaks.PEAK_BYTES_S) * 1e3
    kernel_ms = busy["forward"] + busy["dx"] + busy["dw"]
    plan = proj_train.dw_plan(dims.rows, dims.positions * dims.channels,
                              torch.cuda.get_device_properties(dev).multi_processor_count)
    log("proj_train " + json.dumps({"device_ms": busy, "host_ms": host, "least_ms": least_ms,
                                    "least_bound_by": "bytes" if nbytes / peaks.PEAK_BYTES_S
                                    > flop / peaks.PEAK_FLOP_S["bfloat16"] else "operations",
                                    "share_of_least": least_ms / kernel_ms, "dw_plan": plan._asdict()}))
    log(f"proj_train, V2 at {B} x {T} frames, bf16: forward {busy['forward']:.4f} ms, dX {busy['dx']:.4f} ms, dW "
        f"{busy['dw']:.4f} ms (least time of the three {least_ms:.4f} ms, {100 * least_ms / kernel_ms:.1f}%); "
        f"forward and backward under autograd {busy['autograd']:.4f} ms of device time against cuDNN's "
        f"{busy['cudnn_autograd']:.4f} ms (forward {busy['cudnn_forward']:.4f} ms)")
    phase("proj_train alone", t0)
    return {
        "name": "proj_train",
        "dtype": "bfloat16",
        "route": "cuda",
        "source": "fullycnnspeechenhancement_torch/ops/csrc/proj_train.cu",
        "replaces": None,
        "ms": kernel_ms,
        "device_ms_by_kernel": {k: busy[k] for k in ("forward", "dx", "dw")},
        "autograd_device_ms": busy["autograd"],
        "plain_ms": None,
        "plain": "proj_plain is cuDNN's conv itself (library_ms); the float64 check above runs it",
        "bound_ms": least_ms,
        "bound_by": "bytes",
        "bound_note": "x and dy read, y and dX written once each pass in bf16, at 3.35 TB/s (every frame)",
        "library_ms": busy["cudnn_autograd"],
        "library": "F.conv2d (cuDNN, bf16) on the unblocked view, forward and backward under autograd",
        "at": f"V2's projection (C = 10) at {B} x {T} frames",
        "max_rel_err": max(rel.values()),
    }


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
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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


# -- the streaming path ------------------------------------------------------

# The streamed output against the whole-utterance overlap-add path
# (tests/test_streaming.py's tolerances), and against the CPU streamer and
# another chunk size (atol = STREAM_TOL * max|reference|).
STREAM_TOL = 1e-5


def stream_through(den, sig, push: int):
    """(output, per-push seconds) of `sig` pushed through `den` in pieces
    of `push` samples, then flushed."""
    out, times = [], []
    for i in range(0, len(sig), push):
        t0 = time.perf_counter()
        out.append(den.push(sig[i : i + push]))
        times.append(time.perf_counter() - t0)
    out.append(den.flush())
    return np.concatenate(out), times


def run_streaming(dev, tmp: str) -> None:
    """Phase 16: `StreamingDenoiser` on the card with phase 3's V2 weights:
    a 30 s recording at 8 frames (1,024 samples) a push against the
    whole-utterance overlap-add path on the card, against the same
    streamer on the CPU, and against 4 frames a push; then `cli.stream`
    on a 6 s wav."""
    from fullycnnspeechenhancement_torch import Config, ModelConfig
    from fullycnnspeechenhancement_torch.cli import stream as stream_cli
    from fullycnnspeechenhancement_torch.data.audio_io import write_wav
    from fullycnnspeechenhancement_torch.dsp.rebuild import WaveformRebuilder
    from fullycnnspeechenhancement_torch.infer import InferenceEngine
    from fullycnnspeechenhancement_torch.streaming import StreamingDenoiser

    npz = os.path.join(tmp, "v2.npz")  # phase 3's weights
    config = Config(model=ModelConfig(net_work="FullyCNNV2"))
    engine = InferenceEngine(config, checkpoint=npz, device=dev)
    rng = np.random.default_rng(16)
    sig = speech_like(rng, 30.0)
    push = 8 * config.dsp.frame_step

    reb = WaveformRebuilder(config.dsp, mode="overlap_add")
    with torch.inference_mode():
        wav = torch.as_tensor(sig[None], device=dev)
        lengths = torch.tensor([len(sig)], dtype=torch.int32, device=dev)
        mag, pre, pim = engine.ext.magnitude_and_phase(wav, lengths)
        pred, _ = engine.model.apply(engine.params, engine.bn_state, mag[..., None])
        whole = reb(pred[..., 0], pre, pim)[0].cpu().numpy()

    def streamer(device, chunk):
        return StreamingDenoiser(config, engine.params, engine.bn_state, chunk_frames=chunk, device=device)

    out8, times = stream_through(streamer(dev, 8), sig, push)
    n = min(len(out8), len(whole))
    if n < len(sig) - config.dsp.frame_length or np.abs(whole).max() < 1e-3:
        raise AssertionError(f"stream of {len(out8)} samples, whole path {len(whole)}, max|whole| "
                             f"{np.abs(whole).max():.3e}, for {len(sig)} in")
    err = check_close("stream vs whole utterance", torch.as_tensor(out8[:n]), torch.as_tensor(whole[:n]),
                      1e-3, 2e-3)
    out_cpu, times_cpu = stream_through(streamer("cpu", 8), sig, push)
    err_cpu = check_close("stream card vs CPU", torch.as_tensor(out8), torch.as_tensor(out_cpu), 0.0,
                          STREAM_TOL * np.abs(out_cpu).max())
    out4, _ = stream_through(streamer(dev, 4), sig, push)
    err4 = check_close("stream 4 vs 8 frames a push", torch.as_tensor(out4), torch.as_tensor(out8), 0.0,
                       STREAM_TOL * np.abs(out8).max())
    ms = np.asarray(times) * 1e3
    log(f"streaming 30 s at 8 frames a push ({len(times)} pushes): vs whole utterance max abs err {err:.3e} "
        f"(rtol 1e-3, atol 2e-3), vs the CPU streamer {err_cpu:.3e}, 4 vs 8 frames {err4:.3e} (max|out| "
        f"{np.abs(out8).max():.3e}); push p50 {np.percentile(ms, 50):.3f} ms, p95 "
        f"{np.percentile(ms, 95):.3f} ms, sum {ms.sum():.1f} ms (CPU streamer: p50 "
        f"{np.percentile(np.asarray(times_cpu) * 1e3, 50):.3f} ms)")

    ini = os.path.join(tmp, "stream.cfg")
    with open(ini, "w") as f:
        f.write("[model]\nnet_work=FullyCNNV2\n")
    wav_in = os.path.join(tmp, "stream_in.wav")
    write_wav(wav_in, speech_like(rng, 6.0), SR)
    report = stream_cli.main(["--cfg", ini, "--audio-file", wav_in, "--checkpoint", npz, "--device", str(dev)])
    if sorted(report) != ["budget_ms", "latency_ms", "out", "push_p50_ms", "push_p95_ms", "rtf"] \
            or not os.path.exists(report["out"]):
        raise AssertionError(f"cli.stream reported {report}")
    log(f"cli.stream on 6 s at 8 frames a push: rtf {report['rtf']}, push p50 {report['push_p50_ms']} ms, "
        f"p95 {report['push_p95_ms']} ms, budget {report['budget_ms']} ms, latency {report['latency_ms']} ms; "
        "each push that emits output waits for one device-to-host copy of its prediction")


# -- the device-cache training path -------------------------------------------


def epoch_rates(root: str) -> list:
    """(audio-s, seconds, audio-s/s) of each epoch `cli.train` logged under
    `root`/log."""
    import glob
    import re

    pat = re.compile(r"epoch \d+ done: ([\d.]+) audio-s in ([\d.]+) s \(([\d.]+) audio-s/s\)")
    out = []
    for path in sorted(glob.glob(os.path.join(root, "log", "*_log.txt"))):
        out += [tuple(float(g) for g in m.groups()) for m in pat.finditer(open(path).read())]
    return out


def logged_losses(root: str) -> list:
    with open(os.path.join(root, "log", "scalars_RCED_FullyCNNV2.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if "loss" in r], [r for r in rows if any(k.startswith("valid_") for k in r)]


def mix_close(name, got, ref, clean, ulps: int) -> float:
    """Raise unless |got - ref| is within `ulps` float32 spacings of the
    mix's largest term (clean, the scaled noise or the sum) everywhere;
    returns the largest difference in such spacings."""
    big = np.maximum(np.maximum(np.abs(clean), np.abs(got - clean)), np.abs(got)).astype(np.float32)
    ratio = np.abs(got - ref) / np.maximum(np.spacing(big), np.finfo(np.float32).tiny)
    if ratio.max() > ulps:
        raise AssertionError(f"{name}: mix off by {ratio.max():.3f} float32 spacings of its largest term")
    return float(ratio.max())


def run_device_cache(dev, tmp: str, ctx: dict) -> dict:
    """Phase 17: the `_tpu` training profile as written (the device cache,
    bf16, blocked, batch 64, steps_per_call 8) with dw_pallas, on phase
    8's corpus through `cli.train`: a resident run (two epochs, validation
    after the second) and a rotating run (two epochs over the corpus
    listed three times, the budget set for 3 shards of at least 8 batches
    each, so every shard runs 8-step dispatches; spilled under the temp
    dir), each with the bf16 dW kernels' launch counts set to 0 just
    before and read just after, and its cache build (decode) and commit
    seconds and its dispatches' step counts recorded; then parity of the
    cache against the host loader in float32 from phase 9's initial
    state; and one cached dispatch's idle share.  Returns each run's
    bf16 dW launches."""
    from fullycnnspeechenhancement_torch import load_ini_config
    from fullycnnspeechenhancement_torch.cli import train as train_cli
    from fullycnnspeechenhancement_torch.data import device_cache
    from fullycnnspeechenhancement_torch.data.manifest import read_manifest
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.ops import blocked_dw
    from fullycnnspeechenhancement_torch.train.cached_step import Meta
    from fullycnnspeechenhancement_torch.train.trainer import Trainer

    model = get_model("FullyCNNV2")
    n_dw = sum(1 for spec in model.layers if spec.kernel[0] == 1 and spec.kernel[1] < 129)
    n_bn = sum(spec.use_norm for spec in model.layers)
    corpus = ctx["corpus"]
    manifest = [e.audio_filepath for e in read_manifest(corpus["clean"])]
    launches = {}

    def cached_run(tag, run_corpus, extra_data, valid_every, epochs=2):
        """`cli.train` over the cache; also returns the step counts of its
        dispatches and its cache build (decode, spill) and commit seconds,
        the build before the first epoch's clock starts, the resident
        commit too, the rotating commits inside each epoch's clock."""
        root = os.path.join(tmp, f"cache_{tag}")
        ini = write_train_ini(os.path.join(tmp, f"cache_{tag}.cfg"), root, run_corpus, compute_dtype="bfloat16",
                              epochs=epochs, valid_every=valid_every, use_device_cache=True, extra_data=extra_data)
        validations, ks, setup = [], [], {"build_s": 0.0, "commit_s": 0.0, "commits": 0}
        real_build, real_commit, real_dispatch = (train_cli.build_loaders, device_cache.commit_flats,
                                                  Trainer._dispatch_cached)

        def timed_build(*a, **kw):
            t = time.perf_counter()
            out = real_build(*a, **kw)
            setup["build_s"] += time.perf_counter() - t
            return out

        def timed_commit(*a, **kw):
            t = time.perf_counter()
            out = real_commit(*a, **kw)
            setup["commit_s"] += time.perf_counter() - t
            setup["commits"] += 1
            return out

        def counted_dispatch(self, payload, k, epoch):
            ks.append(k)
            return real_dispatch(self, payload, k, epoch)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        blocked_dw.launches = blocked_dw.launches_bf16 = blocked_dw.launches_bf16_mma_sync = 0
        reset_chain_launches()
        t0 = time.perf_counter()
        train_cli.build_loaders, device_cache.commit_flats = timed_build, timed_commit
        Trainer._dispatch_cached = counted_dispatch
        try:
            with timed_validation(validations):
                trainer = train_cli.main(["--cfg", ini])
        finally:
            train_cli.build_loaders, device_cache.commit_flats = real_build, real_commit
            Trainer._dispatch_cached = real_dispatch
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n, n32, n_old = blocked_dw.launches_bf16, blocked_dw.launches, blocked_dw.launches_bf16_mma_sync
        chain = chain_launches()
        rows, valid = logged_losses(root)
        steps = len(rows)
        rates = epoch_rates(root)
        log(f"device cache {tag}: {steps} steps in {wall:.1f} s, blocked_dw bf16 launches {n} through the wgmma "
            f"kernel ({n_old} through the mma.sync one, float32 {n32}), dispatches of {ks} steps, losses "
            f"{[round(r['loss'], 3) for r in rows]}; epochs {rates}; cache build {setup['build_s']:.3f} s, "
            f"{setup['commits']} commits in {setup['commit_s']:.3f} s; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        if n != n_dw * steps or n32 != 0 or n_old != 0 or steps == 0:
            raise AssertionError(f"device cache {tag}: blocked_dw launched {n} wgmma, {n_old} bf16 mma.sync and "
                                 f"{n32} float32 times in {steps} steps, expected {n_dw * steps}, 0 and 0")
        if sum(ks) != steps:
            raise AssertionError(f"device cache {tag}: dispatches of {ks} steps, {steps} steps logged")
        check_chain_launches(f"device cache {tag}", chain, n_bn, steps, validations)
        check_proj_launches(f"device cache {tag}", proj_launches(), steps, True, validations)
        log(f"device cache {tag}: bn_chain launches {chain} (moments, apply, grad sums, grad apply)")
        if not all(np.isfinite(r["loss"]) for r in rows):
            raise AssertionError(f"device cache {tag}: a logged loss is not finite")
        if sorted(os.listdir(trainer.ckpt.dir)) != [f"epoch_{e}.pt" for e in range(epochs)]:
            raise AssertionError(f"device cache {tag}: checkpoints {os.listdir(trainer.ckpt.dir)}")
        launches[tag] = n
        return trainer, steps, valid, validations, rates, ks, setup

    # -- 17a. the resident cache -------------------------------------------
    t0 = time.perf_counter()
    trainer, steps, valid, validations, rates, ks, setup_res = cached_run("resident", corpus, "", 2)
    loader = trainer._cached_loader
    if not isinstance(loader, device_cache.DeviceCacheLoader) or loader.corpus.clean.device.type != dev.type \
            or loader.corpus.clean.dtype != torch.int16:
        raise AssertionError(f"resident run: loader {type(loader).__name__} with flats not int16 on the card")
    if steps != 2 * N_UTTS // B_TRAIN or ks != [8, 8]:
        raise AssertionError(f"resident run: {steps} steps in dispatches of {ks}, expected two of 8")
    keys = sorted(k for k in valid[0] if k != "epoch") if len(valid) == 1 else []
    if [e for e, *_ in validations] != [1] or keys != ["valid_pesq", "valid_sdr", "valid_stoi"] \
            or not all(np.isfinite(valid[0][k]) for k in keys):
        raise AssertionError(f"resident run: validated after {validations}, scalars {valid}")
    log(f"resident run: flats {loader.corpus.nbytes() / 2**20:.1f} MiB on the card; validation {valid[0]}")
    # one cached steps_per_call=8 dispatch under the profiler
    batches = list(loader)[:8]
    clean_flat, other_flat = loader.flats()
    fn = trainer._cached_fn(batches[0].bucket_frames, len(batches))
    meta = Meta.stack(batches, dev)
    dispatch_audio = float(sum(b.lengths.sum() for b in batches)) / SR

    def dispatch():
        trainer.state, packed = fn(trainer.state, clean_flat, other_flat, meta)
        return packed

    host_ms, busy_ms, events = device_busy_ms(dispatch, reps=1, top=8)
    log(f"one cached steps_per_call=8 bf16 dispatch: host {host_ms:.2f} ms traced, "
        f"{dispatch_audio / host_ms * 1e3:.1f} audio-s/s, " + (
            "device busy not measured" if busy_ms is None else
            f"device busy {busy_ms:.2f} ms in {events:.0f} device events, idle share {1 - busy_ms / host_ms:.3f}"))
    phase("device cache, resident", t0)

    # -- 17b. the rotating cache -------------------------------------------
    # Phase 8's corpus listed three times, so that each of 3 shards holds at
    # least 8 batches of the one (512-frame) bucket and runs 8-step dispatches.
    t0 = time.perf_counter()
    with open(corpus["clean"]) as f:
        lines = f.read().splitlines()
    corpus3 = dict(corpus, clean=os.path.join(tmp, "train3.clean"))
    with open(corpus3["clean"], "w") as f:
        f.write("\n".join(lines * 3) + "\n")
    total = 3 * sum(int(e.duration * SR) * 2 for e in read_manifest(corpus["clean"]))
    budget_gb = total / 3 * 1.03 / 0.95 / 2**30  # the split fills 0.95 of the budget
    seen = []
    real_iter = device_cache.RotatingDeviceCacheLoader.__iter__

    def recording_iter(self):
        for b in real_iter(self):
            seen.extend((self._epoch, self._resident, self.generation, int(i)) for i in b.indices)
            yield b

    device_cache.RotatingDeviceCacheLoader.__iter__ = recording_iter
    try:
        trainer, steps, _, _, rates_rot, ks_rot, setup_rot = cached_run(
            "rotating", corpus3, f"device_cache_budget_gb={budget_gb!r}\n"
            f"device_cache_spill_dir={os.path.join(tmp, 'cache_spill')}\n", 3)
    finally:
        device_cache.RotatingDeviceCacheLoader.__iter__ = real_iter
    rot = trainer._cached_loader
    if not isinstance(rot, device_cache.RotatingDeviceCacheLoader) or rot.num_shards < 3:
        raise AssertionError(f"rotating run: loader {type(rot).__name__}, not 3 shards or more")
    per_shard = [len(ld) for ld in rot._loaders]
    if min(per_shard) < 8 or any(len({ld.bucket_for(f) for f in ld._frames}) != 1 for ld in rot._loaders):
        raise AssertionError(f"rotating run: shards of {per_shard} batches, not one bucket of 8 or more each")
    if steps != 2 * len(rot) or ks_rot.count(8) != 2 * sum(n // 8 for n in per_shard):
        raise AssertionError(f"rotating run: {steps} steps for 2 epochs of {len(rot)} batches, dispatches "
                             f"{ks_rot}, expected {2 * sum(n // 8 for n in per_shard)} of 8 steps")
    # a shard run: consecutive batches of one shard (the first shard of an
    # epoch continues the run when it is the one still resident)
    starts = [j for j in range(len(seen)) if j == 0 or seen[j - 1][1] != seen[j][1]]
    shard_runs = [seen[j][1] for j in starts]
    gens = [seen[j][2] for j in starts]
    if rot.generation != len(starts) or gens != list(range(1, len(starts) + 1)) \
            or len({g for _, _, g, _ in seen}) != len(starts):
        raise AssertionError(f"rotating run: generation {rot.generation}, {gens} at the shard runs {shard_runs}")
    everything = sorted((si, i) for si, c in enumerate(rot._corpora) for i in range(len(c.entries)))
    for epoch in range(2):
        items = [(s, i) for e, s, _, i in seen if e == epoch]
        if sorted(set(items)) != everything or len(everything) != 3 * N_UTTS or len(items) != len(rot) * B_TRAIN:
            raise AssertionError(f"rotating run, epoch {epoch}: {len(set(items))} of {len(everything)} items "
                                 f"trained, {len(items)} slots")
    paths = [rot._corpora[s].entries[i].audio_filepath for e, s, _, i in seen if e == 0]
    if sorted(set(paths)) != sorted(manifest):
        raise AssertionError("rotating run: the trained items are not phase 8's corpus")
    log(f"rotating run: {rot.num_shards} shards of {per_shard} batches (budget "
        f"{budget_gb * 2**30 / 2**20:.2f} MiB, {rot.nbytes_resident() / 2**20:.2f} MiB a commit), generation "
        f"{rot.generation} over the shard runs {shard_runs}, every one of {len(everything)} items trained once "
        f"an epoch ({len(rot) * B_TRAIN - len(everything)} tail repeats), {ks_rot.count(8)} dispatches of 8 steps")
    phase("device cache, rotating", t0)

    # -- 17c. parity: the cache against the host loader, float32 -------------
    t0 = time.perf_counter()
    cfgs = {
        cached: load_ini_config(write_train_ini(
            os.path.join(tmp, f"cache_parity_{cached}.cfg"), os.path.join(tmp, f"cache_parity_{cached}"),
            corpus, base_checkpoint=ctx["npz"], epochs=1, valid_every=2, use_device_cache=cached))
        for cached in (True, False)
    }
    loaders = {cached: train_cli.build_loaders(cfgs[cached], 4)[0] for cached in (True, False)}
    loaders[True].activate(dev)
    for ld in loaders.values():
        ld.set_epoch(0)
    host_batches = list(loaders[False])
    worst = 0.0
    for hb, cb in zip(host_batches, loaders[True]):
        if not np.array_equal(hb.indices, cb.indices):
            raise AssertionError("parity: the cache's batch plan differs from the host loader's")
        mix, clean = device_cache.materialize_batch(*loaders[True].flats(), cb,
                                                    loaders[True].pad_len(cb.bucket_frames), False)
        mix, clean = mix.cpu().numpy(), clean.cpu().numpy()
        if not np.array_equal(clean, hb.clean_wav):
            raise AssertionError("parity: a clean batch rebuilt on the card differs from the host loader's")
        # the scale rounded to float32, the product, the sum and the host's
        # float64-to-float32 cast: half a spacing each
        worst = max(worst, mix_close("parity", mix, hb.mix_wav, clean, 2))
    log(f"parity: {len(host_batches)} batches rebuilt on the card: clean bit for bit, mix within {worst:.3f} "
        "float32 spacings of its largest term of the host loader's")
    states, losses = {}, {}
    for cached in (True, False):
        tr = Trainer(cfgs[cached], device=dev)
        tr.train(loaders[cached], epochs=1)
        tr.ckpt.close()
        rows, _ = logged_losses(os.path.join(tmp, f"cache_parity_{cached}"))
        losses[cached] = np.array([r["loss"] for r in rows])
        states[cached] = flat_leaves(tr.state.params)
    log(f"parity losses cache {losses[True].tolist()} host {losses[False].tolist()}")
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-3)
    for key, ref in states[False].items():
        np.testing.assert_allclose(states[True][key], ref, rtol=1e-3, atol=1e-4, err_msg=str(key))
    log(f"parity: {len(losses[True])} steps' losses within rtol 1e-3, params after the epoch within rtol 1e-3, "
        f"atol 1e-4 (largest param difference "
        f"{max(np.abs(states[True][k] - v).max() for k, v in states[False].items()):.3e})")
    step_audio = float(sum(int(e.duration * SR) for e in read_manifest(corpus["clean"]))) / SR / N_UTTS * B_TRAIN
    log(f"epoch audio-s/s (not gated): bf16 host loader {ctx['epoch_rate_bf16']:.1f} (phase 11a, one epoch, its "
        f"decode and fill inside its clock); resident cache {rates[0][2]:.1f} then {rates[1][2]:.1f} (build "
        f"{setup_res['build_s']:.3f} s and commit {setup_res['commit_s']:.3f} s before the first epoch's clock); "
        f"rotating cache {rates_rot[0][2]:.1f} then {rates_rot[1][2]:.1f} (build {setup_rot['build_s']:.3f} s "
        f"before the first; {setup_rot['commits']} commits, {setup_rot['commit_s']:.3f} s in all, inside the "
        f"epochs' clocks); the step-bound ceiling {step_audio / ctx['step_ms_bf16'] * 1e3:.1f} "
        f"({step_audio:.1f} audio-s a step, {ctx['step_ms_bf16']:.2f} ms a bf16 step, phase 11c)")
    phase("device cache parity", t0)
    return launches


# -- the export path ------------------------------------------------------------

# Each reloaded export against the engine's plain forward: atol =
# EXPORT_TOL * max|reference| (the artefact's convs run on BN-folded
# weights, which round differently).
EXPORT_TOL = 1e-5


def run_export(dev, tmp: str, checkpoint: str) -> None:
    """Phase 18: `cli.export` from phase 8's last checkpoint writes the npz
    and the `torch.export` artefact; each, reloaded on the card, gives the
    engine's plain forward on a 6 s request within EXPORT_TOL of
    max|reference|."""
    from fullycnnspeechenhancement_torch import Config, ModelConfig
    from fullycnnspeechenhancement_torch.cli import export as export_cli
    from fullycnnspeechenhancement_torch.export import load_torch_export
    from fullycnnspeechenhancement_torch.infer import InferenceEngine

    ini = os.path.join(tmp, "export.cfg")
    with open(ini, "w") as f:
        f.write("[model]\nnet_work=FullyCNNV2\n")
    npz, pt2 = os.path.join(tmp, "export", "v2.npz"), os.path.join(tmp, "export", "v2.pt2")
    os.makedirs(os.path.dirname(npz), exist_ok=True)
    written = export_cli.main(["--cfg", ini, "--checkpoint", checkpoint, "--npz", npz, "--torch-export", pt2,
                               "--device", str(dev)])
    if written != [npz, pt2]:
        raise AssertionError(f"cli.export wrote {written}")
    config = Config(model=ModelConfig(net_work="FullyCNNV2"))
    ref_engine = InferenceEngine(config, checkpoint=checkpoint, device=dev)
    npz_engine = InferenceEngine(config, checkpoint=npz, device=dev)
    sig = speech_like(np.random.default_rng(18), 6.0)
    n = len(sig)
    wav = torch.zeros(1, ref_engine._pad_len(n), device=dev)
    wav[0, :n] = torch.as_tensor(sig, device=dev)
    lengths = torch.tensor([n], dtype=torch.int32, device=dev)
    program = load_torch_export(pt2)
    with torch.inference_mode():
        mag = ref_engine.ext(wav, lengths)[..., None]  # [1, T, F, 1]
        T = mag.shape[1]
        ref, _ = ref_engine.model.apply(ref_engine.params, ref_engine.bn_state, mag)
        got_npz, _ = npz_engine.model.apply(npz_engine.params, npz_engine.bn_state, mag)
        x = torch.zeros(1, 512, mag.shape[2], 1, device=dev)
        x[:, :T] = mag
        got_pt2 = program.module()(x)[:, :T]
    scale = ref.abs().max().item()
    e_npz = check_close("npz export", got_npz, ref, 0.0, EXPORT_TOL * scale)
    e_pt2 = check_close("torch.export artefact", got_pt2, ref, 0.0, EXPORT_TOL * scale)
    log(f"export from {os.path.basename(checkpoint)}: npz {os.path.getsize(npz)} B, torch.export "
        f"{os.path.getsize(pt2)} B; on a 6 s request (T={T}, padded to 512 frames for the artefact) against "
        f"the engine's plain forward: npz max abs err {e_npz:.3e}, artefact {e_pt2:.3e} (max|ref| {scale:.3e})")


# -- data parallelism, time-sharded serving, dataset preparation -------------

# Phase 19: two ranks share the card over gloo (NCCL refuses two ranks on
# one device), so they measure nothing about scaling.  The DP run starts
# from the config seed's state, as phases 8 and 17a do, on the same global
# batches; its ranks sum the BN moments and the gradients in another order,
# and Adam's sign-like steps carry that rounding on (tests/test_torch_dp.py).
# Over 16 warm-up steps the params move by a few lr (about 2e-5 in all), so
# they are held by what the update changes, as phase 9 holds dw_pallas on
# against off: Adam's moments (a dropped gradient sum halves mu), the
# params' change over the run, and each param within twice the run's
# summed lr (a step of Adam moves a param by about lr; tests/
# test_torch_trainer.py holds the CPU DP run so).  The bf16 run is held to
# phase 17a's first epoch within phase 11b's bf16 budget: its losses, and
# its moments and BN statistics against their scale (the two runs round
# different activations to bf16 where the BN sums differ in the last bit,
# so a statistic near 0 differs by more than a float32 rtol).
DP_RANKS = 2
DP_LOSS_RTOL = 1e-3
DP_BN_RTOL, DP_BN_ATOL = 1e-3, 1e-5  # tests/test_device_cache.py:635's DP Trainer
DP_TIMEOUT_S = 600


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _dp_step_timing(trainer, rank: int, device) -> dict:
    """One more DP step of `trainer` on its first batch: its host time (to
    a synchronize), then in a second step its all-reduces, each timed from
    a synchronize before it to one after it, then on rank 0 its idle share
    under torch.profiler (rank 1 runs the same steps unprofiled; the
    profiler sees only its own process's device work)."""
    import torch.distributed as dist

    from fullycnnspeechenhancement_torch.cli import train as train_cli

    if trainer._cached_loader is not None:
        ld = trainer._cached_loader
        bucket, meta, flats = trainer._prep_cached_single(next(iter(ld)), ld.flats())
        fn = trainer._cached_fn(bucket, 1)

        def step():
            trainer.state, m = fn(trainer.state, *flats, meta)
            return m
    else:
        loader = train_cli.build_loaders(trainer.config, 2)[0]
        loader.set_epoch(0)
        payload = trainer._prep_single(next(iter(loader)))

        def step():
            trainer.state, m = trainer._step(trainer.state, payload)
            return m

    step()
    _sync(device)
    t0 = time.perf_counter()
    step()
    _sync(device)
    out = {"step_ms": (time.perf_counter() - t0) * 1e3}
    real, spent = dist.all_reduce, []

    def timed(t, *a, **kw):
        _sync(device)
        t1 = time.perf_counter()
        r = real(t, *a, **kw)
        _sync(device)
        spent.append((time.perf_counter() - t1) * 1e3)
        return r

    dist.all_reduce = timed
    try:
        step()
    finally:
        dist.all_reduce = real
    out.update(collective_ms=sum(spent), all_reduces=len(spent))
    if rank == 0 and torch.device(device).type == "cuda":
        host_ms, busy_ms, _ = device_busy_ms(step, reps=2)
        out.update(host_ms=host_ms, busy_ms=busy_ms)
    else:
        for _ in range(3):
            step()
    _sync(device)
    return out


def _dp_rank(rank: int, init_method: str, inis: dict, out_dir: str, device: str) -> None:
    """One of phase 19's ranks, a spawned process: joins the gloo group,
    then trains each INI through `cli.train.main` (the Trainer of
    `data_parallel=2`), its dW launch counts set to 0 just before and read
    just after each run, then times one more step (`_dp_step_timing`)."""
    import torch.distributed as dist

    from fullycnnspeechenhancement_torch.cli import train as train_cli
    from fullycnnspeechenhancement_torch.device import disable_tf32
    from fullycnnspeechenhancement_torch.ops import blocked_dw
    from fullycnnspeechenhancement_torch.parallel import multihost

    disable_tf32()
    multihost.initialize_multihost(init_method, DP_RANKS, rank, backend="gloo", device=device,
                                   timeout_s=DP_TIMEOUT_S)
    out = {}
    try:
        for tag, ini in inis.items():
            blocked_dw.launches = blocked_dw.launches_bf16 = blocked_dw.launches_bf16_mma_sync = 0
            reset_chain_launches()
            t0 = time.perf_counter()
            trainer = train_cli.main(["--cfg", ini, "--device", device, "--num-works", "4"])
            _sync(device)
            out[tag] = {
                "float32": blocked_dw.launches, "bf16_wgmma": blocked_dw.launches_bf16,
                "bf16_mma_sync": blocked_dw.launches_bf16_mma_sync, "bn_chain": list(chain_launches()),
                "proj_train": list(proj_launches()),
                "wall_s": time.perf_counter() - t0,
                "steps": trainer._host_step, "rows": trainer.config.train.batch_size // DP_RANKS,
            }
            out[tag].update(_dp_step_timing(trainer, rank, device))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"dp_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_state_failures(what: str, got: dict, ref: dict, p0: dict, moment_tol: float,
                      drift: float = None, bn_tol: float = None) -> list:
    """The DP run's checkpoint `got` against the single process's `ref`
    (both from the initial params `p0`): Adam's moments against their
    global scale (within `moment_tol`), the params' change over the run
    against its norm (PARITY_UPDATE_TOL), with `drift` every param within
    it of `ref`'s, and the BN moving statistics (elementwise within
    DP_BN_RTOL, DP_BN_ATOL; with `bn_tol`, each leaf within it of the
    leaf's largest value).  Logs every error; returns what failed."""
    failures = []
    for m in ("mu", "nu"):
        err = global_err(flat_leaves(got["opt_state"][m]), flat_leaves(ref["opt_state"][m]))
        log(f"{what}: Adam {m} off by {err:.3e} of its global scale (tolerance {moment_tol:.3e})")
        if not err <= moment_tol:
            failures.append(f"{what} Adam {m} off by {err:.3e} of its scale")
    after, ref_after = flat_leaves(got["params"]), flat_leaves(ref["params"])
    err = update_err(after, ref_after, p0)
    moved = max(np.abs(ref_after[k] - p0[k]).max() for k in p0)
    diff = {k: np.abs(after[k] - v).max() for k, v in ref_after.items()}
    worst = sorted(diff.items(), key=lambda kv: -kv[1])
    log(f"{what}: the params' change differs by {err:.3e} of its norm (tolerance {PARITY_UPDATE_TOL}); the "
        f"single run moved a param by up to {moved:.3e}; largest differences "
        + ", ".join(f"{'/'.join(k)} {v:.3e}" for k, v in worst[:4])
        + ("" if drift is None else f" (bound {drift:.3e}, twice the summed lr)"))
    if not err <= PARITY_UPDATE_TOL:
        failures.append(f"{what} param update off by {err:.3e} of its norm")
    if drift is not None and not worst[0][1] <= drift:
        failures.append(f"{what} param {'/'.join(worst[0][0])} off by {worst[0][1]:.3e} > {drift:.3e}")
    bn, ref_bn = flat_leaves(got["bn_state"]), flat_leaves(ref["bn_state"])
    rel = {k: np.abs(bn[k] - v).max() / max(np.abs(v).max(), 1e-30) for k, v in ref_bn.items()}
    k = max(rel, key=rel.get)
    log(f"{what}: BN moving statistics ({len(rel)} leaves) largest relative error {rel[k]:.3e} ({'/'.join(k)}), "
        f"median {np.median(list(rel.values())):.3e}")
    if bn_tol is None:
        bad = [k for k, v in ref_bn.items() if not np.allclose(bn[k], v, rtol=DP_BN_RTOL, atol=DP_BN_ATOL)]
        limit = f"rtol {DP_BN_RTOL}, atol {DP_BN_ATOL}"
    else:
        bad = [k for k, v in rel.items() if not v <= bn_tol]
        limit = f"{bn_tol:.3e} of their largest value"
    if bad:
        failures.append(f"{what} BN {['/'.join(k) for k in bad]} outside {limit}")
    return failures


def run_data_parallel(dev, tmp: str, corpus: dict, single_last: str) -> dict:
    """Phase 19: `data_parallel=2` through `cli.train` in two spawned ranks
    on the one card (gloo): phase 8's float32 profile for its 16 steps
    against phase 8's single-process run (losses, every parameter and the
    BN moving statistics), then the bf16 `_tpu` profile as written (the
    resident device cache) for 8 steps against phase 17a's first epoch;
    each rank's dW launches, step time, collective time and idle share;
    then a one-rank NCCL group's all-reduce on the card.  Returns the
    ranks' launches by run."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from fullycnnspeechenhancement_torch import load_ini_config
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.parallel import multihost
    from fullycnnspeechenhancement_torch.train.checkpoint import read_checkpoint_file
    from fullycnnspeechenhancement_torch.train.step import create_train_state

    t0 = time.perf_counter()
    model = get_model("FullyCNNV2")
    n_dw = sum(1 for spec in model.layers if spec.kernel[0] == 1 and spec.kernel[1] < 129)
    n_bn = sum(spec.use_norm for spec in model.layers)
    rank_device = str(dev) if dev.index is not None or dev.type != "cuda" else "cuda:0"
    extra = f"data_parallel={DP_RANKS}\n"
    roots = {"float32": os.path.join(tmp, "dp32"), "bf16": os.path.join(tmp, "dp16")}
    inis = {
        "float32": write_train_ini(os.path.join(tmp, "dp32.cfg"), roots["float32"], corpus,
                                   valid_every=EPOCHS + 1, extra_train=extra),
        "bf16": write_train_ini(os.path.join(tmp, "dp16.cfg"), roots["bf16"], corpus, compute_dtype="bfloat16",
                                epochs=1, valid_every=2, use_device_cache=True, extra_train=extra),
    }
    log(f"data parallelism: {DP_RANKS} ranks spawned on one card ({rank_device}), backend gloo (NCCL refuses "
        "two ranks on one device); no scaling is measured")
    store = tempfile.mkdtemp(dir=tmp)
    ctx = mp.start_processes(_dp_rank, args=(f"file://{store}/store", inis, tmp, rank_device), nprocs=DP_RANKS,
                             join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + DP_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the DP ranks still run after {DP_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(10)
    ranks = []
    for r in range(DP_RANKS):
        with open(os.path.join(tmp, f"dp_rank{r}.json")) as f:
            ranks.append(json.load(f))

    # float32 against phase 8
    rows, _ = logged_losses(roots["float32"])
    ref_rows, _ = logged_losses(os.path.join(tmp, "train"))
    steps = len(rows)
    for r, res in enumerate(ranks):
        got = res["float32"]
        log(f"DP float32 rank {r}: {got['steps']} steps of {got['rows']} rows in {got['wall_s']:.1f} s, blocked_dw "
            f"launches {got['float32']} (bf16 {got['bf16_wgmma']} + {got['bf16_mma_sync']})")
        if got["steps"] != steps or got["float32"] != n_dw * steps or got["bf16_wgmma"] or got["bf16_mma_sync"]:
            raise AssertionError(f"DP float32 rank {r}: {got}, expected {n_dw * steps} float32 launches in "
                                 f"{steps} steps")
        check_chain_launches(f"DP float32 rank {r}", tuple(got["bn_chain"]), n_bn, steps)
        check_proj_launches(f"DP float32 rank {r}", tuple(got["proj_train"]), steps, False)
    losses = np.array([x["loss"] for x in rows])
    ref_losses = np.array([x["loss"] for x in ref_rows])
    if steps != EPOCHS * N_UTTS // B_TRAIN or len(ref_losses) != steps:
        raise AssertionError(f"DP float32: {steps} steps logged, phase 8 {len(ref_losses)}")
    rel = np.abs(losses - ref_losses) / np.abs(ref_losses)
    log(f"DP float32 losses {losses.tolist()}; phase 8's {ref_losses.tolist()}; largest relative error "
        f"{rel.max():.3e}")
    np.testing.assert_allclose(losses, ref_losses, rtol=DP_LOSS_RTOL)
    failures = []
    p0 = flat_leaves(create_train_state(load_ini_config(inis["float32"]), model, device="cpu").params)
    dp32 = read_checkpoint_file(os.path.join(roots["float32"], "checkpoints", "RCED_FullyCNNV2",
                                             f"epoch_{EPOCHS - 1}.pt"))
    failures += dp_state_failures("DP float32", dp32, read_checkpoint_file(single_last), p0,
                                  PARITY_MOMENT_TOL, drift=2 * sum(x["lr"] for x in ref_rows))

    # bf16 against phase 17a's first epoch
    rows16, _ = logged_losses(roots["bf16"])
    ref16, _ = logged_losses(os.path.join(tmp, "cache_resident"))
    steps16 = len(rows16)
    for r, res in enumerate(ranks):
        got = res["bf16"]
        log(f"DP bf16 rank {r}: {got['steps']} steps of {got['rows']} rows in {got['wall_s']:.1f} s, dw_wgmma_kernel "
            f"launches {got['bf16_wgmma']} (bf16 mma.sync {got['bf16_mma_sync']}, float32 {got['float32']})")
        if got["steps"] != steps16 or got["bf16_wgmma"] != n_dw * steps16 or got["float32"] or got["bf16_mma_sync"]:
            raise AssertionError(f"DP bf16 rank {r}: {got}, expected {n_dw * steps16} wgmma launches in "
                                 f"{steps16} steps")
        check_chain_launches(f"DP bf16 rank {r}", tuple(got["bn_chain"]), n_bn, steps16)
        check_proj_launches(f"DP bf16 rank {r}", tuple(got["proj_train"]), steps16, True)
    losses16 = np.array([x["loss"] for x in rows16])
    ref16 = np.array([x["loss"] for x in ref16[:steps16]])
    if steps16 != N_UTTS // B_TRAIN or len(ref16) != steps16:
        raise AssertionError(f"DP bf16: {steps16} steps logged, phase 17a's first epoch {len(ref16)}")
    rel16 = np.abs(losses16 - ref16) / np.abs(ref16)
    log(f"DP bf16 losses {losses16.tolist()}; phase 17a's first epoch {ref16.tolist()}; largest relative "
        f"error {rel16.max():.3e} (budget {PARITY_LOSS_RTOL_BF16})")
    np.testing.assert_allclose(losses16, ref16, rtol=PARITY_LOSS_RTOL_BF16)
    dp16 = read_checkpoint_file(os.path.join(roots["bf16"], "checkpoints", "RCED_FullyCNNV2", "epoch_0.pt"))
    ref16_blob = read_checkpoint_file(os.path.join(tmp, "cache_resident", "checkpoints", "RCED_FullyCNNV2",
                                                   "epoch_0.pt"))
    p0_16 = flat_leaves(create_train_state(load_ini_config(inis["bf16"]), model, device="cpu").params)
    failures += dp_state_failures("DP bf16", dp16, ref16_blob, p0_16, PARITY_MOMENT_TOL_BF16,
                                  bn_tol=PARITY_MOMENT_TOL_BF16)
    if failures:
        raise AssertionError("DP against the single process: " + "; ".join(failures))

    for tag in ("float32", "bf16"):
        for r, res in enumerate(ranks):
            got = res[tag]
            idle = "" if got.get("busy_ms") is None else (
                f", device busy {got['busy_ms']:.2f} ms of {got['host_ms']:.2f} ms traced, idle share "
                f"{1 - got['busy_ms'] / got['host_ms']:.3f}")
            log(f"DP {tag} rank {r} (for the record, two ranks sharing one card): step {got['step_ms']:.2f} ms, "
                f"{got['all_reduces']} all-reduces in {got['collective_ms']:.2f} ms a step (each timed between "
                f"synchronizes){idle}")

    # NCCL: a one-rank group on the card, started here and torn down
    t1 = time.perf_counter()
    multihost.initialize_multihost(f"file://{store}/nccl", 1, 0, backend="nccl", device=rank_device)
    try:
        x = torch.arange(1024, dtype=torch.float32, device=rank_device)
        dist.all_reduce(x)
        _sync(rank_device)
        if not torch.equal(x.cpu(), torch.arange(1024, dtype=torch.float32)):
            raise AssertionError("NCCL all-reduce of one rank changed its input")
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    log(f"NCCL: a one-rank group ({backend}) started and all-reduced 1024 floats on the card in "
        f"{time.perf_counter() - t1:.2f} s")
    phase("data parallelism", t0)
    return {tag: [res[tag]["float32"] + res[tag]["bf16_wgmma"] for res in ranks] for tag in ("float32", "bf16")}


def run_time_sharded(dev, tmp: str) -> None:
    """Phase 20: phase 3's fused V2 engine built with a mesh of the card
    four times: a 60 s request (past the 32 s top bucket) runs through the
    time-sharded halo forward (plain model, as in the JAX package), within
    MAIN_TOL * max|ref| of the meshless engine's; a 6 s request keeps the
    bucketed path and equals the meshless engine's bit for bit."""
    from fullycnnspeechenhancement_torch import Config, ModelConfig
    from fullycnnspeechenhancement_torch.infer import InferenceEngine
    from fullycnnspeechenhancement_torch.parallel import make_mesh

    t0 = time.perf_counter()
    npz = os.path.join(tmp, "v2.npz")  # phase 3's weights
    cfg = Config(model=ModelConfig(net_work="FullyCNNV2", fused_inference=True))
    mesh = make_mesh(4, devices=[dev] * 4)
    meshed = InferenceEngine(cfg, checkpoint=npz, device=dev, mesh=mesh)
    plain = InferenceEngine(cfg, checkpoint=npz, device=dev)
    calls = []
    real = meshed._sharded_model

    def recording(params, bn, mag):
        calls.append(tuple(mag.shape))
        return real(params, bn, mag)

    meshed._sharded_model = recording
    rng = np.random.default_rng(20)
    for seconds, sharded in ((60.0, True), (6.0, False)):
        sig = speech_like(rng, seconds)
        before = len(calls)
        got = meshed.denoise_array(sig)
        ref = plain.denoise_array(sig)
        if len(calls) - before != int(sharded):
            raise AssertionError(f"{seconds} s request: {len(calls) - before} halo calls, expected {int(sharded)}")
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        if not np.isfinite(got).all() or got.shape != sig.shape:
            raise AssertionError(f"{seconds} s request: output {got.shape}, finite {np.isfinite(got).all()}")
        if sharded and err > MAIN_TOL:
            raise AssertionError(f"60 s through the halo: {err:.3e} of max|ref|, over {MAIN_TOL}")
        if not sharded and not np.array_equal(got, ref):
            raise AssertionError(f"6 s request with a mesh: {err:.3e} of max|ref| from the meshless engine")
        times = {}
        for name, eng in (("mesh", meshed), ("meshless", plain)):
            t1 = time.perf_counter()
            for _ in range(3):
                eng.denoise_array(sig)
            times[name] = (time.perf_counter() - t1) / 3 * 1e3
        log(f"{seconds:.0f} s request: " + (f"halo path over {mesh.shape['data']} shards of {calls[-1][1] // 4} "
            f"frames (T padded to {calls[-1][1]})" if sharded else "bucketed path") +
            f", max abs err {err:.3e} of max|ref| {np.abs(ref).max():.4f} against the meshless fused engine; "
            f"host ms mesh {times['mesh']:.2f}, meshless {times['meshless']:.2f} (not gated)")
    phase("time-sharded serving", t0)


def run_prepare(tmp: str) -> None:
    """Phase 21: an aishell_1-shaped tree (16 kHz wavs under
    ASR/aishell_1/data_aishell/wav/{train,dev,test}/<speaker>/) and a noise
    tree (Noise/far/{train,dev,test}/), made up here, through the port's
    `prepare` modules to 8 kHz manifests, read back through the port's
    `SpeechDataset`.  Host code: a quick check, not a card measurement."""
    from fullycnnspeechenhancement_torch.data import write_wav
    from fullycnnspeechenhancement_torch.data.dataset import SpeechDataset
    from fullycnnspeechenhancement_torch.data.prepare import aishell_1, noise

    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    root = os.path.join(tmp, "prepare")
    a1, nz = os.path.join(root, "ASR", "aishell_1"), os.path.join(root, "Noise", "far")
    counts = {}
    for split, spks in (("train", ["S0002", "S0003", "S0004"]), ("dev", ["S0724"]), ("test", ["S0764"])):
        for spk in spks:
            d = os.path.join(a1, "data_aishell", "wav", split, spk)
            os.makedirs(d, exist_ok=True)
            for u in range(3):
                write_wav(os.path.join(d, f"B{spk}W{u}.wav"), speech_like(rng, rng.uniform(1.0, 3.0), 16000), 16000)
        d = os.path.join(nz, split)
        os.makedirs(d, exist_ok=True)
        for u in range(2):
            write_wav(os.path.join(d, f"n{u}.wav"), noise_like(rng, 4.0, 16000), 16000)
        counts[split] = 3 * len(spks)
    prefix_a1, prefix_nz = os.path.join(root, "manifests", "aishell_1"), os.path.join(root, "manifests", "noise")
    aishell_1.prepare(a1, prefix_a1, SR, workers=2)
    noise.prepare(nz, prefix_nz, SR, workers=2)
    for split, n in counts.items():
        ds = SpeechDataset(f"{prefix_a1}.{split}", f"{prefix_nz}.{split}", SR, seed=0)
        if len(ds) != n:
            raise AssertionError(f"prepare {split}: {len(ds)} utterances in the manifest, {n} written")
        for i in range(len(ds)):
            mix, clean = ds[i]
            want = int(round(ds.items[i].duration * SR))
            if len(mix) != len(clean) or abs(len(clean) - want) > 1 or not np.isfinite(mix).all():
                raise AssertionError(f"prepare {split} item {i}: {len(mix)}/{len(clean)} samples, {want} listed")
            if "8K" not in ds.items[i].audio_filepath:
                raise AssertionError(f"prepare {split}: {ds.items[i].audio_filepath} is not the resampled copy")
    log(f"prepare: aishell_1 and noise manifests for {counts} utterances, resampled 16 kHz -> {SR} Hz and "
        "read back through SpeechDataset")
    phase("prepare", t0)


# Phase 23: `quality.run_quality` runs, each (loader, compute dtype,
# epochs, start).  32 utterances at batch 8 are 4 batches an epoch from the
# resident cache (240 steps in 60 epochs), 5 from the rotating one (3
# shards), so 60 epochs there are about the 300 steps of the v5e's
# rotating run.  "jax" starts from QUALITY_INIT_NPZ, the JAX Trainer's
# own init (PRNGKey(0)) that the v5e's runs started from, and is held to
# the three margins; "own" starts from the port's Trainer init (seed 0),
# from which the recipe misses the STOI margin at 240 steps in both
# packages alike (PERF.md, Findings), and is recorded.
QUALITY_RUNS = {
    "bf16_resident": ("resident", "bfloat16", 60, "jax"),
    "bf16_rotating": ("rotating", "bfloat16", 60, "jax"),
    "float32_resident": ("resident", "float32", 60, "jax"),
    "bf16_resident_own_init": ("resident", "bfloat16", 60, "own"),
    "bf16_rotating_own_init": ("rotating", "bfloat16", 60, "own"),
    "float32_resident_own_init": ("resident", "float32", 60, "own"),
}
# written by tests/torch_quality_recipe.py init-npz
QUALITY_INIT_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                                "quality_v2_init_jax_prngkey0.npz")
# benchmarks/PERF_NOTES.md, rounds 4 and 5: quality_run.py on a TPU v5e
# (the JAX package's record, not this port's): (STOI, SDR dB, PESQ).
QUALITY_V5E = {
    "noisy mix": (0.575, 0.00, 3.64),
    "untrained": (0.162, -1.15, 3.22),
    "trained, resident, 240 steps": (0.779, 3.86, 4.04),
    "trained, rotating (3 shards), 300 steps": (0.809, 3.919, 4.069),
}


def run_quality_phase(dev, tmp: str) -> dict:
    """Phase 23: does the port learn on the card?  `quality.run_quality`
    (benchmarks/quality_run.py's recipe through the Trainer and the device
    cache) with dw_pallas and fused scoring, once per QUALITY_RUNS entry,
    each kernel's launch counts set to 0 just before each run and read
    just after: under bf16 14 `dw_wgmma_kernel` launches a step and none of
    the bf16 mma.sync or float32 dW kernels, in float32 14 3xTF32 ones a
    step and no bf16 one; one float32 `rced_stack` launch a scoring call
    (4 held-out utterances for the untrained and the trained model), no
    bf16 one.  Every run scores PESQ with `p862-native` and holds its fused
    predictions within MAIN_TOL of max|unfused| of the unfused float32
    forward; each run from the v5e's start (QUALITY_INIT_NPZ) must meet
    tests/test_quality.py's three margins (run_quality raises otherwise),
    the runs from the port's own init are recorded.  Returns each run's
    launches."""
    from fullycnnspeechenhancement_torch import quality
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.ops import blocked_dw, rced_stack

    model = get_model("FullyCNNV2")
    n_dw = sum(1 for spec in model.layers if spec.kernel[0] == 1 and spec.kernel[1] < 129)
    log("quality reference, a TPU v5e's (benchmarks/PERF_NOTES.md; not this card): "
        + json.dumps({k: dict(zip(("stoi", "sdr", "pesq_native"), v)) for k, v in QUALITY_V5E.items()}))
    launches = {}
    for tag, (loader, dtype, epochs, start) in QUALITY_RUNS.items():
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        blocked_dw.launches = blocked_dw.launches_bf16 = blocked_dw.launches_bf16_mma_sync = 0
        rced_stack.launches = rced_stack.launches_bf16 = rced_stack.launches_bf16_wgmma = 0
        r = quality.run_quality(device=dev, epochs=epochs, train_utts=32, loader=loader, compute_dtype=dtype,
                                dw_pallas=True, fused_inference=True, root=os.path.join(tmp, f"quality_{tag}"),
                                gate=start == "jax", init_npz=QUALITY_INIT_NPZ if start == "jax" else "")
        torch.cuda.synchronize()
        got = {
            "dw_float32": blocked_dw.launches, "dw_bf16_wgmma": blocked_dw.launches_bf16,
            "dw_bf16_mma_sync": blocked_dw.launches_bf16_mma_sync, "stack_float32": rced_stack.launches,
            "stack_bf16": rced_stack.launches_bf16 + rced_stack.launches_bf16_wgmma,
        }
        dw_key = "dw_bf16_wgmma" if dtype == "bfloat16" else "dw_float32"
        want = {k: 0 for k in got}
        want[dw_key] = n_dw * r["steps"]
        want["stack_float32"] = 2 * quality.HELD_OUT
        log(f"quality {tag}: " + json.dumps(r))
        log(f"quality {tag}: {r['steps']} steps in {r['train_wall_s']:.3f} s "
            f"({1e3 * r['train_wall_s'] / r['steps']:.3f} ms a step, compiles and cache commits included); "
            f"launches {json.dumps(got)}; margins {json.dumps(r['margins'])}"
            + (" (held)" if start == "jax" else " (recorded, not held: the port's own init)"))
        if got != want:
            raise AssertionError(f"quality {tag}: launches {got}, expected {want}")
        if r["pesq"] != "p862-native":
            raise AssertionError(f"quality {tag}: PESQ from {r['pesq']}")
        if not r["fused_max_rel_err"] < MAIN_TOL:
            raise AssertionError(f"quality {tag}: fused scoring {r['fused_max_rel_err']:.3e} of max|unfused| "
                                 f"from the unfused float32 forward (tolerance {MAIN_TOL})")
        launches[tag] = {"dw": got[dw_key], "stack": got["stack_float32"]}
        phase(f"quality {tag}", t0)
    return launches


# The rate of independent mma.sync.m16n8k8 TF32 products (and, in the
# second kernel, m16n8k16 bf16 ones) when nothing else is issued, A and B
# from 2 and 8 register sets as in blocked_dw.cu: the most that kernel's
# instruction could give, beside the data sheet's 495 (989 in bf16)
# TFLOP/s, which wgmma reaches; and, in the third, the rate of the wgmma
# products the bf16 dW kernel issues.
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
// The same with mma.sync.m16n8k16 on bf16 operands (float32 accumulators),
// as the bf16 modes of rced_stack.cu and blocked_dw.cu issue it.
__global__ void __launch_bounds__(128) mma_rate_bf16(float* out, int iters) {
  uint32_t a[2][4], b[8][2];
  for (int i = 0; i < 2; ++i) for (int c = 0; c < 4; ++c) a[i][c] = threadIdx.x * (i + 3) + c;
  for (int i = 0; i < 8; ++i) for (int c = 0; c < 2; ++c) b[i][c] = threadIdx.x * (i + 5) + c;
  float acc[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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
extern "C" int mma_rate_bf16_launch(float* out, int blocks, int iters) {
  mma_rate_bf16<<<blocks, 128>>>(out, iters);
  return (int)cudaGetLastError();
}
// wgmma.m64n64k16 on bf16 operands from shared memory, both MN-major under
// the 128-byte swizzle, float32 accumulators, as blocked_dw.cu's
// dw_wgmma_kernel issues it: two warpgroups a block, one block an SM, four
// accumulators, groups of 40 products with one group in flight, on random
// bf16 values of magnitude about 1.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  const uint64_t off = 1024 >> 4;
  return (uint64_t)((addr >> 4) & 0x3FFF) | (off << 16) | (off << 32) | (1ull << 62);
}
#define R8(b) "+f"(c[b]), "+f"(c[b + 1]), "+f"(c[b + 2]), "+f"(c[b + 3]), "+f"(c[b + 4]), \
              "+f"(c[b + 5]), "+f"(c[b + 6]), "+f"(c[b + 7])
__device__ __forceinline__ void wgmma64(float (&c)[32], uint64_t a, uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, "
               "%8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
               "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
               : R8(0), R8(8), R8(16), R8(24) : "l"(a), "l"(b), "r"(1));
}
__global__ void __launch_bounds__(256, 1) wgmma_rate(float* out, int iters) {
  extern __shared__ uint8_t raw[];
  const uint32_t raw_addr = (uint32_t)__cvta_generic_to_shared(raw);
  const uint32_t base = (raw_addr + 1023) & ~1023u;
  uint32_t* w = (uint32_t*)(raw + (base - raw_addr));
  for (int i = threadIdx.x; i < 96 * 1024 / 4; i += blockDim.x) {
    uint32_t h = i * 2654435761u + blockIdx.x * 97u;
    h ^= h >> 13;
    h *= 0x5bd1e995u;
    h ^= h >> 15;
    w[i] = (h & 0x807f807fu) | 0x3f003f00u;  // two bf16 in +-[1, 2)
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float c[4][32];
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 32; ++i) c[t][i] = 0.f;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // a loop, as the kernel's k16 loop is: unrolled, ptxas serialises
    // these wgmma
#pragma unroll 1
    for (int k = 0; k < 10; ++k) {
#pragma unroll
      for (int t = 0; t < 4; ++t) wgmma64(c[t], wg_desc(base + 2048 * k), wg_desc(base + 40960 + 1024 * (2 * k + t)));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
  for (int t = 0; t < 4; ++t)
    for (int i = 0; i < 32; ++i) s += c[t][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int wgmma_rate_launch(float* out, int blocks, int iters) {
  const int smem = 97 * 1024;
  cudaFuncSetAttribute(wgmma_rate, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wgmma_rate<<<blocks, 256, smem>>>(out, iters);
  return (int)cudaGetLastError();
}
// One wgmma.m64n8k16 with both operands K-major without swizzle, read
// from an image the host writes into shared memory under the descriptors
// it gives (start, leading- and stride-byte offsets, in bytes from the
// image), as rced_stack.cu's bf16 kernel builds them: D[m][n] lands in
// out[8 m + n].
__global__ void __launch_bounds__(128) wgmma_desc_probe(const uint4* img, int units, const uint32_t* d,
                                                        float* out) {
  extern __shared__ uint4 image[];
  for (int i = threadIdx.x; i < units; i += 128) image[i] = img[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(image);
  uint64_t desc[2];
  for (int o = 0; o < 2; ++o)
    desc[o] = (uint64_t)(((base + d[3 * o]) >> 4) & 0x3FFF) | ((uint64_t)((d[3 * o + 1] >> 4) & 0x3FFF) << 16) |
              ((uint64_t)((d[3 * o + 2] >> 4) & 0x3FFF) << 32);
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "l"(desc[0]), "l"(desc[1]), "r"(1));
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  asm volatile("" : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])::"memory");
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int e = 0; e < 4; ++e) out[(16 * w + l / 4 + 8 * (e / 2)) * 8 + 2 * (l % 4) + (e % 2)] = c[e];
}
extern "C" int wgmma_desc_probe_launch(const void* img, int units, const uint32_t* d, float* out) {
  cudaFuncSetAttribute(wgmma_desc_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, units * 16);
  wgmma_desc_probe<<<1, 128, units * 16>>>((const uint4*)img, units, d, out);
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


def mma_sync_tflops(lib_path: str, bf16: bool = False) -> float:
    """TFLOP/s of MMA_RATE_SRC's TF32 kernel (m16n8k8, 2048 FLOP an mma)
    or its bf16 one (m16n8k16, 4096): 16 warps per SM, 16 independent
    accumulators each, timed with CUDA events after a warm-up."""
    import ctypes

    launch = getattr(ctypes.CDLL(lib_path), "mma_rate_bf16_launch" if bf16 else "mma_rate_launch")
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 128, device="cuda")
    iters = 10000
    if launch(out.data_ptr(), blocks, 100) != 0:
        raise RuntimeError("mma_rate launch failed")
    ms = cuda_ms(lambda: launch(out.data_ptr(), blocks, iters), reps=3, warmup=1)
    return blocks * 4 * iters * 16 * (4096 if bf16 else 2048) / ms / 1e9


def wgmma_tflops(lib_path: str) -> float:
    """TFLOP/s of MMA_RATE_SRC's wgmma kernel (m64n64k16 on bf16 from shared
    memory, 131,072 FLOP a product): one block of two warpgroups per SM,
    timed with CUDA events after a warm-up."""
    import ctypes

    launch = ctypes.CDLL(lib_path).wgmma_rate_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, device="cuda")
    iters = 4000
    if launch(out.data_ptr(), blocks, 10) != 0:
        raise RuntimeError("wgmma_rate launch failed")
    ms = cuda_ms(lambda: launch(out.data_ptr(), blocks, iters), reps=3, warmup=1)
    return blocks * 2 * iters * 40 * 2 * 64 * 64 * 16 / ms / 1e9


# The descriptor probe's cases (A's start, leading- and stride-byte offsets,
# in bytes; B at WG_PROBE_B with offsets 128 and 128, the layout of
# rced_stack.cu's B at n = 8): K-major without swizzle, core matrices of 8
# rows of 16 bytes, the stride-byte offset between the 8-row groups along
# M and the leading-byte offset between the two k8 halves, as the bf16
# stack kernel reads its shadow: two channel groups of one tap (135 rows
# apart), two taps of one group (16 bytes apart: the core matrices
# overlap), a pad block (offset 0), a tap-crossing pair, all from starts
# not on a 128-byte line.
WG_PROBE_CASES = {
    "two_groups": (16 * 7, 2160, 128),
    "two_taps_overlapping": (16 * 7, 16, 128),
    "pad_block_lbo_0": (16 * 3, 0, 128),
    "tap_crossing": (16 * 9, 3 * 2160 - 16, 128),
}
WG_PROBE_B = 12288
WG_PROBE_BYTES = 16384


def wgmma_descriptor_probe(lib_path: str) -> dict:
    """Runs MMA_RATE_SRC's descriptor probe on each WG_PROBE_CASES case on
    an image of small integers (every product and sum exact in float32)
    and holds the result, exactly, against the product the model of the
    descriptor gives: A[m][k] at start + 16 (m % 8) + SBO (m // 8) + LBO
    (k // 8) + 2 (k % 8), and B[n][k] likewise.  Raises on a difference;
    returns each case's largest one (0)."""
    import ctypes

    launch = ctypes.CDLL(lib_path).wgmma_desc_probe_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    rng = np.random.default_rng(0)
    vals = torch.as_tensor(rng.integers(-4, 5, WG_PROBE_BYTES // 2).astype(np.float32)).to(torch.bfloat16)
    img = vals.view(torch.uint8)

    def read(start, lbo, sbo, rows):
        r, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
        at = start + 16 * (r % 8) + sbo * (r // 8) + lbo * (k // 8) + 2 * (k % 8)
        return vals[torch.as_tensor(at // 2)].float()

    out = {}
    for name, (start, lbo, sbo) in WG_PROBE_CASES.items():
        d = torch.tensor([start, lbo, sbo, WG_PROBE_B, 128, 128], dtype=torch.int32, device="cuda")
        got = torch.full((64 * 8,), float("nan"), device="cuda")
        img_d = img.to("cuda")
        if launch(img_d.data_ptr(), WG_PROBE_BYTES // 16, d.data_ptr(), got.data_ptr()) != 0:
            raise RuntimeError(f"wgmma descriptor probe {name}: launch failed")
        torch.cuda.synchronize()
        want = read(start, lbo, sbo, 64) @ read(WG_PROBE_B, 128, 128, 8).t()
        err = (got.cpu().view(64, 8) - want).abs().max().item()
        if not err == 0.0:
            raise AssertionError(f"wgmma descriptor probe {name} (start {start}, LBO {lbo}, SBO {sbo}): "
                                 f"max abs err {err} against the model of the descriptor")
        out[name] = err
    return out


def build_kernels() -> str:
    """Phase 2: one nvcc per CUDA source, all started together, the native
    runtime's g++ and the mma.sync rate probe beside them; returns the
    probe's library."""
    from concurrent.futures import ThreadPoolExecutor

    from fullycnnspeechenhancement_torch.data import native
    from fullycnnspeechenhancement_torch.ops import blocked_dw, bn_chain, build, freq_conv, rced_edges, rced_stack

    names = ("rced_stack", "rced_edges", "blocked_dw", "freq_conv", "bn_chain")

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
    rced_edges.load_library()
    blocked_dw.load_library()
    freq_conv.load_library()
    bn_chain.load_library()
    for name in names:
        log(f"build: {name}.cu in {seconds[name]:.1f} s")
        log_path = f"{build.library_path(name)}.log"
        if os.path.exists(log_path):
            lines = open(log_path).read().splitlines()
            for line in lines:
                if "C7519" in line:  # warpgroup.arrive injected around wgmma: counted below
                    continue
                if ("registers" in line or "smem" in line or "spill" in line or "entry function" in line
                        or "serialized" in line):
                    log(f"  ptxas: {line.strip()}")
            injected = sum("C7519" in line for line in lines)
            if injected:
                log(f"  ptxas: {injected} notes of a warpgroup.arrive injected before a wgmma")
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
    rate_lib = build_kernels()
    mma_rate = mma_sync_tflops(rate_lib)
    rate_bf16 = mma_sync_tflops(rate_lib, bf16=True)
    rate_wgmma = wgmma_tflops(rate_lib)
    log(f"mma.sync m16n8k8 TF32 alone: {mma_rate:.1f} TFLOP/s; m16n8k16 bf16 alone: {rate_bf16:.1f} TFLOP/s; "
        f"wgmma m64n64k16 bf16 (shared-memory operands) alone: {rate_wgmma:.1f} TFLOP/s")
    probe = wgmma_descriptor_probe(rate_lib)
    log("wgmma K-major descriptors without swizzle (rced_stack.cu's bf16 kernel) against their model, max abs "
        "err: " + json.dumps(probe))
    phase("build", t0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        stack_entry, stack_bf16_entry, edge_entries = run_serving(dev, tmp, mma_rate, rate_bf16, rate_wgmma)
        phase("serving", t0)
        dw_entry, last_checkpoint, train_ctx = run_training(dev, tmp, mma_rate)
        dw_bf16_entry = run_training_bf16(dev, tmp, train_ctx, rate_bf16, rate_wgmma)
        chain_bn_entry = run_bn_chain(dev)
        proj_entry = run_proj_train(dev)
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
        t0 = time.perf_counter()
        run_streaming(dev, tmp)
        phase("streaming", t0)
        cache_launches = run_device_cache(dev, tmp, train_ctx)
        t0 = time.perf_counter()
        run_export(dev, tmp, last_checkpoint)
        phase("export", t0)
        dp_launches = run_data_parallel(dev, tmp, train_ctx["corpus"], last_checkpoint)
        run_time_sharded(dev, tmp)
        run_prepare(tmp)
        quality_launches = run_quality_phase(dev, tmp)
    dw_entry["launches_by_path"] = {"single_process": dw_entry["launches"]}
    for r, n in enumerate(dp_launches["float32"]):
        dw_entry["launches_by_path"][f"data_parallel_rank{r}"] = n
    dw_bf16_entry["launches_by_path"] = {
        "host_loader": dw_bf16_entry["launches"],
        "device_cache_resident": cache_launches["resident"],
        "device_cache_rotating": cache_launches["rotating"],
    }
    for r, n in enumerate(dp_launches["bf16"]):
        dw_bf16_entry["launches_by_path"][f"device_cache_data_parallel_rank{r}"] = n
    for tag, n in quality_launches.items():
        entry = dw_bf16_entry if tag.startswith("bf16") else dw_entry
        entry["launches_by_path"][f"quality_{tag}"] = n["dw"]
    dw_entry["launches"] = sum(dw_entry["launches_by_path"].values())
    dw_bf16_entry["launches"] = sum(dw_bf16_entry["launches_by_path"].values())
    stack_entry["launches_by_path"] = {"serving": stack_entry["launches"], "evaluation": evaluation["launches"]}
    for tag, n in quality_launches.items():
        stack_entry["launches_by_path"][f"quality_{tag}_scoring"] = n["stack"]
    stack_entry["launches"] = sum(stack_entry["launches_by_path"].values())
    stack_entry["max_abs_err"] = max(stack_entry["max_abs_err"], evaluation["max_abs_err"])

    conv_sum, stack_sum = probe_path["summary"]["freq_conv"], probe_path["summary"]["freq_conv_stack"]
    conv_entry = {
        "name": "freq_conv",
        "dtype": "float32",
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
        "bound_note": "3xTF32 on the tensor cores at the data sheet's TF32 rate",
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
        "dtype": "float32",
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
        "bound_note": "3xTF32 on the tensor cores at the data sheet's TF32 rate",
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
    chain_bn_entry["launches_by_path"] = dict(CHAIN_LAUNCHES)
    chain_bn_entry["launches"] = sum(CHAIN_LAUNCHES.values())
    proj_entry["launches_by_path"] = dict(PROJ_LAUNCHES)
    proj_entry["launches"] = sum(PROJ_LAUNCHES.values())
    entries = [stack_entry, stack_bf16_entry, *edge_entries, dw_entry, dw_bf16_entry, conv_entry, chain_entry,
               chain_bn_entry, proj_entry]
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
