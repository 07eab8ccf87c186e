"""The host's untraced time of the training cell's step, beside the device's.

The step is `rced16-train-cached`'s: V2, bf16, blocked with `dw_pallas`,
the cached step over device flats (B rows of 4.5 s in the T-frame bucket).
Each of the K steps of a dispatch is launched alone behind a spin kernel
between two CUDA events, so the host never waits on the device: the host
clock around the step times the host alone, and where the spin outlasted
it (the first event not yet reached) the events time the device alone.
(A whole K-step dispatch behind one spin would fill the device's queue of
pending launches, and the host would wait on it.)  Beside them, the wall
time of K-step dispatches run back to back (`make_cached_multi_step`, a
sync after each).  No profiler runs.

For each step it also reads the garbage collector's passes and time
(`gc.callbacks`), which the host clock holds besides the step's own work.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 step_host.py [--rows 64] [--frames 384] [--steps 8] [--reps 3]

It prints one JSON line, in ms a step: medians over `reps` dispatches of K
steps, and every step's reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time

import torch


class GcClock:
    """The garbage collector's passes and seconds since the last `take`."""

    def __init__(self):
        self.n, self.s, self._t = 0, 0.0, None
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.n += 1
            self.s += time.perf_counter() - self._t
            self._t = None

    def take(self):
        out = (self.n, self.s * 1e3)
        self.n, self.s = 0, 0.0
        return out


def measure(dev, B: int, T: int, K: int, reps: int, seconds: float = 4.5) -> dict:
    from fullycnnspeechenhancement_torch.config import Config, ModelConfig, TrainConfig
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.train.cached_step import (
        Meta,
        make_cached_multi_step,
        make_cached_train_step,
    )
    from fullycnnspeechenhancement_torch.train.step import create_train_state, make_train_step, pack_step_metrics

    cfg = Config(model=ModelConfig(net_work="FullyCNNV2", compute_dtype="bfloat16", blocked_compute=True,
                                   dw_pallas=True),
                 train=TrainConfig(batch_size=B, steps_per_call=K))
    model = get_model("FullyCNNV2")
    state = create_train_state(cfg, model, torch.Generator().manual_seed(11), device=dev)
    L = cfg.dsp.padded_samples(T)
    n = int(seconds * cfg.dsp.sample_rate)
    gen = torch.Generator(device=dev).manual_seed(11)
    flats = [(torch.randn(K * B, L, device=dev, generator=gen) * 3000).to(torch.int16) for _ in range(2)]
    rows = torch.arange(K * B, device=dev, dtype=torch.int32).reshape(K, B)
    zeros = torch.zeros(K, B, device=dev, dtype=torch.int32)
    meta = Meta(rows, zeros, rows, zeros, torch.ones(K, B, device=dev),
                torch.full((K, B), n, device=dev, dtype=torch.int32))
    train_step = make_train_step(cfg, model)
    multi = make_cached_multi_step(train_step, L, premixed=False)
    single = make_cached_train_step(train_step, L, premixed=False)
    for _ in range(2):
        state, packed = multi(state, *flats, meta)
    torch.cuda.synchronize()
    if not torch.isfinite(packed).all():
        raise AssertionError(f"step host time: non-finite metrics {packed.tolist()}")
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, packed = multi(state, *flats, meta)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t1) * 1e3 / K)
    gcc = GcClock()
    steps = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 2 * 10**8
    while len(steps) < reps * K:
        k = len(steps) % K
        step_meta = type(meta)(*(f[k] for f in meta))
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        gcc.take()
        t1 = time.perf_counter()
        state, m = single(state, *flats, step_meta)
        pack_step_metrics(m)
        took = (time.perf_counter() - t1) * 1e3
        ahead = not start.query()
        end.record()
        torch.cuda.synchronize()
        if not ahead:
            if cycles >= 4 * 10**9:
                raise AssertionError(f"step host time: a step took {took:.1f} ms of host time behind a spin of "
                                     f"{cycles} cycles: its launches fill the device's queue")
            cycles *= 2
            continue
        n_gc, gc_ms = gcc.take()
        steps.append({"host": took, "device": start.elapsed_time(end), "gc_passes": n_gc, "gc": gc_ms})

    def med(key):
        return statistics.median(s[key] for s in steps)

    out = {"host_ms_per_step": med("host"), "device_ms_per_step": med("device"),
           "wall_ms_per_step": statistics.median(wall), "gc_ms_per_step": med("gc"),
           "host_ms_all": [s["host"] for s in steps], "device_ms_all": [s["device"] for s in steps],
           "gc_passes_all": [s["gc_passes"] for s in steps], "gc_ms_all": [s["gc"] for s in steps],
           "wall_ms_all": wall, "spin_cycles": cycles, "rows": B, "frames": T, "steps_per_dispatch": K}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--frames", type=int, default=384)
    ap.add_argument("--steps", type=int, default=8, help="steps of a dispatch")
    ap.add_argument("--reps", type=int, default=3, help="dispatches timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_host: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    from fullycnnspeechenhancement_torch.device import disable_tf32

    disable_tf32()
    out = measure(torch.device("cuda"), args.rows, args.frames, args.steps, args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
