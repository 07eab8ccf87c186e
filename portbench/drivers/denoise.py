"""Serving window: one caller in a closed loop into
`InferenceEngine.denoise_array`, each request timed on the host clock from
the call with its numpy waveform to the numpy result.

Set-up builds the engine from the cell's configuration (weights from the
seed through the engine's own init), makes the mix's pool of recordings
and serves each once, which builds every kernel and warms every padded
length the window sends.  Request k of the window is the pool's
`order[k % pool]`.  The output of the last call of each checked
recording (a seeded sample of the pool and its longest) is kept and,
once the window has closed and the engine is freed, held to the plain
reference.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import check, devtrace, gen
from portbench.drivers import Outcome, Readings, memory_peak, program_config, sync
from portbench.reference import dsp
from portbench.reference.specs import MODELS


def checked_indices(pool, seed: int, n: int) -> list:
    rng = np.random.default_rng((seed, 3))
    pick = set(int(i) for i in rng.choice(len(pool), size=min(n, len(pool)), replace=False))
    pick.add(int(np.argmax([len(x) for x in pool])))
    return sorted(pick)


def serve(engine, requests, seconds: float, keep, window=None):
    """The closed loop: (latencies s, frames of each request, failures,
    {pool index: last output}, window s) of the requests sent until
    `seconds` have passed and the pool has been sent whole at least once."""
    from torch.profiler import record_function

    pool, order = requests
    lat, frames, kept, failed = [], [], {}, 0
    if window is not None:
        window.start()
    t0 = time.perf_counter()
    k = 0
    while True:
        i = int(order[k % len(order)])
        k += 1
        x = pool[i]
        t = time.perf_counter()
        try:
            if window is not None:
                with record_function("portbench.request"):
                    y = engine.denoise_array(x)
            else:
                y = engine.denoise_array(x)
            lat.append(time.perf_counter() - t)
            if i in keep:
                kept[i] = y
        except Exception as e:  # a failed request is counted, and misses every limit
            print(f"portbench: request {k} ({len(x)} samples) failed: {e!r}", flush=True)
            lat.append(float("inf"))
            failed += 1
        frames.append(dsp.num_frames(len(x)))
        t_end = time.perf_counter()
        if t_end - t0 >= seconds and k >= len(order):
            break
    if window is not None:
        window.stop()
    return lat, frames, failed, kept, t_end - t0


def run(cell, args, device, t_process: float, tmp: str) -> Outcome:
    from fullycnnspeechenhancement_torch.infer import InferenceEngine

    net = cell.config["ini"]["model"]["net_work"]
    config = program_config(cell, args.seed, tmp, {"data": {"audio_save_path": f"{tmp}/denoise"}})
    engine = InferenceEngine(config, device=device)
    requests = gen.request_pool(cell.traffic, args.seed)
    for x in requests.pool:
        engine.denoise_array(x)
    keep = checked_indices(requests.pool, args.seed, cell.traffic["checked"])
    sync(device)
    window = devtrace.Window() if args.trace else None
    t_window = time.perf_counter()
    lat, frames, failed, kept, window_s = serve(engine, requests, args.seconds, keep, window)
    peak = memory_peak(device)
    summary = window.summary() if window is not None else None
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    layers = MODELS[net]
    if all(i in kept for i in keep):
        numbers = check.serve_numbers(
            [(kept[i], check.serving_reference(layers, args.seed, requests.pool[i], device)) for i in keep])
    else:
        numbers = {k: float("inf") for k in cell.limits}
    correct, checks = check.verdict(numbers, cell.limits)
    ms = np.asarray(lat) * 1e3
    e2e = {
        "denoise_p50_ms": float(np.percentile(ms, 50)),
        "denoise_p95_ms": float(np.percentile(ms, 95)),
        "setup_s": t_window - t_process,
    }
    if summary is not None:
        window_s = summary.window_s
    readings = Readings(layers, "float32", window_s, summary, [], frames, None)
    return Outcome(correct and failed == 0, len(lat), failed, e2e, readings, checks, peak)
