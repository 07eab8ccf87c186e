"""Run every kernel probe once and time it.

    python -m fullycnnspeechenhancement_torch.probes [--device cuda|cpu] [--reps N] [--seed S]

Like the `benchmarks/micro_pallas_*.py` scripts it prints one line per
probe: its name, the wall time of its first call (which builds and loads
the kernels on the card), and the mean time of a call over `--reps` calls
after a warm-up, from CUDA events on the card and from the host clock on
the CPU, where the plain versions run.  It wants the card by default and
raises without it.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from fullycnnspeechenhancement_torch.device import resolve_device
from fullycnnspeechenhancement_torch.probes import all_probes


def _mean_ms(fn, reps: int, device: torch.device) -> float:
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def run_all(device="cuda", seed: int = 0, reps: int = 20, shapes: Optional[Dict[str, dict]] = None,
            log=print):
    """Run and time every probe on `device`; inputs from numpy (`seed`), one
    draw per probe module, at the scripts' shapes unless `shapes` maps a
    module's short name ("conv", "roll", "min") to `inputs` keywords.
    Returns [(probe, output, first call s, mean ms)]."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    arrays, results = {}, []
    clock = "CUDA events" if dev.type == "cuda" else "host clock, plain versions on the CPU"
    for module, probe in all_probes():
        short = module.__name__.rsplit(".", 1)[-1]
        if short not in arrays:
            arrays[short] = module.inputs(rng, **(shapes or {}).get(short, {}))
        args = [torch.as_tensor(arrays[short][a], device=dev) for a in probe.args]
        t0 = time.perf_counter()
        out = probe(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        first_s = time.perf_counter() - t0
        ms = _mean_ms(lambda: probe(*args), reps, dev)
        log(f"{probe.name} ({probe.row}): build {first_s:.1f}s, run {ms:.4f} ms ({clock}), "
            f"sum {out.double().sum().item():.1f}")
        results.append((probe, out, first_s, ms))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=20, help="timed calls per probe")
    ap.add_argument("--seed", type=int, default=0, help="numpy seed of the inputs")
    args = ap.parse_args(argv)
    run_all(args.device, seed=args.seed, reps=args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
