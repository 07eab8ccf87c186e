"""Run one cell of BENCHMARK.json on the card this machine holds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's traffic mix names its driver
(`drivers/<driver>.py`), which sets up the program, measures for
`--seconds` and checks what the window produced against the plain
reference (`check.py`).  With `--trace 0` the last line of standard
output is the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics (`metrics/<name>.py`) read from a profiled window (of at most
`TRACE_WINDOW_S`); the numbers
compared and their limits come last on standard error and last in that
line.  Without a card (or with fewer than the cell asks for) it prints
no result and exits 2; with JAX or the JAX package loaded once the
window has closed, it exits 3.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "fullycnnspeechenhancement_tpu")
# A traced run profiles a window of at most this long: reading the
# profile of a longer one would take the run past its time limit.
TRACE_WINDOW_S = 5.0


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among the loaded modules, compared
    whole: `fullycnnspeechenhancement_torch` is not the JAX package."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def cache_dirs(root: str) -> None:
    """Every compiler cache at a fixed path inside the checkout.  The CUDA
    sources build into the program's own `ops/build/` there."""
    cache = os.path.join(root, "portbench", ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    args.seed %= 2**63  # any whole number; numpy and torch take it non-negative
    if args.trace:
        args.seconds = min(args.seconds, TRACE_WINDOW_S)
    return args


def execute(cell, args, device, t_process: float):
    """Run the cell's driver in a scratch directory under TMPDIR."""
    driver = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        return driver.run(cell, args, device, t_process, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        )
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def result(cell, args, outcome, device_info: dict) -> dict:
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            v = importlib.import_module(f"portbench.metrics.{m['name']}").read(outcome.readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    line = {
        "correct": outcome.correct,
        "attempted": outcome.attempted,
        "failed": outcome.failed,
        "metrics": metrics,
        "device": dict(device_info, memory_peak_bytes=outcome.memory_peak_bytes),
    }
    trace = outcome.readings.trace
    if args.trace and trace is not None:
        line["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = trace.breakdown()
    line["checks"] = outcome.checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") not in (here, ROOT)]
    cache_dirs(ROOT)
    import torch

    from portbench import spec

    cell = spec.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s), this machine has {have}; no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
            "power_limit_w": power_limit_w()}
    outcome = execute(cell, args, device, T_PROCESS)
    bad = forbidden_loaded()
    if bad:
        print(f"portbench: {', '.join(bad)} loaded in the benchmark's process; no result", file=sys.stderr)
        return 3
    line = result(cell, args, outcome, info)
    if args.trace and outcome.readings.trace is not None:
        print(f"portbench: trace totals {json.dumps(outcome.readings.trace.totals())}", file=sys.stderr)
    for name, c in outcome.checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
