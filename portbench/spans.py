"""Device time by the program's spans (`fullycnnspeechenhancement_torch.
telemetry`), read from a traced window's raw events:

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell as `run.py --trace 1` does, with its window read by
`summarize` here, and prints the run's line (whose `breakdown` gains
`device_by_span`) and then one line of `by_span`, the per-layer numbers
that read it (`per_layer`) and the totals they are checked by.

`summarize` reads what `devtrace.summarize` reads, with three changes:

  * every user annotation is off the device's timeline, whatever its
    name (kineto mirrors a `record_function` range onto the device as an
    event that spans every kernel launched inside it; `devtrace` drops
    those named `portbench.*` alone);
  * `by_span`: each device operation (kernel, copy, memset) goes through
    its correlation id to the runtime call that launched it, and from
    there to a span: on the dispatch thread (the one that opened
    `portbench.window`) the innermost program span open at the launch;
    on another thread the profiler records host ops for (autograd's
    worker) the innermost open there, else the dispatch thread's;
    on a thread with no recorded host op (the Trainer's feeder, loader
    threads) `untraced_thread`; with no matched launch, or a launch
    outside every program span, `unattributed`.  An operation counts
    whole where its launch is inside the window;
  * each idle gap is named `span/op` on the dispatch thread alone: its
    innermost program span when the gap began (else the outermost
    `portbench.*` span, else `host`), and its innermost other host op.
"""

from __future__ import annotations

import bisect
import os
import sys
from collections import defaultdict
from typing import List, NamedTuple, Optional

if __name__ == "__main__":  # run as a script: the checkout's root on the path
    sys.path[:] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))] + sys.path[1:]

from fullycnnspeechenhancement_torch.telemetry import SPANS  # noqa: E402
from portbench import devtrace  # noqa: E402

UNTRACED = "untraced_thread"
UNATTRIBUTED = "unattributed"
RUNTIME_PREFIX = "cu"  # CUDA runtime and driver calls: cudaLaunchKernel, cuLaunchKernel, ...

# Device ms per request (`infer.request`) or per step (`train.step`)
# under these spans, and the spans a request's or a step's launches fall
# under.
PER_REQUEST = {
    "denoise_features_ms": ("infer.features",),
    "denoise_model_ms": ("infer.model",),
    "denoise_rebuild_ms": ("infer.rebuild",),
    "denoise_copy_ms": ("infer.upload", "infer.download"),
}
PER_STEP = {
    "step_materialize_ms": ("train.materialize",),
    "step_features_ms": ("train.features",),
    "step_forward_ms": ("train.forward",),
    "step_backward_ms": ("train.backward",),
    "step_optimizer_ms": ("train.optimizer",),
}
REQUEST = ("infer.request", "infer.upload", "infer.features", "infer.model", "infer.rebuild",
           "infer.download")
DISPATCH = ("train.dispatch", "train.materialize", "train.step", "train.features", "train.forward",
            "train.backward", "train.optimizer")


class Event(NamedTuple):
    name: str
    on_device: bool
    start: int  # ns, on the profiler's clock
    end: int
    correlation: int  # CUPTI's: a device operation's and its launch's are equal
    thread: int  # host: the OS thread (kineto's resource id); device: the stream
    annotation: bool  # a user annotation (`record_function`), host or device side


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    by_kernel: dict  # device event name -> seconds
    idle_by_host: dict  # `span/op` on the dispatch thread -> seconds of device idle
    by_span: dict  # span -> {"count", "host_s", "device_s", "launches"}
    dropped: dict  # device-side annotation -> seconds, kept off the device's timeline

    kernel_s = devtrace.Summary.kernel_s

    def breakdown(self, top: int = 10) -> dict:
        out = devtrace.Summary.breakdown(self, top)
        by = sorted(self.by_span.items(), key=lambda kv: -kv[1]["device_s"])[:top]
        out["device_by_span"] = [[n, v["device_s"]] for n, v in by]
        return out


class Window(devtrace.Window):
    """`devtrace.Window`, read by `summarize` here."""

    def summary(self) -> Optional[Summary]:
        return summarize(raw_events(self._prof))


def raw_events(prof) -> List[Event]:
    from torch.autograd import DeviceType

    return [
        Event(e.name(), e.device_type() != DeviceType.CPU, e.start_ns(), e.start_ns() + e.duration_ns(),
              e.correlation_id(), e.device_resource_id(), e.is_user_annotation())
        for e in prof.profiler.kineto_results.events()
    ]


class _Nest:
    """Properly nested intervals of one thread: the innermost open at t."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.events]
        self.parent, stack = [], []
        for i, e in enumerate(self.events):
            while stack and self.events[stack[-1]].end <= e.start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.events[i].end <= t:
            i = self.parent[i]
        return self.events[i].name if i >= 0 else None


def summarize(events: List[Event]) -> Optional[Summary]:
    host = [e for e in events if not e.on_device]
    window = [e for e in host if e.name == devtrace.WINDOW_SPAN]
    if not window:
        return None
    w0, w1, main = window[0].start, window[0].end, window[0].thread
    dropped: dict = defaultdict(float)
    for e in events:
        if e.on_device and e.annotation and e.end > w0 and e.start < w1:
            dropped[e.name] += (e.end - e.start) / 1e9
    base = devtrace.summarize([(e.name, e.on_device, e.start, e.end)
                               for e in events if not (e.on_device and e.annotation)])

    launches = {e.correlation: e for e in host if e.name.startswith(RUNTIME_PREFIX)}
    ops = [e for e in host if not e.name.startswith(RUNTIME_PREFIX)]
    recorded = {e.thread for e in ops}
    spans = defaultdict(list)
    for e in ops:
        if e.name in SPANS:
            spans[e.thread].append(e)
    nests = {t: _Nest(s) for t, s in spans.items()}
    none = _Nest([])

    def span_at(thread: int, t: int) -> str:
        if thread not in recorded:
            return UNTRACED
        name = nests.get(thread, none).innermost(t)
        if name is None and thread != main:
            name = nests.get(main, none).innermost(t)
        return name or UNATTRIBUTED

    by_span = defaultdict(lambda: {"count": 0, "host_s": 0.0, "device_s": 0.0, "launches": 0})
    for e in ops:
        if e.name in SPANS and w0 <= e.end <= w1:
            by_span[e.name]["count"] += 1
            by_span[e.name]["host_s"] += (e.end - e.start) / 1e9
    for e in events:
        if not e.on_device or e.annotation:
            continue
        launch = launches.get(e.correlation)
        if launch is None:
            if not (e.end > w0 and e.start < w1):
                continue
            name = UNATTRIBUTED
        elif not w0 <= launch.start <= w1:
            continue
        else:
            name = span_at(launch.thread, launch.start)
        by_span[name]["device_s"] += (e.end - e.start) / 1e9
        by_span[name]["launches"] += 1
    idle = _idle_by_span(events, w0, w1, main, nests.get(main, none),
                         [e for e in ops if e.thread == main] + [e for e in launches.values() if e.thread == main])
    return Summary(base.window_s, base.busy_s, base.by_kernel, idle, dict(by_span), dict(dropped))


def _idle_by_span(events, w0, w1, main, nest, main_ops) -> dict:
    """Device idle gaps (as `devtrace.summarize` finds them) by `span/op`
    on the dispatch thread."""
    dev = sorted((e.start, e.end) for e in events if e.on_device and not e.annotation and e.end > w0 and e.start < w1)
    outer = sorted((e.start, e.end, e.name) for e in events if not e.on_device and e.thread == main
                   and e.name.startswith("portbench.") and e.name != devtrace.WINDOW_SPAN)
    other = sorted((e.start, e.end, e.name) for e in main_ops
                   if e.name not in SPANS and not e.name.startswith("portbench."))
    outer_at = (outer, [x[0] for x in outer])
    other_at = (other, [x[0] for x in other])
    idle: dict = defaultdict(float)
    edge = w0
    for s, e in dev + [(w1, w1)]:
        s = max(s, w0)
        if s > edge:
            gap = s - edge
            if gap < devtrace.SHORT_GAP_NS:
                name = devtrace.SHORT_GAP
            else:
                span = nest.innermost(edge)
                if span is None:
                    wrapping = devtrace._containing(*outer_at, edge, 8)
                    span = wrapping[-1] if wrapping else "host"
                inner = devtrace._containing(*other_at, edge, 64)
                name = f"{span}/{inner[0] if inner else 'no op'}"
            idle[name] += gap / 1e9
        edge = max(edge, min(e, w1))
    return dict(idle)


def per_layer(s: Summary) -> dict:
    """The per-layer numbers that read `by_span`: device ms per request or
    per step under each layer's spans, and device operations launched per
    request or per step; a number whose spans hold no device time is left
    out."""
    out = {}
    for unit, table, under, launch_name in (
        ("infer.request", PER_REQUEST, REQUEST, "denoise_launches"),
        ("train.step", PER_STEP, DISPATCH, "step_launches"),
    ):
        n = s.by_span.get(unit, {}).get("count", 0)
        if not n:
            continue
        for metric, names in table.items():
            dev = sum(s.by_span.get(x, {}).get("device_s", 0.0) for x in names)
            if dev > 0:
                out[metric] = 1e3 * dev / n
        launched = sum(s.by_span.get(x, {}).get("launches", 0) for x in under)
        if launched:
            out[launch_name] = launched / n
    return out


def main(argv=None) -> int:
    import json
    import time

    import torch

    from portbench import run, spec

    t_process = time.perf_counter()
    args = run.parse(list(sys.argv[1:] if argv is None else argv) + ["--trace", "1"])
    run.cache_dirs(run.ROOT)
    cell = spec.load(run.ROOT, args.workload)
    if not torch.cuda.is_available():
        print(f"portbench: {cell.name} needs a CUDA card; no result", file=sys.stderr)
        return 2
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
            "power_limit_w": run.power_limit_w()}
    devtrace.Window = Window  # the drivers build their window by this name
    outcome = run.execute(cell, args, torch.device("cuda", 0), t_process)
    print(json.dumps(run.result(cell, args, outcome, info)), flush=True)
    s = outcome.readings.trace
    if s is None:
        return 1
    spanned = sum(v["device_s"] for v in s.by_span.values()) or float("nan")
    print(json.dumps({
        "by_span": s.by_span, "per_layer": per_layer(s), "dropped": s.dropped,
        "device_s": {"by_span": spanned, "by_kernel": sum(s.by_kernel.values()), "busy": s.busy_s,
                     "unattributed_share": s.by_span.get(UNATTRIBUTED, {}).get("device_s", 0.0) / spanned,
                     "untraced_share": s.by_span.get(UNTRACED, {}).get("device_s", 0.0) / spanned},
        "requests": len(outcome.readings.requests), "steps": len(outcome.readings.steps),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
