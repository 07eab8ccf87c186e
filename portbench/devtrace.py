"""The traced window: torch.profiler over the measured window, read from
its raw events.

`busy_s` is the union of the device's own operations (kernels, copies,
memsets) inside the window span, `window_s` the span's length.  A user
annotation (`record_function`) is no device work, whatever its name:
kineto mirrors each onto the device's timeline as an event that spans
every operation launched inside it, and those events are kept apart in
`dropped`.

`by_span` puts device time down to the program's spans
(`fullycnnspeechenhancement_torch.telemetry.SPANS`, read when a window
is summarized, so a span the program adds is read with no edit here).
Each device operation goes through its correlation id to the runtime
call that launched it, and from the launch's thread and time to the
spans open there:

  * on the dispatch thread (the one that opened the window), the spans
    open on it at the launch;
  * on another thread the profiler records host ops for (autograd's
    worker), the spans open on it, then the dispatch thread's spans open
    at that time (so the backward's launches fall under `train.backward`);
  * on a thread with no recorded host op (the Trainer's feeder, loader
    threads) `untraced_thread`; with no matched launch, or a launch
    outside every span, `unattributed`.

`device_s` and `launches` go to the innermost of those spans alone, so
they add up to the device time and operations of the window;
`device_incl_s` and `launches_incl` go to every one of them, so that a
span nested inside another later does not lower the outer one's.  An
operation counts whole where its launch is inside the window.

Each idle gap between device operations is named `span/op` on the
dispatch thread: its innermost program span when the gap began (else
the outermost `portbench.*` span around it, else `host`), and the
innermost other host op running then.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, NamedTuple, Optional

import torch

from fullycnnspeechenhancement_torch import telemetry

WINDOW_SPAN = "portbench.window"
NAME_CHARS = 160  # of a kernel's name in the breakdown
UNTRACED = "untraced_thread"
UNATTRIBUTED = "unattributed"
RUNTIME_PREFIX = "cu"  # CUDA runtime and driver calls: cudaLaunchKernel, cuLaunchKernel, ...
SHORT_GAP_NS = 20_000
SHORT_GAP = "gaps under 20 us"


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
    by_kernel: dict  # device operation name -> seconds
    idle_by_host: dict  # `span/op` on the dispatch thread -> seconds of device idle
    by_span: dict  # span -> {"count", "host_s", "device_s", "device_incl_s", "launches", "launches_incl"}
    dropped: dict  # device-side annotation -> seconds, kept off the device's timeline

    def kernel_s(self, needles) -> float:
        """Seconds of the device operations whose names hold any of `needles`."""
        return sum(s for n, s in self.by_kernel.items() if any(x in n for x in needles))

    def totals(self) -> dict:
        """Device seconds by span and by operation (equal where every
        operation was read once), and the shares of the first that no
        span or no traced thread took."""
        spanned = sum(v["device_s"] for v in self.by_span.values())
        share = {k: self.by_span.get(k, {}).get("device_s", 0.0) / spanned if spanned else None
                 for k in (UNATTRIBUTED, UNTRACED)}
        return {"by_span_s": spanned, "by_kernel_s": sum(self.by_kernel.values()), "busy_s": self.busy_s,
                f"{UNATTRIBUTED}_share": share[UNATTRIBUTED], f"{UNTRACED}_share": share[UNTRACED]}

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[n[:NAME_CHARS], s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": head(self.by_kernel), "idle_gaps": head(self.idle_by_host),
                "device_by_span": head({n: v["device_s"] for n, v in self.by_span.items() if v["device_s"] > 0})}


class Window:
    """Profile the window: `start()` where it opens, `stop()` where it
    closes (they may sit in different frames of one thread)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._span = record_function(WINDOW_SPAN)

    def start(self) -> None:
        self._prof.start()
        self._span.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.stop()

    def summary(self) -> Optional[Summary]:
        return summarize(_raw_events(self._prof))


def _raw_events(prof) -> List[Event]:
    """The profiler's raw (kineto) events."""
    from torch.autograd import DeviceType

    return [
        Event(e.name(), e.device_type() != DeviceType.CPU, e.start_ns(), e.start_ns() + e.duration_ns(),
              e.correlation_id(), e.device_resource_id(), e.is_user_annotation())
        for e in prof.profiler.kineto_results.events()
    ]


class _Nest:
    """Properly nested intervals of one thread: those open at t."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.events]
        self.parent, stack = [], []
        for i, e in enumerate(self.events):
            while stack and self.events[stack[-1]].end <= e.start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def open_at(self, t: int) -> list:
        """Names of the intervals open at t, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.events[i].end <= t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.events[i].name)
            i = self.parent[i]
        return out


def summarize(events: List[Event]) -> Optional[Summary]:
    host = [e for e in events if not e.on_device]
    window = [e for e in host if e.name == WINDOW_SPAN]
    if not window:
        return None
    w0, w1, main = window[0].start, window[0].end, window[0].thread
    dropped: dict = defaultdict(float)
    for e in events:
        if e.on_device and e.annotation and e.end > w0 and e.start < w1:
            dropped[e.name] += (e.end - e.start) / 1e9
    dev = sorted((e.start, e.end, e.name) for e in events
                 if e.on_device and not e.annotation and e.end > w0 and e.start < w1)
    by_kernel: dict = defaultdict(float)
    merged = []
    for s, e, n in dev:
        by_kernel[n] += (e - s) / 1e9
        s, e = max(s, w0), min(e, w1)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) / 1e9

    spans_of = set(telemetry.SPANS)
    launches = {e.correlation: e for e in host if e.name.startswith(RUNTIME_PREFIX)}
    ops = [e for e in host if not e.name.startswith(RUNTIME_PREFIX)]
    recorded = {e.thread for e in ops}
    spans = defaultdict(list)
    for e in ops:
        if e.name in spans_of:
            spans[e.thread].append(e)
    nests = {t: _Nest(s) for t, s in spans.items()}
    none = _Nest([])

    def open_at(thread: int, t: int) -> list:
        if thread not in recorded:
            return [UNTRACED]
        names = nests.get(thread, none).open_at(t)
        if thread != main:
            names += nests.get(main, none).open_at(t)
        return list(dict.fromkeys(names)) or [UNATTRIBUTED]

    by_span = defaultdict(lambda: {"count": 0, "host_s": 0.0, "device_s": 0.0, "device_incl_s": 0.0,
                                   "launches": 0, "launches_incl": 0})
    for e in ops:
        if e.name in spans_of and w0 <= e.end <= w1:
            by_span[e.name]["count"] += 1
            by_span[e.name]["host_s"] += (e.end - e.start) / 1e9
    for e in events:
        if not e.on_device or e.annotation:
            continue
        launch = launches.get(e.correlation)
        if launch is None:
            if not (e.end > w0 and e.start < w1):
                continue
            names = [UNATTRIBUTED]
        elif not w0 <= launch.start <= w1:
            continue
        else:
            names = open_at(launch.thread, launch.start)
        took = (e.end - e.start) / 1e9
        by_span[names[0]]["device_s"] += took
        by_span[names[0]]["launches"] += 1
        for name in names:
            by_span[name]["device_incl_s"] += took
            by_span[name]["launches_incl"] += 1

    main_ops = [e for e in host if e.thread == main]
    outer = sorted((e.start, e.end, e.name) for e in main_ops
                   if e.name.startswith("portbench.") and e.name != WINDOW_SPAN)
    other = sorted((e.start, e.end, e.name) for e in main_ops
                   if e.name not in spans_of and not e.name.startswith("portbench."))
    outer_at = (outer, [x[0] for x in outer])
    other_at = (other, [x[0] for x in other])
    nest = nests.get(main, none)
    idle: dict = defaultdict(float)
    edge = w0
    for s, e in merged + [[w1, w1]]:
        if s > edge:
            gap = s - edge
            if gap < SHORT_GAP_NS:
                name = SHORT_GAP
            else:
                span = (nest.open_at(edge) or [None])[0]
                if span is None:
                    wrapping = _containing(*outer_at, edge, 8)
                    span = wrapping[-1] if wrapping else "host"
                inner = _containing(*other_at, edge, 64)
                name = f"{span}/{inner[0] if inner else 'no op'}"
            idle[name] += gap / 1e9
        edge = max(edge, e)
    return Summary((w1 - w0) / 1e9, busy, dict(by_kernel), dict(idle), dict(by_span), dict(dropped))


def _containing(events, starts, t: int, scan: int):
    """The events among the `scan` latest-starting before t that are
    still running at t, innermost first."""
    i = bisect.bisect_right(starts, t)
    return [ev[2] for ev in events[max(0, i - scan) : i][::-1] if ev[1] > t]
