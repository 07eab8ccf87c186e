"""The traced window: torch.profiler over the measured window, read from
its raw events.

`busy_s` is the union of the device's own events (kernels, copies,
memsets) inside the window span, `window_s` the span's length.  Each idle
gap between device events is named by what the host was doing when it
began: the innermost host op then running, under the outermost
`portbench.*` span around it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, NamedTuple, Optional, Tuple

import torch

WINDOW_SPAN = "portbench.window"
NAME_CHARS = 160  # of a kernel's name in the breakdown


class Summary(NamedTuple):
    window_s: float
    busy_s: float
    by_kernel: dict  # device event name -> seconds
    idle_by_host: dict  # host activity -> seconds of device idle

    def kernel_s(self, needles) -> float:
        """Seconds of the device events whose names hold any of `needles`."""
        return sum(s for n, s in self.by_kernel.items() if any(x in n for x in needles))

    def breakdown(self, top: int = 10) -> dict:
        def head(d):
            return [[n[:NAME_CHARS], s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": head(self.by_kernel), "idle_gaps": head(self.idle_by_host)}


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


def _raw_events(prof) -> List[Tuple[str, bool, int, int]]:
    """[(name, on_device, start_ns, end_ns)] from the profiler's raw
    (kineto) events."""
    from torch.autograd import DeviceType

    return [
        (e.name(), e.device_type() != DeviceType.CPU, e.start_ns(), e.start_ns() + e.duration_ns())
        for e in prof.profiler.kineto_results.events()
    ]


def summarize(events) -> Optional[Summary]:
    spans = [(s, e) for n, dev, s, e in events if not dev and n == WINDOW_SPAN]
    if not spans:
        return None
    w0, w1 = spans[0]
    # record_function spans show on the device's timeline too: not device work
    dev = sorted((s, e, n) for n, d, s, e in events if d and e > w0 and s < w1 and not n.startswith("portbench."))
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
    host = sorted((s, e, n) for n, d, s, e in events if not d and n != WINDOW_SPAN)
    spans = [h for h in host if h[2].startswith("portbench.")]
    ops = [h for h in host if not h[2].startswith("portbench.")]
    at = (spans, [h[0] for h in spans], ops, [h[0] for h in ops])
    idle: dict = defaultdict(float)
    edge = w0
    for s, e in merged + [[w1, w1]]:
        if s > edge:
            gap = s - edge
            name = SHORT_GAP if gap < SHORT_GAP_NS else _host_at(at, edge)
            idle[name] += gap / 1e9
        edge = max(edge, e)
    return Summary((w1 - w0) / 1e9, busy, dict(by_kernel), dict(idle))


SHORT_GAP_NS = 20_000
SHORT_GAP = "gaps under 20 us"


def _containing(events, starts, t: int, scan: int):
    """The events among the `scan` latest-starting before t that are
    still running at t, innermost first."""
    i = bisect.bisect_right(starts, t)
    return [ev[2] for ev in events[max(0, i - scan) : i][::-1] if ev[1] > t]


def _host_at(at, t: int) -> str:
    """`span/op` at t: the outermost `portbench.*` span and the innermost
    host op running then."""
    spans, span_starts, ops, op_starts = at
    outer = _containing(spans, span_starts, t, 8)
    inner = _containing(ops, op_starts, t, 64)
    return f"{outer[-1] if outer else 'host'}/{inner[0] if inner else 'no op'}"
