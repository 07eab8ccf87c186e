"""The traced window (`portbench/devtrace.py`) on event lists built by
hand and on one recorded on the H100: device-side annotations are off
the device's timeline, and otherwise the window, busy time and time by
operation are what the reading before spans gave, bit for bit; each
device operation goes to the spans its launch was made in, innermost
alone and inclusive (through autograd's thread to the dispatch thread's
spans, from a thread with no host op to `untraced_thread`); idle gaps
are named on the dispatch thread; the per-layer readers of `by_span`
read per request and per step, and a span the program adds is read by
a new reader with no other edit; traced tiny runs of both cells count
one span a request and a step.

    python3 -m portbench.tests.test_portbench_devtrace <out.json.gz>

on a card records the event list `RECORDED` names (see `record`)."""

import gzip
import importlib
import json
import os
import sys
import types
from collections import defaultdict

import pytest

from fullycnnspeechenhancement_torch import telemetry
from portbench import devtrace, run, spec
from portbench.drivers import Readings

from .tiny import execute

US = 1000  # ns
MAIN, AUTOGRAD, FEEDER, STREAM = 100, 200, 300, 7
RECORDED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "events_h100.json.gz")
SPAN_METRICS = {
    "denoise_model_ms", "denoise_copy_ms", "denoise_features_ms", "denoise_rebuild_ms", "denoise_launches",
    "step_forward_ms", "step_backward_ms", "step_features_ms", "step_optimizer_ms", "step_materialize_ms",
    "step_launches",
}


def host(name, start, end, thread=MAIN, corr=0, annotation=False):
    return devtrace.Event(name, False, start * US, end * US, corr, thread, annotation)


def device(name, start, end, corr=0, annotation=False):
    return devtrace.Event(name, True, start * US, end * US, corr, STREAM, annotation)


def window(*events, end=1000):
    return [host(devtrace.WINDOW_SPAN, 0, end, annotation=True), *events]


def parent_summarize(events):
    """(window_s, busy_s, by_kernel) as the reading before spans gave
    them from (name, on_device, start, end) events: it took every device
    event not named `portbench.*` for device work."""
    spans = [(s, e) for n, dev, s, e in events if not dev and n == devtrace.WINDOW_SPAN]
    w0, w1 = spans[0]
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
    return (w1 - w0) / 1e9, busy, dict(by_kernel)


def recorded():
    with gzip.open(RECORDED, "rt") as f:
        return [devtrace.Event(*e) for e in json.load(f)]


HAND_BUILT = window(
    host("portbench.request", 10, 900, annotation=True),
    host("infer.request", 12, 890), host("infer.model", 15, 500),
    host("cudaLaunchKernel", 20, 30, corr=1), host("cudaMemcpyAsync", 40, 50, corr=2),
    device("k", 60, 160, corr=1), device("Memcpy HtoD", 150, 400, corr=2),
    device("portbench.request", 60, 890, annotation=True),
    device("late", 950, 1100, corr=9), device("early", -50, 5, corr=10),
)


@pytest.mark.parametrize("events", [HAND_BUILT, "recorded"], ids=["hand_built", "recorded_h100"])
def test_window_busy_and_by_kernel_are_the_parents_bit_for_bit(events):
    """Where the only device-side annotations are the benchmark's own
    (`portbench.*`), as in the program's traces, dropping every
    annotation reads what dropping those by name read."""
    events = recorded() if events == "recorded" else events
    s = devtrace.summarize(events)
    assert (s.window_s, s.busy_s, s.by_kernel) == parent_summarize([(e.name, e.on_device, e.start, e.end)
                                                                     for e in events])
    assert s.dropped and all(n.startswith("portbench.") for n in s.dropped)


def test_device_annotations_of_any_name_add_nothing():
    """A `record_function` range mirrored on the device, program's or
    benchmark's, counts in neither `busy_s` nor `by_kernel`."""
    s = devtrace.summarize(window(
        host("portbench.request", 10, 900, annotation=True),
        host("cudaLaunchKernel", 100, 110, corr=5),
        device("conv_kernel", 200, 300, corr=5),
        device("portbench.request", 200, 800, annotation=True),
        device("infer.model", 200, 800, annotation=True),
    ))
    assert s.busy_s == pytest.approx(100e-6)
    assert s.by_kernel == {"conv_kernel": pytest.approx(100e-6)}
    assert set(s.dropped) == {"portbench.request", "infer.model"}


def test_a_nested_launch_counts_innermost_once_and_inclusive_in_each_span():
    s = devtrace.summarize(window(
        host("train.dispatch", 5, 700), host("train.step", 10, 600), host("train.forward", 20, 100),
        host("cudaLaunchKernel", 30, 40, corr=8), device("fwd_kernel", 45, 60, corr=8),
        host("cudaLaunchKernel", 605, 610, corr=9), device("dispatch_kernel", 620, 630, corr=9),
    ))
    fwd, step, dispatch = (s.by_span[n] for n in ("train.forward", "train.step", "train.dispatch"))
    assert (fwd["device_s"], fwd["device_incl_s"]) == (pytest.approx(15e-6), pytest.approx(15e-6))
    assert (step["device_s"], step["device_incl_s"]) == (0.0, pytest.approx(15e-6))
    assert (dispatch["device_s"], dispatch["device_incl_s"]) == (pytest.approx(10e-6), pytest.approx(25e-6))
    assert (fwd["launches"], step["launches_incl"], dispatch["launches"], dispatch["launches_incl"]) == (1, 1, 1, 2)
    assert sum(v["device_s"] for v in s.by_span.values()) == pytest.approx(sum(s.by_kernel.values()))


def test_backward_launch_on_autograds_thread_goes_to_train_backward():
    s = devtrace.summarize(window(
        host("train.step", 10, 600), host("train.forward", 20, 100), host("train.backward", 100, 500),
        host("autograd::engine::evaluate_function: MulBackward0", 150, 300, thread=AUTOGRAD),
        host("cudaLaunchKernel", 160, 170, thread=AUTOGRAD, corr=7),
        device("mul_kernel", 180, 230, corr=7),
        host("cudaLaunchKernel", 30, 40, corr=8), device("fwd_kernel", 45, 60, corr=8),
    ))
    assert s.by_span["train.backward"]["device_s"] == pytest.approx(50e-6)
    assert s.by_span["train.backward"]["device_incl_s"] == pytest.approx(50e-6)
    assert s.by_span["train.backward"]["launches"] == 1
    assert s.by_span["train.step"]["device_s"] == 0.0
    assert s.by_span["train.step"]["device_incl_s"] == pytest.approx(65e-6)
    assert s.by_span["train.step"]["launches_incl"] == 2
    assert s.by_span["train.forward"]["device_s"] == pytest.approx(15e-6)
    assert s.by_span["train.step"]["count"] == 1
    assert s.by_span["train.step"]["host_s"] == pytest.approx(590e-6)


def test_copy_from_a_thread_with_no_host_op_is_untraced():
    s = devtrace.summarize(window(
        host("train.dispatch", 10, 600),
        host("cudaMemcpyAsync", 100, 120, thread=FEEDER, corr=9),
        device("Memcpy HtoD (Pageable -> Device)", 130, 140, corr=9),
    ))
    assert s.by_span[devtrace.UNTRACED] == {"count": 0, "host_s": 0.0, "device_s": pytest.approx(10e-6),
                                            "device_incl_s": pytest.approx(10e-6), "launches": 1,
                                            "launches_incl": 1}
    assert s.by_span["train.dispatch"]["device_incl_s"] == 0.0


def test_unmatched_operation_and_launch_outside_spans_are_unattributed():
    s = devtrace.summarize(window(
        host("portbench.request", 10, 900, annotation=True),
        host("cudaMemcpyAsync", 20, 30, corr=3), device("Memcpy DtoH", 40, 50, corr=3),
        device("orphan_kernel", 60, 80, corr=4),
        host("cudaLaunchKernel", 990, 995, corr=6), device("after_window", 996, 1200, corr=6),
        host("cudaLaunchKernel", 1100, 1110, corr=11), device("launched_after", 1120, 1130, corr=11),
    ))
    # the one launched inside the window counts whole; the one launched after does not count
    assert s.by_span[devtrace.UNATTRIBUTED]["device_s"] == pytest.approx((10 + 20 + 204) * 1e-6)
    assert s.by_span[devtrace.UNATTRIBUTED]["launches"] == 3
    assert s.totals()["unattributed_share"] == 1.0


def test_idle_gap_is_named_on_the_dispatch_thread():
    """A gap in `train.backward` while the dispatch thread waits in
    `cudaStreamSynchronize` is named by those two, not by the op another
    thread began later; a gap outside the program's spans falls back to the
    benchmark's span."""
    s = devtrace.summarize(window(
        host("portbench.request", 600, 900, annotation=True),
        host("train.dispatch", 10, 500), host("train.step", 12, 480), host("train.backward", 100, 480),
        host("cudaStreamSynchronize", 190, 400, corr=1),
        host("aten::mul", 250, 450, thread=AUTOGRAD),
        device("k1", 0, 200), device("k2", 400, 650), device("k3", 700, 1000),
    ))
    assert s.idle_by_host == {"train.backward/cudaStreamSynchronize": pytest.approx(200e-6),
                              "portbench.request/no op": pytest.approx(50e-6)}
    assert [n for n, _ in s.breakdown()["device_by_span"]] == ["unattributed"]


def _readings(by_span):
    trace = devtrace.Summary(1.0, 0.5, {}, {}, by_span, {})
    return Readings((), "float32", 1.0, trace, [], [], None)


def _span(count=0, device_incl_s=0.0, launches_incl=0):
    return {"count": count, "host_s": 0.0, "device_s": 0.0, "device_incl_s": device_incl_s,
            "launches": 0, "launches_incl": launches_incl}


def _read(name, r):
    return importlib.import_module(f"portbench.metrics.{name}").read(r)


SERVING = {
    "infer.request": _span(4, 0.1, 24), "infer.upload": _span(4, 0.004), "infer.download": _span(4, 0.008),
    "infer.features": _span(4, 0.002), "infer.model": _span(4, 0.080), "infer.rebuild": _span(4, 0.006),
}
TRAINING = {
    "train.dispatch": _span(2, 1.0, 800), "train.step": _span(8, 0.9), "train.materialize": _span(8, 0.004),
    "train.features": _span(8, 0.008), "train.forward": _span(8, 0.4), "train.backward": _span(8, 0.48),
    "train.optimizer": _span(8, 0.002), "train.flush": _span(1, 0.001, 1),
}


@pytest.mark.parametrize("name,by_span,want", [
    ("denoise_model_ms", SERVING, 20.0), ("denoise_copy_ms", SERVING, 3.0), ("denoise_features_ms", SERVING, 0.5),
    ("denoise_rebuild_ms", SERVING, 1.5), ("denoise_launches", SERVING, 6.0),
    ("step_forward_ms", TRAINING, 50.0), ("step_backward_ms", TRAINING, 60.0), ("step_features_ms", TRAINING, 1.0),
    ("step_optimizer_ms", TRAINING, 0.25), ("step_materialize_ms", TRAINING, 0.5), ("step_launches", TRAINING, 100.0),
])
def test_span_metrics_read_per_request_and_per_step(name, by_span, want):
    assert _read(name, _readings(by_span)) == pytest.approx(want)
    unit = "infer.request" if name.startswith("denoise") else "train.step"
    assert _read(name, _readings(dict(by_span, **{unit: _span()}))) is None
    assert _read(name, _readings({})) is None
    assert _read(name, Readings((), "float32", 1.0, None, [], [], None)) is None


def test_every_span_metric_is_in_the_benchmark_and_reads_spans_the_program_opens():
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        per_layer = {m["name"]: m for m in json.load(f)["per_layer"]}
    asked = set()

    class Logged(dict):
        def get(self, key, default=None):
            asked.add(key)
            return super().get(key, default)

    for name in SPAN_METRICS:
        assert per_layer[name]["source"] == "device_trace" and len(per_layer[name]["workloads"]) == 1
        _read(name, _readings(Logged(SERVING if name.startswith("denoise") else TRAINING)))
    assert asked <= set(telemetry.SPANS)


def test_a_span_the_program_adds_is_read_by_a_new_reader_alone(monkeypatch):
    """What a later configuration brings: a span in the program's
    registry and a three-line reader; the window and the result line
    read both with no other edit."""
    monkeypatch.setattr(telemetry, "SPANS", telemetry.SPANS + ("train.residual",))
    reader = types.ModuleType("portbench.metrics.step_residual_ms")
    exec("from portbench.metrics._span import STEP, device_ms\n\n\ndef read(r):\n"
         "    return device_ms(r, STEP, ('train.residual',))\n", reader.__dict__)
    monkeypatch.setitem(sys.modules, reader.__name__, reader)
    s = devtrace.summarize(window(
        host("train.step", 10, 600), host("train.forward", 20, 300), host("train.residual", 50, 100),
        host("cudaLaunchKernel", 60, 70, corr=3), device("add_kernel", 80, 92, corr=3),
        host("cudaLaunchKernel", 150, 160, corr=4), device("conv_kernel", 165, 200, corr=4),
    ))
    assert s.by_span["train.residual"]["device_s"] == pytest.approx(12e-6)
    assert s.by_span["train.forward"]["device_incl_s"] == pytest.approx(47e-6)
    cell = spec.load(run.ROOT, "rced16-train-cached")._replace(
        per_layer=[{"name": "step_residual_ms", "unit": "ms"}, {"name": "step_forward_ms", "unit": "ms"}])
    args = run.parse(["--workload", cell.name, "--seed", "1", "--seconds", "1", "--trace", "1"])
    outcome = types.SimpleNamespace(readings=Readings((), "bfloat16", 1.0, s, [], [], None), correct=True,
                                    attempted=1, failed=0, memory_peak_bytes=0, checks={})
    line = run.result(cell, args, outcome, {"platform": "gpu"})
    assert line["metrics"] == {"step_residual_ms": {"value": pytest.approx(0.012), "unit": "ms"},
                               "step_forward_ms": {"value": pytest.approx(0.047), "unit": "ms"}}


def test_the_recorded_window_puts_its_device_time_down_to_spans():
    """Two short requests through the engine, a conv's forward and
    backward under the step's spans, a copy from a thread of its own
    (`record`): the backward's launches on autograd's thread go to
    `train.backward`, the other thread's copy is untraced, and the spans'
    innermost device time is the operations' own."""
    s = devtrace.summarize(recorded())
    assert s.by_span["infer.request"]["count"] == 2 and s.by_span["train.step"]["count"] == 1
    assert s.by_span["infer.model"]["device_s"] > 0 and s.by_span["train.backward"]["device_s"] > 0
    assert s.by_span["train.backward"]["device_incl_s"] < s.by_span["train.step"]["device_incl_s"]
    assert s.by_span[devtrace.UNTRACED]["launches"] >= 1
    t = s.totals()
    assert t["by_span_s"] == pytest.approx(t["by_kernel_s"], rel=1e-9)
    assert t["unattributed_share"] < 1e-3


@pytest.mark.parametrize("name,unit,counted", [
    ("rced16-denoise-long", "infer.request", "requests"),
    ("rced16-train-cached", "train.step", "steps"),
])
def test_traced_tiny_run_counts_a_span_a_request_and_a_step(name, unit, counted):
    out, line = execute(name, trace=1)
    assert out.correct
    s = out.readings.trace
    n = len(getattr(out.readings, counted))
    assert n > 0 and s.by_span[unit]["count"] == n
    assert "device_by_span" in line["breakdown"]


def record(path: str) -> None:
    """Record `RECORDED` on a card: a traced window holding two 1 s
    requests through the rced16 engine (each in `portbench.request`, as
    the serving window runs them), one conv's forward and backward under
    `train.dispatch` / `train.step` / `train.forward` / `train.backward`,
    and a copy to the card from a thread of its own."""
    import tempfile
    import threading

    import numpy as np
    import torch
    from torch.profiler import record_function

    from fullycnnspeechenhancement_torch.infer import InferenceEngine
    from fullycnnspeechenhancement_torch.telemetry import span
    from portbench.drivers import program_config

    run.cache_dirs(run.ROOT)
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory() as tmp:
        cell = spec.load(run.ROOT, "rced16-denoise-long")
        engine = InferenceEngine(program_config(cell, 1, tmp, {"data": {"audio_save_path": tmp}}), device=dev)
        x = np.random.default_rng(0).standard_normal(8000).astype(np.float32) * 0.1
        engine.denoise_array(x)
        w = torch.randn(8, 1, 3, 3, device=dev, requires_grad=True)
        inp = torch.randn(4, 1, 64, 129, device=dev)
        torch.autograd.grad(torch.nn.functional.conv2d(inp, w).square().sum(), w)
        torch.cuda.synchronize()
        win = devtrace.Window()
        win.start()
        for _ in range(2):
            with record_function("portbench.request"):
                engine.denoise_array(x)
        with span("train.dispatch"), span("train.step"):
            with span("train.forward"):
                loss = torch.nn.functional.conv2d(inp, w).square().sum()
            with span("train.backward"):
                torch.autograd.grad(loss, w)
        side = threading.Thread(target=lambda: torch.ones(1 << 16).to(dev, non_blocking=False))
        side.start()
        side.join()
        win.stop()
        events = devtrace._raw_events(win._prof)
    with gzip.open(path, "wt") as f:
        json.dump([list(e) for e in events], f)
    print(json.dumps({"events": len(events), "totals": devtrace.summarize(events).totals()}))


if __name__ == "__main__":
    record(sys.argv[1])
