"""The window read by the program's spans (`portbench/spans.py`), on
synthetic event lists: device-side annotations are off the device's
timeline, each device operation goes to the span its launch was made in
(through autograd's thread to the dispatch thread's span, from a thread
with no host op to `untraced_thread`), idle gaps are named on the
dispatch thread; traced tiny runs of both cells count one span a request
and a step; every span the benchmark reads is one the program opens."""

import pytest

from fullycnnspeechenhancement_torch.telemetry import SPANS
from portbench import devtrace, spans

from .tiny import execute

US = 1000  # ns
MAIN, AUTOGRAD, FEEDER, STREAM = 100, 200, 300, 7


def host(name, start, end, thread=MAIN, corr=0, annotation=False):
    return spans.Event(name, False, start * US, end * US, corr, thread, annotation)


def device(name, start, end, corr=0, annotation=False):
    return spans.Event(name, True, start * US, end * US, corr, STREAM, annotation)


def window(*events, end=1000):
    return [host(devtrace.WINDOW_SPAN, 0, end, annotation=True), *events]


def test_device_annotations_of_any_name_add_nothing():
    """A `record_function` range mirrored on the device, program's or
    benchmark's, counts in neither `busy_s` nor `by_kernel`."""
    s = spans.summarize(window(
        host("portbench.request", 10, 900, annotation=True),
        host("cudaLaunchKernel", 100, 110, corr=5),
        device("conv_kernel", 200, 300, corr=5),
        device("portbench.request", 200, 800, annotation=True),
        device("infer.model", 200, 800, annotation=True),
    ))
    assert s.busy_s == pytest.approx(100e-6)
    assert s.by_kernel == {"conv_kernel": pytest.approx(100e-6)}
    assert set(s.dropped) == {"portbench.request", "infer.model"}


def test_readings_equal_devtrace_where_no_annotation_is_on_the_device():
    events = window(
        host("train.step", 10, 500), host("cudaLaunchKernel", 20, 30, corr=1),
        host("cudaMemcpyAsync", 40, 50, corr=2), device("k", 60, 160, corr=1),
        device("Memcpy HtoD", 150, 400, corr=2), device("late", 950, 1100, corr=9),
    )
    s = spans.summarize(events)
    d = devtrace.summarize([(e.name, e.on_device, e.start, e.end) for e in events])
    assert (s.window_s, s.busy_s, s.by_kernel) == (d.window_s, d.busy_s, d.by_kernel)


def test_backward_launch_on_autograds_thread_goes_to_train_backward():
    s = spans.summarize(window(
        host("train.step", 10, 600), host("train.forward", 20, 100), host("train.backward", 100, 500),
        host("autograd::engine::evaluate_function: MulBackward0", 150, 300, thread=AUTOGRAD),
        host("cudaLaunchKernel", 160, 170, thread=AUTOGRAD, corr=7),
        device("mul_kernel", 180, 230, corr=7),
        host("cudaLaunchKernel", 30, 40, corr=8), device("fwd_kernel", 45, 60, corr=8),
    ))
    assert s.by_span["train.backward"]["device_s"] == pytest.approx(50e-6)
    assert s.by_span["train.backward"]["launches"] == 1
    assert s.by_span["train.forward"]["device_s"] == pytest.approx(15e-6)
    assert s.by_span["train.step"]["count"] == 1
    assert s.by_span["train.step"]["host_s"] == pytest.approx(590e-6)


def test_copy_from_a_thread_with_no_host_op_is_untraced():
    s = spans.summarize(window(
        host("train.dispatch", 10, 600),
        host("cudaMemcpyAsync", 100, 120, thread=FEEDER, corr=9),
        device("Memcpy HtoD (Pageable -> Device)", 130, 140, corr=9),
    ))
    assert s.by_span[spans.UNTRACED] == {"count": 0, "host_s": 0.0, "device_s": pytest.approx(10e-6),
                                         "launches": 1}
    assert s.by_span["train.dispatch"]["device_s"] == 0.0


def test_unmatched_operation_and_launch_outside_spans_are_unattributed():
    s = spans.summarize(window(
        host("portbench.request", 10, 900, annotation=True),
        host("cudaMemcpyAsync", 20, 30, corr=3), device("Memcpy DtoH", 40, 50, corr=3),
        device("orphan_kernel", 60, 80, corr=4),
        host("cudaLaunchKernel", 990, 995, corr=6), device("after_window", 996, 1200, corr=6),
        host("cudaLaunchKernel", 1100, 1110, corr=11), device("launched_after", 1120, 1130, corr=11),
    ))
    # the one launched inside the window counts whole; the one launched after does not count
    assert s.by_span[spans.UNATTRIBUTED]["device_s"] == pytest.approx((10 + 20 + 204) * 1e-6)
    assert s.by_span[spans.UNATTRIBUTED]["launches"] == 3


def test_idle_gap_is_named_on_the_dispatch_thread():
    """A gap in `train.backward` while the dispatch thread waits in
    `cudaStreamSynchronize` is named by those two, not by the op another
    thread began later; a gap outside the program's spans falls back to the
    benchmark's span."""
    s = spans.summarize(window(
        host("portbench.request", 600, 900, annotation=True),
        host("train.dispatch", 10, 500), host("train.step", 12, 480), host("train.backward", 100, 480),
        host("cudaStreamSynchronize", 190, 400, corr=1),
        host("aten::mul", 250, 450, thread=AUTOGRAD),
        device("k1", 0, 200), device("k2", 400, 650), device("k3", 700, 1000),
    ))
    assert s.idle_by_host == {"train.backward/cudaStreamSynchronize": pytest.approx(200e-6),
                              "portbench.request/no op": pytest.approx(50e-6)}


def test_per_layer_reads_device_ms_per_request_and_step():
    s = spans.Summary(1.0, 0.5, {}, {}, {
        "infer.request": {"count": 4, "host_s": 0.1, "device_s": 0.0, "launches": 0},
        "infer.upload": {"count": 4, "host_s": 0.0, "device_s": 0.004, "launches": 8},
        "infer.download": {"count": 4, "host_s": 0.0, "device_s": 0.008, "launches": 4},
        "infer.model": {"count": 4, "host_s": 0.0, "device_s": 0.080, "launches": 12},
        "train.flush": {"count": 1, "host_s": 0.0, "device_s": 0.001, "launches": 1},
    }, {})
    assert spans.per_layer(s) == pytest.approx({"denoise_copy_ms": 3.0, "denoise_model_ms": 20.0,
                                                "denoise_launches": 6.0})


def test_every_span_the_benchmark_reads_is_opened_by_the_program():
    read = {n for names in (*spans.PER_REQUEST.values(), *spans.PER_STEP.values()) for n in names}
    assert read | set(spans.REQUEST) | set(spans.DISPATCH) <= set(SPANS)


@pytest.mark.parametrize("name,unit,counted", [
    ("rced16-denoise-long", "infer.request", "requests"),
    ("rced16-train-cached", "train.step", "steps"),
])
def test_traced_tiny_run_counts_a_span_a_request_and_a_step(monkeypatch, name, unit, counted):
    monkeypatch.setattr(devtrace, "Window", spans.Window)
    out, line = execute(name, trace=1)
    assert out.correct
    s = out.readings.trace
    assert isinstance(s, spans.Summary)
    n = len(getattr(out.readings, counted))
    assert n > 0 and s.by_span[unit]["count"] == n
    assert "device_by_span" in line["breakdown"]
