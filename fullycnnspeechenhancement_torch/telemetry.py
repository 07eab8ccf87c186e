"""Spans: named ranges of the program on torch.profiler's timeline.

`span(name)` opens a range that any running torch profiler records (the
Trainer's `StepProfiler`, a benchmark's traced window, or a caller's own
`torch.profiler.profile`), on the profiler's clock, so a span's start
and end sit on the same timeline as the kernels, copies and memsets the
card ran.  With no profiler running on the calling thread it costs one
flag check and returns a shared null context.  There is no switch: the
profiler is the switch.

The range is a plain function-scope record (`_RecordFunctionFast`), not
a user annotation (`record_function`): kineto mirrors a user annotation
onto the device's timeline as an event that spans every kernel launched
inside it, and a reader that takes device events for device work would
then count the idle gaps inside a request or step as busy.  Device time
is put down to a span through each operation's launch (its correlation
id) and the span open on the launching thread at that time.

Only the thread that started the profiler, and threads autograd starts
from it, record: a span opened on the Trainer's feeder thread would
never show, so there is none.
"""

from __future__ import annotations

import contextlib

import torch

# Every span the program opens, by layer.
SPANS = (
    # InferenceEngine.denoise_array: the whole call; the input's copy to
    # the device; analysis; the model; rebuild; the copy back to the host
    # (which holds the wait for the device).
    "infer.request",
    "infer.upload",
    "infer.features",
    "infer.model",
    "infer.rebuild",
    "infer.download",
    # The Trainer's dispatch thread: a dispatch of k steps, its batch
    # rebuilt from the device cache, one optimizer step and its parts,
    # the wait for the feeder's next item, the metrics' copy to the host.
    "train.dispatch",
    "train.materialize",
    "train.step",
    "train.features",
    "train.forward",
    "train.backward",
    "train.optimizer",
    "train.feed_wait",
    "train.flush",
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: `name`'s range if a profiler records this
    thread, else the shared null context."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF
