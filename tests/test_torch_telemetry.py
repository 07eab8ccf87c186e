"""The port's spans (`telemetry.py`) on the CPU: no range without a
profiler; under `torch.profiler.profile` a request of the engine, a train
step, a cached step and a cached `Trainer` epoch record their spans,
nested and in order; the backward's ops fall inside `train.backward`;
`StepProfiler`'s trace holds them; every span opened is in
`telemetry.SPANS`."""

import contextlib
import glob
import json
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fullycnnspeechenhancement_torch import config as tcfg
from fullycnnspeechenhancement_torch import telemetry
from fullycnnspeechenhancement_torch.data import device_cache as T
from fullycnnspeechenhancement_torch.data import write_manifest, write_wav
from fullycnnspeechenhancement_torch.infer import InferenceEngine
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.parallel import make_mesh
from fullycnnspeechenhancement_torch.train.cached_step import Meta, make_cached_train_step
from fullycnnspeechenhancement_torch.train.step import Batch, create_train_state, make_train_step
from fullycnnspeechenhancement_torch.train.trainer import Trainer
from test_torch_cuda import one_cpu_thread_per_worker  # noqa: F401

SR = 8000
PACKAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "fullycnnspeechenhancement_torch")
REQUEST = ("infer.upload", "infer.features", "infer.model", "infer.rebuild", "infer.download")
STEP = ("train.features", "train.forward", "train.backward", "train.optimizer")


def _events(fn):
    """(result of fn, [(name, start_ns, end_ns, thread)] of every host event
    recorded while it ran)."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        out = fn()
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
           for e in p.profiler.kineto_results.events()]
    return out, sorted(evs, key=lambda e: e[1])


def _spans(evs, name=None):
    return [e for e in evs if (e[0] in telemetry.SPANS if name is None else e[0] == name)]


def _inside(e, outer) -> bool:
    return outer[1] <= e[1] and e[2] <= outer[2]


def _assert_children_in_order(evs, parent, names):
    """`names` each open once inside `parent`, one after another."""
    kids = [e for e in _spans(evs) if e is not parent and _inside(e, parent) and e[0] in names]
    assert [k[0] for k in kids] == list(names)
    assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:]))


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eight clean utterances of 0.6-0.95 s (one 64-frame bucket) and two
    noise recordings."""
    root = tmp_path_factory.mktemp("telemetry_corpus")
    rng = np.random.default_rng(5)
    clean, noise = [], []
    for i, sec in enumerate([0.6, 0.95, 0.7, 0.85, 0.65, 0.9, 0.75, 0.8]):
        p = str(root / f"c{i}.wav")
        write_wav(p, _signal(int(sec * SR), i), SR)
        clean.append({"audio_filepath": p, "duration": sec})
    for i, sec in enumerate([2.0, 2.5]):
        p = str(root / f"n{i}.wav")
        write_wav(p, 0.2 * rng.standard_normal(int(sec * SR)).astype(np.float32), SR)
        noise.append({"audio_filepath": p, "duration": sec})
    paths = {k: str(root / f"manifest.{k}") for k in ("clean", "noise")}
    write_manifest(paths["clean"], clean)
    write_manifest(paths["noise"], noise)
    return paths


def _train_config(tmp_path=None, **train):
    extra = {} if tmp_path is None else {
        "checkpoints_path": str(tmp_path / "ck"), "log_dir": str(tmp_path / "log")}
    return tcfg.Config(
        model=tcfg.ModelConfig(net_work="FullyCNN"),
        train=tcfg.TrainConfig(batch_size=2, lr=1e-3, warmup_steps=100, continue_train=False,
                               **extra, **train),
    )


def _loader(corpus):
    c = T.build_device_corpus(corpus["clean"], corpus["noise"], tcfg.DSPConfig())
    loader = T.DeviceCacheLoader(c, tcfg.DSPConfig(), 2, shuffle=True, seed=0)
    loader.activate("cpu")
    return loader


def test_span_without_a_profiler_is_the_shared_null_context():
    """No profiler: every span is the one null context, and entering it
    under a profile started afterwards records no range."""
    cm = telemetry.span("infer.request")
    assert cm is telemetry.span("train.step")
    assert isinstance(cm, contextlib.nullcontext)

    def run():
        with cm:
            return torch.ones(4).sum()

    _, evs = _events(run)
    assert "aten::sum" in {e[0] for e in evs}
    assert not _spans(evs)


@pytest.mark.parametrize("path", ["layerwise", "fused", "time_sharded"])
def test_request_records_its_spans_in_order(path):
    """One tiny `denoise_array`: `infer.request` around upload, features,
    model, rebuild and download, in that order, on the bucketed paths and
    on the time-sharded one."""
    config = tcfg.Config(model=tcfg.ModelConfig(net_work="FullyCNNV2",
                                                fused_inference=path == "fused"))
    mesh = make_mesh(n_data=2, devices=["cpu"] * 2) if path == "time_sharded" else None
    engine = InferenceEngine(config, bucket_seconds=(0.25,), device="cpu", mesh=mesh)
    n = 3000 if path == "time_sharded" else 1500  # past the top bucket, or inside it
    out, evs = _events(lambda: engine.denoise_array(_signal(n)))
    assert out.shape == (n,)
    (request,) = _spans(evs, "infer.request")
    _assert_children_in_order(evs, request, REQUEST)
    assert all(_inside(e, request) for e in _spans(evs))


def test_train_step_records_its_spans_and_the_backward_inside_its_own():
    """One `make_train_step` step: `train.step` around features, forward,
    backward and optimizer, in order; every op of autograd's backward lies
    inside `train.backward`."""
    config = _train_config()
    model = get_model("FullyCNN")
    state = create_train_state(config, model, device="cpu")
    wav = torch.as_tensor(np.stack([_signal(4000, 1), _signal(4000, 2)]))
    batch = Batch(wav, 0.5 * wav, torch.tensor([4000, 3500], dtype=torch.int32))
    step = make_train_step(config, model)
    _, evs = _events(lambda: step(state, batch))
    (outer,) = _spans(evs, "train.step")
    _assert_children_in_order(evs, outer, STEP)
    (backward,) = _spans(evs, "train.backward")
    grads = [e for e in evs if "Backward" in e[0]]
    assert grads and all(_inside(e, backward) for e in grads)


def test_cached_step_records_materialize_before_the_step(corpus):
    """One cached step: `train.materialize` (the batch rebuilt from the
    cache), then `train.step` with its four parts."""
    config = _train_config()
    model = get_model("FullyCNN")
    loader = _loader(corpus)
    b = next(iter(loader))
    step = make_cached_train_step(make_train_step(config, model), loader.pad_len(b.bucket_frames), False)
    state = create_train_state(config, model, device="cpu")
    _, evs = _events(lambda: step(state, *loader.flats(), Meta.from_batch(b, "cpu")))
    assert [e[0] for e in _spans(evs) if e[0] in ("train.materialize", "train.step")] == [
        "train.materialize", "train.step"]
    _assert_children_in_order(evs, _spans(evs, "train.step")[0], STEP)


def test_cached_trainer_epoch_records_its_spans_on_the_dispatch_thread(corpus, tmp_path):
    """A cached `Trainer` epoch of 4 steps in 2-step dispatches under a
    profile: one `train.dispatch` a dispatch, two `train.step` and
    `train.materialize` in each, one `train.feed_wait` a wait (the
    dispatches' and the last, which finds the feed ended) as `data_time`
    counts them, a `train.flush`; all on the thread that started the
    profiler (the feeder's records nothing)."""
    config = _train_config(tmp_path, steps_per_call=2, epochs=1, num_iter_print=100)
    trainer = Trainer(config, device="cpu")
    loader = _loader(corpus)
    try:
        _, evs = _events(lambda: trainer.train(loader))
    finally:
        trainer.ckpt.close()
    count = {n: len(_spans(evs, n)) for n in telemetry.SPANS}
    assert int(trainer.state.step) == 4
    assert count["train.dispatch"] == trainer.data_time.count == 2
    assert count["train.step"] == count["train.materialize"] == 4
    assert count["train.feed_wait"] == 3
    assert count["train.flush"] >= 1
    assert not any(n.startswith("infer.") and c for n, c in count.items())
    dispatches = _spans(evs, "train.dispatch")
    assert all(any(_inside(s, d) for d in dispatches) for s in _spans(evs, "train.step"))
    assert len({e[3] for e in _spans(evs)}) == 1


def test_step_profiler_trace_holds_the_spans(corpus, tmp_path, monkeypatch):
    """The operator's training trace (FCSE_PROFILE_DIR, `StepProfiler`)
    carries the step's spans."""
    monkeypatch.setenv("FCSE_PROFILE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("FCSE_PROFILE_START", "1")
    monkeypatch.setenv("FCSE_PROFILE_STEPS", "2")
    trainer = Trainer(_train_config(tmp_path, epochs=1, num_iter_print=100), device="cpu")
    try:
        trainer.train(_loader(corpus))
    finally:
        trainer.ckpt.close()
    with open(glob.glob(str(tmp_path / "trace" / "*.json"))[0]) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"train.dispatch", "train.step", *STEP} <= names


def test_every_span_opened_is_named_in_spans():
    """The package opens each name of `telemetry.SPANS`, and no other."""
    opened = set()
    for path in glob.glob(os.path.join(PACKAGE, "**", "*.py"), recursive=True):
        with open(path) as f:
            opened.update(re.findall(r'\bspan\("([^"]+)"\)', f.read()))
    assert opened == set(telemetry.SPANS)
    assert len(telemetry.SPANS) == len(set(telemetry.SPANS))
