"""The harness: it refuses to run without a card, loads no JAX, and
decides `correct` from the timed path: a sound run passes, and each
fault a cell can have, planted underneath, fails it."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import run

from .tiny import execute

TRAIN = ["rced16-train-cached"]
SERVE = ["rced16-denoise-long"]


def test_forbidden_names_are_whole_top_level_names():
    loaded = {"fullycnnspeechenhancement_torch", "fullycnnspeechenhancement_torch.ops.build",
              "jaxtyping", "flaxen.x", "portbench.run", "fullycnnspeechenhancement_tpux"}
    assert run.forbidden_loaded(loaded) == []
    loaded |= {"jax.numpy", "fullycnnspeechenhancement_tpu.models", "flax", "jaxlib.xla_client"}
    assert run.forbidden_loaded(loaded) == ["flax", "fullycnnspeechenhancement_tpu", "jax", "jaxlib"]


def test_without_a_card_it_fails_and_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = list(sys.path)
    try:
        rc = run.main(["--workload", "rced16-denoise-long", "--seed", "1", "--seconds", "1"])
    finally:
        sys.path[:] = path
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    assert "needs 1 CUDA card" in out.err


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch; sys.path.insert(0, 'portbench'); sys.path.insert(0, '.')\n"
        "from portbench.tests.tiny import execute\n"
        "from portbench import run\n"
        "out, line = execute('rced16-denoise-long')\n"
        "print(run.forbidden_loaded(), line['correct'])\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_sound_run_is_correct_and_its_line_is_whole(name):
    out, line = execute(name)
    assert out.correct, line["checks"]
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = {"setup_s"} | ({"train_audio_s_per_s"} if name in TRAIN else {"denoise_p50_ms", "denoise_p95_ms"})
    assert set(line["metrics"]) == e2e
    json.dumps(line, allow_nan=False)


def test_a_traced_run_reads_its_layers():
    out, line = execute("rced16-train-cached", trace=1)
    assert out.correct
    assert set(line["metrics"]) >= {"train_idle_share", "feeder_wait_ms", "train_mfu"}
    # the CPU runs the dW kernel's plain version: nothing to read, so no share
    assert "blocked_dw_roofline" not in line["metrics"]
    assert 0 < line["device"]["window_s"] and list(line)[-2:] == ["breakdown", "checks"]


def _broken_step(monkeypatch, fault):
    import fullycnnspeechenhancement_torch.train.trainer as trainer

    real = trainer.make_train_step

    def make(config, model, dp=None):
        step = real(config, model, dp)

        def broken(state, batch):
            return fault(step, state, batch)

        return broken

    monkeypatch.setattr(trainer, "make_train_step", make)


def _unchanged(step, state, batch):
    """The step runs, and hands back the state it was given."""
    leaves = [v for d in (state.params, state.opt_state.mu, state.opt_state.nu) for p in d.values() for v in p.values()]
    saved = [v.detach().clone() for v in leaves]
    _, metrics = step(state, batch)
    with torch.no_grad():
        for v, s in zip(leaves, saved):
            v.copy_(s)
    return state, metrics


def _half_batch(step, state, batch):
    """Half of the batch left out, the mean taken over the rest."""
    h = batch.lengths.shape[0] // 2
    return step(state, type(batch)(*(None if x is None else torch.cat([x[:h], x[:h]]) for x in batch)))


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch], ids=["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(monkeypatch, name, fault):
    _broken_step(monkeypatch, fault)
    out, line = execute(name)
    assert not out.correct, line["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_wrong_weight_gradient_is_not_correct(monkeypatch, name):
    """The dW kernel's result negated: the parameters still move by Adam's
    first steps' size, so only the gradient's comparison can see it."""
    import fullycnnspeechenhancement_torch.ops.blocked_dw as blocked_dw

    real = blocked_dw.blocked_dw
    monkeypatch.setattr(blocked_dw, "blocked_dw", lambda *a: -real(*a))
    out, line = execute(name)
    assert not out.correct, line["checks"]
    assert line["checks"]["grad_err"]["value"] > line["checks"]["grad_err"]["limit"]


@pytest.mark.parametrize("name", SERVE)
def test_an_altered_answer_is_not_correct(monkeypatch, name):
    from fullycnnspeechenhancement_torch.dsp.rebuild import WaveformRebuilder

    real = WaveformRebuilder.__call__
    monkeypatch.setattr(WaveformRebuilder, "__call__", lambda self, *a: real(self, *a) * 1.01)
    out, line = execute(name)
    assert not out.correct, line["checks"]


def _float32_numbers(monkeypatch, seed: int) -> dict:
    """The training numbers of a float32 CR-CED run of the small training
    cell against its float64 reference: the sound run's, the TF32
    control's (the reference one precision below, put in the program's
    place), and those of a state left unchanged and a negated dW planted
    in the program."""
    import tempfile

    import fullycnnspeechenhancement_torch.ops.blocked_dw as blocked_dw
    from portbench import calibrate, check
    from portbench.drivers import train
    from portbench.reference.specs import MODELS

    from .tiny import FLOAT32_V3, cell

    c = cell(TRAIN[0], FLOAT32_V3)
    ini, cpu = c.config["ini"], torch.device("cpu")
    layers = MODELS[ini["model"]["net_work"]]

    def program():
        with tempfile.TemporaryDirectory() as tmp:
            pacer, corpus, _ = train.train_program(c, seed, 0.0, False, cpu, tmp, check_only=True)
        return pacer, corpus

    pacer, corpus = program()
    p0, bn0, ref = check.training_reference(layers, seed, ini, corpus, pacer.check_batches, cpu)
    assert ref.params["decode_final"]["w"].dtype == torch.float64
    out = {"sound": check.train_numbers(pacer.program(), p0, bn0, ref)}
    bits = check.CONTROL_BITS[ini["model"]["compute_dtype"]]
    control = check.training_reference(layers, seed, ini, corpus, pacer.check_batches, cpu, bits, bits)
    out["tf32_control"] = check.train_numbers(calibrate.as_program(*control), p0, bn0, ref)
    with monkeypatch.context() as m:
        _broken_step(m, _unchanged)
        out["state_unchanged"] = check.train_numbers(program()[0].program(), p0, bn0, ref)
    with monkeypatch.context() as m:
        real = blocked_dw.blocked_dw
        m.setattr(blocked_dw, "blocked_dw", lambda *a: -real(*a))
        out["negated_dw"] = check.train_numbers(program()[0].program(), p0, bn0, ref)
    return out


# The faults each number reads at least 3x the sound run's (PERF.md §6):
# change_gap, a gap of norms, reads a negated dW as sound (Adam's first
# steps move each weight by about the learning rate whatever the sign)
# and the control within 2x.
SEPARATES = {
    "grad_err": ("tf32_control", "state_unchanged", "negated_dw"),
    "bn_err": ("tf32_control", "state_unchanged", "negated_dw"),
    "change_gap": ("state_unchanged",),
}


def test_a_float32_training_configuration_is_held_to_float64(monkeypatch, capsys):
    """`check.training_reference` takes a float32 configuration (here
    CR-CED on the training cell's path) in float64, and the sound run's
    numbers sit at least 3x under those of the TF32 control and of the
    planted faults that SEPARATES names."""
    out = _float32_numbers(monkeypatch, 2**31 + 41)
    with capsys.disabled():
        print(json.dumps(out))
    for number, faults in SEPARATES.items():
        for fault in faults:
            assert out[fault][number] >= 3 * out["sound"][number], (number, fault, out)
