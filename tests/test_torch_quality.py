"""Does the port learn?  tests/test_quality.py's recipe and margins on the
port, and the port's quality run (`fullycnnspeechenhancement_torch/
quality.py`, the counterpart of `benchmarks/quality_run.py`) at a tiny
size on the CPU.

`test_training_improves_heldout_stoi_and_sdr` is the JAX test ported: its
recipe, data generator, seeds and three margins, on the port's
`make_train_step`, `make_eval_step`, `WaveformRebuilder(mode=
"overlap_add")` and `eval/metrics.{sdr,stoi}`, from the JAX test's own
start (`create_train_state(cfg, V2, PRNGKey(0))`, carried over by
`ckpt.params_from_numpy`).  It also runs the JAX test's code from that
state and holds the port's final loss within 1% of JAX's.  200 steps of
both take minutes on the CPU, so it is marked slow, as the JAX test is:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_quality.py -m slow -s

The recipe's held-out STOI at step 200 depends on the start: over the
seeds of both packages it lies within about 0.1 of the margin, and the
JAX test itself misses its STOI margin from `PRNGKey(2)`
(`tests/torch_quality_recipe.py` prints the spread).  So the start is the
JAX test's, not the port's own init."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_torch import quality
from fullycnnspeechenhancement_torch.eval.metrics import PESQ, sdr, stoi
from test_torch_cuda import one_cpu_thread_per_worker  # noqa: F401
import torch_quality_recipe as recipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_training_improves_heldout_stoi_and_sdr():
    port = recipe.port_run(state=recipe.port_state_from_jax(0))
    ref = recipe.jax_run(0)
    print(f"\nport: {port}\nJAX test's code: {ref}")
    assert port["last_loss"] < 0.75 * port["first_loss"], port
    assert port["sdr"] > port["sdr_mix"] + 0.7, port
    assert port["stoi"] > port["stoi_mix"] + 0.06, port
    assert port["first_loss"] == pytest.approx(ref["first_loss"], rel=1e-3)
    assert port["last_loss"] == pytest.approx(ref["last_loss"], rel=1e-2)


def test_recipe_data_is_the_jax_tests():
    """The slow test's batches and held-out set are tests/test_quality.py's,
    and its generator is the port's `speechlike` at 1.6 s."""
    import test_quality as jq

    mix, clean = recipe.train_batch(9)
    assert mix.shape == clean.shape == (8, jq.N)
    np.testing.assert_array_equal(clean[3], quality.speechlike(1000 + 8 + 3, jq.N, jq.SR))
    np.testing.assert_array_equal(mix[3], jq._mix0db(clean[3], 2000 + 8 + 3))
    pairs = recipe.held_out()
    np.testing.assert_array_equal(pairs[2][0], jq._speechlike(9002))


def test_speechlike_equals_quality_run():
    """`quality.speechlike` is `benchmarks/quality_run.py::speechlike` bit
    for bit (that module imports JAX only inside `main()`)."""
    spec = importlib.util.spec_from_file_location("quality_run", os.path.join(ROOT, "benchmarks", "quality_run.py"))
    qr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qr)
    for seed, n in ((0, 16000), (31, 16000), (10_003, 16000), (7, 1234)):
        a, b = quality.speechlike(seed, n, 8000), qr.speechlike(seed, n, 8000)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_held_out_is_disjoint_from_training():
    """No held-out utterance is a training one, and the held-out noise draws
    are not the noise file's."""
    n = int(quality.SECONDS * quality.SR)
    train_seeds = set(range(quality.TRAIN_SEED, quality.TRAIN_SEED + 32))
    held = {quality.HELD_OUT_SPEECH_SEED + k for k in range(quality.HELD_OUT)}
    noise = {quality.HELD_OUT_NOISE_SEED + k for k in range(quality.HELD_OUT)}
    assert not train_seeds & held and quality.NOISE_SEED not in noise | held | train_seeds
    train = np.stack([quality.speechlike(s, n, quality.SR) for s in sorted(train_seeds)])
    for clean, mix in quality.held_out_set():
        assert clean.shape == mix.shape == (n,)
        corr = train @ clean / (np.linalg.norm(train, axis=1) * np.linalg.norm(clean))
        assert np.abs(corr).max() < 0.1
        # 0 dB: the noise carries the clean signal's energy
        np.testing.assert_allclose(((mix - clean) ** 2).sum(), (clean**2).sum(), rtol=1e-5)


def test_run_quality_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quality.run_quality()


FIXTURE = os.path.join(ROOT, "tests", "fixtures", recipe.QUALITY_INIT_FIXTURE)


def test_quality_init_fixture_is_the_jax_trainers_init(tmp_path):
    """chip_smoke.py's phase 23 starts from this fixture: the JAX Trainer's
    own init of V2 (PRNGKey(0)), the start of the v5e's quality runs, as
    `write_init_npz` writes it now."""
    want = np.load(recipe.write_init_npz("jax", str(tmp_path / "init.npz")))
    got = np.load(FIXTURE)
    assert sorted(got.files) == sorted(want.files) and len(got.files) == 92
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_scores(params, bn_state):
    """The held-out set's scores through the JAX package's eval step,
    overlap-add rebuild and metrics."""
    import jax.numpy as jnp

    from fullycnnspeechenhancement_tpu.config import Config, ModelConfig
    from fullycnnspeechenhancement_tpu.dsp import WaveformRebuilder
    from fullycnnspeechenhancement_tpu.eval import metrics as jm
    from fullycnnspeechenhancement_tpu.models import get_model
    from fullycnnspeechenhancement_tpu.train.step import make_eval_step

    cfg = Config(model=ModelConfig(net_work="FullyCNNV2", blocked_compute=True))
    eval_step = make_eval_step(cfg, get_model("FullyCNNV2"), is_training=False)
    reb = WaveformRebuilder(cfg.dsp, mode="overlap_add")
    pesq = jm.PESQ(sr=8000)
    out = {"stoi": [], "sdr": [], "pesq_native": []}
    for clean, mix in quality.held_out_set():
        n = len(mix)
        pred, pre, pim = eval_step(params, bn_state, jnp.asarray(mix)[None], jnp.asarray([n], jnp.int32))
        den = np.asarray(reb(pred, pre, pim))[0][:n]
        out["stoi"].append(jm.stoi(clean, den, 8000))
        out["sdr"].append(jm.sdr(clean, den))
        out["pesq_native"].append(pesq(clean, den))
    return {k: float(np.mean(v)) for k, v in out.items()}


def test_scoring_matches_jax_from_the_fixture():
    """`quality.Scorer` (the eval step, the overlap-add rebuild, STOI, SDR
    and native PESQ) on the fixture's weights against the JAX package's
    same chain on the same weights: the untrained row of the v5e's table
    (STOI 0.162, SDR -1.15 dB, PESQ 3.22) is this start's."""
    from fullycnnspeechenhancement_tpu.train.checkpoint import import_reference_npz as j_import
    from fullycnnspeechenhancement_tpu.models import get_model as j_get_model

    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.train.checkpoint import import_reference_npz

    cfg = quality.quality_config("unused", 1, "float32", False, False)
    params, bn = import_reference_npz(FIXTURE, get_model("FullyCNNV2"))
    got = quality.Scorer(cfg, torch.device("cpu")).model(params, bn)
    ref = _jax_scores(*j_import(FIXTURE, j_get_model("FullyCNNV2")))
    print(f"\nport {got}\nJAX  {ref}")
    assert got["stoi"] == pytest.approx(ref["stoi"], abs=1e-6)
    assert got["sdr"] == pytest.approx(ref["sdr"], abs=1e-4)
    assert got["pesq_native"] == pytest.approx(ref["pesq_native"], abs=1e-4)
    assert got["stoi"] == pytest.approx(0.162, abs=5e-4) and got["sdr"] == pytest.approx(-1.15, abs=5e-3)


# loader: (compute dtype, fused scoring, start)
RUN_CASES = {"resident": ("bfloat16", False, ""), "rotating": ("float32", True, FIXTURE)}


@pytest.mark.parametrize("loader", sorted(RUN_CASES))
def test_run_quality_on_cpu(loader, tmp_path):
    """`run_quality` at a tiny size (8 utterances, 2 epochs) on the CPU,
    through the Trainer and the device cache: the step count, the shards,
    the mix's scores against direct calls of the metrics, every score
    finite, PESQ native, and the fused scoring path against the unfused
    float32 forward."""
    dtype, fused, init = RUN_CASES[loader]
    r = quality.run_quality(device="cpu", epochs=2, train_utts=8, loader=loader, compute_dtype=dtype,
                            fused_inference=fused, root=str(tmp_path), gate=False, init_npz=init)
    assert r["device"] == "cpu" and r["loader"] == loader and r["compute_dtype"] == dtype
    assert r["steps"] == 2 * r["batches_per_epoch"] > 0
    if loader == "rotating":
        assert r["shards"] >= 2
        assert r["batches_per_epoch"] >= r["shards"]
    else:
        assert r["shards"] == 1 and r["batches_per_epoch"] == 1
    assert r["pesq"] == "p862-native"
    pairs = quality.held_out_set()
    pesq = PESQ(sr=8000)
    direct = {
        "stoi": np.mean([stoi(c, m, 8000) for c, m in pairs]),
        "sdr": np.mean([sdr(c, m) for c, m in pairs]),
        "pesq_native": np.mean([pesq(c, m) for c, m in pairs]),
    }
    assert r["noisy_mix"] == pytest.approx(direct, rel=1e-12)
    for row in ("untrained", "trained"):
        assert set(r[row]) == set(direct) and np.isfinite(list(r[row].values())).all()
    assert np.isfinite([r["first_loss"], r["last_loss"]]).all()
    assert set(r["margins"]) == set(quality.MARGINS)
    if fused:
        assert r["fused_max_rel_err"] < 1e-4
    else:
        assert "fused_max_rel_err" not in r
    if init:
        # the warm start: the untrained model is the fixture's
        from fullycnnspeechenhancement_torch.models import get_model
        from fullycnnspeechenhancement_torch.train.checkpoint import import_reference_npz

        cfg = quality.quality_config(str(tmp_path), 1, "float32", False, False)
        want = quality.Scorer(cfg, torch.device("cpu")).model(*import_reference_npz(init, get_model("FullyCNNV2")))
        assert r["init"] == init and r["untrained"] == pytest.approx(want, abs=1e-5)
