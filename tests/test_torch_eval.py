"""The port's evaluation path against the JAX package's, on the CPU: the
`Evaluator` in both BN modes and with the fused stack, `cli/test`, and the
Trainer's validation, all from one npz of V2 weights (numpy, seeded, BN
statistics centred so the stack stays live) on one premixed corpus; then
the evaluator's failure handling (a failing utterance, a dead scorer
process, the fallback to threads) and its device default.

The port scores in its fork pool; the JAX evaluator scores in threads, so
no process of the JAX package forks here.  Tolerances: rebuilt waveforms
within 1e-4 * max|ref| (float32 rounding, which the de-emphasis IIR
amplifies about 33x); metric averages within STOI 1e-4, SDR 1e-2 dB and
PESQ 1e-2.  On identical arrays the metrics are equal
(test_torch_metrics.py)."""

import glob
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu import config as jcfg
from fullycnnspeechenhancement_tpu.cli import test as jtest_cli
from fullycnnspeechenhancement_tpu.data.dataset import SpeechDataset as JDataset
from fullycnnspeechenhancement_tpu.data.loader import DataLoader as JLoader
from fullycnnspeechenhancement_tpu.eval import evaluator as jev_mod
from fullycnnspeechenhancement_tpu.models import get_model as jget_model
from fullycnnspeechenhancement_tpu.train.checkpoint import export_params_npz as j_export
from fullycnnspeechenhancement_tpu.train.checkpoint import import_reference_npz as j_import
from fullycnnspeechenhancement_tpu.train.trainer import Trainer as JTrainer

from fullycnnspeechenhancement_torch import config as tcfg
from fullycnnspeechenhancement_torch.cli import test as test_cli
from fullycnnspeechenhancement_torch.cli import train as train_cli
from fullycnnspeechenhancement_torch.data import DataLoader, SpeechDataset, write_manifest, write_wav
from fullycnnspeechenhancement_torch.eval import evaluator as ev_mod
from fullycnnspeechenhancement_torch.eval.evaluator import Evaluator
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.ops import rced_stack
from fullycnnspeechenhancement_torch.train.checkpoint import import_reference_npz
from fullycnnspeechenhancement_torch.train.trainer import Trainer
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401

SR = 8000
NET = "FullyCNNV2"
BUCKETS = (64,)  # every utterance below fits 64 frames: one shape to compile
TOL = {"stoi": 1e-4, "sdr": 1e-2, "pesq": 1e-2}


@pytest.fixture(scope="module", autouse=True)
def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: PESQ's native runtime is built from source")


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    params, bn = numpy_params(NET, seed=5, centred_bn=True)
    path = str(tmp_path_factory.mktemp("w") / "v2.npz")
    j_export(path, params, bn)
    return path


def _utterance(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.5 * t)
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(k * phase) / k for k in range(1, 8))
    return (0.2 * env * voiced + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five premixed utterances of 0.6-1.0 s (so batches of 2 leave one
    tail repeat), a clean manifest over the same files and a noise one."""
    root = tmp_path_factory.mktemp("eval_corpus")
    rng = np.random.default_rng(9)
    premixed, clean, noise = [], [], []
    for i, sec in enumerate([0.6, 0.7, 0.8, 0.9, 1.0]):
        sig = _utterance(int(sec * SR), i)
        c, m = str(root / f"u{i}.wav"), str(root / f"u{i}_in.wav")
        write_wav(c, sig, SR)
        write_wav(m, sig + 0.08 * rng.standard_normal(len(sig)).astype(np.float32), SR)
        premixed.append({"clean_audio_filepath": c, "mix_audio_filepath": m, "duration": sec})
        clean.append({"audio_filepath": c, "duration": sec})
    p = str(root / "noise.wav")
    write_wav(p, 0.2 * rng.standard_normal(2 * SR).astype(np.float32), SR)
    noise.append({"audio_filepath": p, "duration": 2.0})
    paths = {k: str(root / f"m.{k}") for k in ("premixed", "clean", "noise")}
    for k, entries in (("premixed", premixed), ("clean", clean), ("noise", noise)):
        write_manifest(paths[k], entries)
    return paths


def _config(cfg_mod, fused=False, **data):
    return cfg_mod.Config(
        model=cfg_mod.ModelConfig(net_work=NET, fused_inference=fused),
        data=cfg_mod.DataConfig(bucket_frames=BUCKETS, **data),
    )


def _loader(corpus, cfg):
    return DataLoader(SpeechDataset(corpus["premixed"], None, SR), cfg.dsp, 2,
                      bucket_frames=BUCKETS, shuffle=False, num_workers=1)


def _thread_evaluator(cfg, bn_training_mode):
    return jev_mod.Evaluator(cfg, jget_model(NET), bn_training_mode=bn_training_mode,
                             num_workers=2, scoring="thread")


def assert_scores_close(got, ref):
    """Each metric average within TOL; prints the measured differences."""
    assert set(got) == set(ref) and {"stoi", "sdr", "pesq"} <= set(got)
    diffs = {k: abs(got[k] - ref[k]) for k in TOL}
    print("metric |port - JAX|:", {k: f"{d:.3e}" for k, d in diffs.items()})
    for k, tol in TOL.items():
        assert diffs[k] <= tol, f"{k}: port {got[k]} JAX {ref[k]} (|diff| {diffs[k]:.3e} > {tol})"


def _run_both(npz, corpus, cfgs, bn_training_mode):
    """Rebuilt waveforms of every batch and the evaluate() averages of the
    port's evaluator (process scoring) and JAX's (thread scoring)."""
    tcfg_, jcfg_ = cfgs
    params, bn = import_reference_npz(npz, get_model(NET), "cpu")
    jparams, jbn = j_import(npz, jget_model(NET))
    ev = Evaluator(tcfg_, get_model(NET), bn_training_mode=bn_training_mode, num_workers=2, device="cpu")
    jev = _thread_evaluator(jcfg_, bn_training_mode)
    loader = _loader(corpus, tcfg_)
    loader.set_epoch(0)
    worst = 0.0
    try:
        for b in loader:
            got = ev._predict_and_rebuild(params, bn, b.mix_wav, b.lengths)
            ref = np.asarray(jev._fn(jparams, jbn, b.mix_wav, b.lengths))
            assert got.dtype == np.float32 and got.shape == ref.shape == b.mix_wav.shape
            assert np.abs(ref).max() > 1e-3  # the stack is live
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
            worst = max(worst, np.abs(got - ref).max() / np.abs(ref).max())
        print(f"rebuilt waveforms: max |port - JAX| / max|JAX| {worst:.3e}")
        results = ev.evaluate(loader, params, bn)
        jresults = jev.evaluate(loader, jparams, jbn)
    finally:
        ev.close()
        jev.close()
    assert ev.scoring == "process"
    return results, jresults


@pytest.mark.parametrize("bn_training_mode", [False, True], ids=["bn_inference", "bn_batch_stats"])
def test_evaluator_matches_jax(npz, corpus, bn_training_mode):
    results, jresults = _run_both(npz, corpus, (_config(tcfg), _config(jcfg)), bn_training_mode)
    assert_scores_close(results, jresults)
    assert "score_failures" not in results


def test_fused_evaluator_matches_jax_interpret_mode(npz, corpus):
    """`fused_inference=True` with BN in inference mode: the stack kernel's
    plain version here against JAX's Pallas kernel in interpret mode."""
    cfgs = (_config(tcfg, fused=True), _config(jcfg, fused=True))
    before = rced_stack.launches
    results, jresults = _run_both(npz, corpus, cfgs, bn_training_mode=False)
    assert rced_stack.launches == before  # CPU tensors run the plain version
    assert_scores_close(results, jresults)


def _test_ini(path, npz, corpus, root, fused):
    path.write_text(
        f"[testing]\ncheckpoint_filepath={npz}\nbatch_size=2\n"
        f"[model]\nnet_arch=RCED\nnet_work={NET}\nfused_inference={fused}\n"
        f"[training]\nlog_dir={root}/logs\n"
        f"[data]\nsample_rate=8000\nsnr=0\ntest_manifest_path={corpus['clean']}\n"
        f"test_noise_manifest={corpus['noise']}\naudio_save_path={root}/denoise\n"
    )
    return str(path)


def _printed(out):
    line = out.strip().splitlines()[-1]
    return {k: float(v) for k, v in re.findall(r"(\w+)=(-?[\d.]+)", line)}


@pytest.mark.parametrize("fused", [False, True], ids=["layerwise", "fused"])
def test_cli_test_matches_jax_cli(npz, corpus, tmp_path, capsys, monkeypatch, fused):
    """`cli.test --device cpu` on the shipped test config's settings
    (batch 2, snr 0, a noise manifest): the same printed keys as JAX's
    cli.test (its evaluator scoring in threads), values within TOL at the
    printed 4 decimals, and the `_de.wav` triplets written."""

    class ThreadEvaluator(jev_mod.Evaluator):
        def __init__(self, *a, **k):
            super().__init__(*a, scoring="thread", **k)

    monkeypatch.setattr(jev_mod, "Evaluator", ThreadEvaluator)
    jtest_cli.main(["--cfg", _test_ini(tmp_path / "j.cfg", npz, corpus, tmp_path / "jax", fused),
                    "--num-works", "1"])
    ref = _printed(capsys.readouterr().out)
    root = tmp_path / "port"
    results = test_cli.main(["--cfg", _test_ini(tmp_path / "t.cfg", npz, corpus, root, fused),
                             "--num-works", "1", "--device", "cpu"])
    got = _printed(capsys.readouterr().out)
    assert sorted(got) == sorted(ref) == ["pesq", "sdr", "stoi"]
    assert got == {k: round(v, 4) for k, v in results.items()}
    print("printed |port - JAX|:", {k: f"{abs(got[k] - ref[k]):.1e}" for k in TOL})
    for k, tol in TOL.items():
        assert abs(got[k] - ref[k]) <= tol + 1e-4, (k, got[k], ref[k])
    names = sorted(os.path.basename(p) for p in glob.glob(str(root / "denoise" / "*.wav")))
    assert names == sorted(f"u{i}{s}.wav" for i in range(5) for s in ("", "_mix", "_de"))
    assert glob.glob(str(root / "logs" / f"test_RCED_{NET}_*_log.txt"))


def _train_ini(path, corpus, root, extra_train=""):
    path.write_text(
        f"[training]\nepochs=1\nbatch_size=2\nlr=0.001\nwarmup_steps=50\nvalid_every_epochs=1\n"
        f"checkpoints_path={root}/ckpt\nlog_dir={root}/log\nnum_iter_print=10\n{extra_train}"
        f"[model]\nnet_work={NET}\n"
        f"[data]\ntrain_manifest_path={corpus['clean']}\ntrain_noise_manifest={corpus['noise']}\n"
        f"val_manifest_path={corpus['premixed']}\naudio_save_path={root}/denoise\n"
    )
    return str(path)


def test_cli_train_validates_every_epoch(corpus, tmp_path):
    """`cli.train` with a validation manifest: after the epoch, validation
    in the fork pool logs `valid_*` scalars and writes the triplets under
    `audio_save_path/0`, and leaves the BN statistics as training left
    them; the teardown closes the pool."""
    root = tmp_path / "run"
    ini = _train_ini(tmp_path / "t.cfg", corpus, root)
    train_loader, val_loader = train_cli.build_loaders(tcfg.load_ini_config(ini), 1)
    assert val_loader is not None and len(val_loader.dataset) == 5
    trainer = Trainer(tcfg.load_ini_config(ini), device="cpu")
    seen = {}
    real_validate = trainer.validate

    def spy(loader, epoch, log=None):
        seen["bn"] = {n: {k: v.clone() for k, v in s.items()} for n, s in trainer.state.bn_state.items()}
        seen["results"] = real_validate(loader, epoch, log)
        return seen["results"]

    trainer.validate = spy
    trainer.train(train_loader, val_loader)
    trainer.ckpt.close()
    assert trainer.evaluator._pool is None and trainer.evaluator.scoring == "process"
    for n, s in seen["bn"].items():
        for k, v in s.items():
            torch.testing.assert_close(trainer.state.bn_state[n][k], v, rtol=0, atol=0)
    rows = [json.loads(line) for line in open(root / "log" / f"scalars_RCED_{NET}.jsonl")]
    valid = [r for r in rows if "valid_stoi" in r]
    assert len(valid) == 1 and valid[0]["epoch"] == 0
    assert {"valid_stoi", "valid_sdr", "valid_pesq"} <= set(valid[0])
    assert "valid_pesq_proxy" not in valid[0] and "valid_score_failures" not in valid[0]
    assert valid[0]["valid_stoi"] == seen["results"]["stoi"]
    assert len(glob.glob(str(root / "denoise" / "0" / "*_de.wav"))) == 5


def test_trainer_validate_matches_jax_trainer(npz, corpus, tmp_path):
    """Both Trainers warm-started from one npz validate before any step:
    the same scores within TOL, and the port's BN state untouched."""
    ini = _train_ini(tmp_path / "t.cfg", corpus, tmp_path / "port",
                     extra_train=f"base_checkpoint_file={npz}\n")
    cfg = tcfg.load_ini_config(ini)
    jc = jcfg.Config(
        model=jcfg.ModelConfig(net_work=NET),
        train=jcfg.TrainConfig(checkpoints_path=str(tmp_path / "jax" / "ckpt"),
                               log_dir=str(tmp_path / "jax" / "log"), base_checkpoint_file=npz,
                               continue_train=False),
        data=jcfg.DataConfig(audio_save_path=str(tmp_path / "jax" / "denoise"), bucket_frames=BUCKETS),
    )
    trainer = Trainer(cfg, device="cpu")
    before = {n: {k: v.clone() for k, v in s.items()} for n, s in trainer.state.bn_state.items()}
    _, val_loader = train_cli.build_loaders(cfg, 1)
    try:
        results = trainer.validate(val_loader, epoch=0)
    finally:
        trainer.evaluator.close()
        trainer.ckpt.close()
    for n, s in before.items():
        for k, v in s.items():
            assert torch.equal(trainer.state.bn_state[n][k], v)
    jt = JTrainer(jc)
    jt.evaluator = _thread_evaluator(jc, bn_training_mode=True)
    jloader = JLoader(JDataset(corpus["premixed"], None, SR), jc.dsp, 2,
                                 bucket_frames=BUCKETS, shuffle=False, num_workers=1)
    try:
        jresults = jt.validate(jloader, epoch=0)
    finally:
        jt.evaluator.close()
        jt.ckpt.close()
    assert_scores_close(results, jresults)
    assert len(glob.glob(str(tmp_path / "port" / "denoise" / "0" / "*_de.wav"))) == 5


# Module-level, so forked scorers resolve them from their copy of this module.
_REAL_SCORE = ev_mod._score_arrays
_TEST_PID = None


def _failing_score(clean, mix, den, path, save_dir, sr):
    if "u1" in os.path.basename(path):
        raise RuntimeError("synthetic scorer failure")
    return _REAL_SCORE(clean, mix, den, path, save_dir, sr)


def _dying_score(clean, mix, den, path, save_dir, sr):
    """Ends the scorer process on u1, but never the test's own process:
    in the test's process (thread scoring) it raises instead."""
    if "u1" in os.path.basename(path):
        if os.getpid() == _TEST_PID:
            raise RuntimeError("a dying scorer in the test's own process")
        os._exit(13)
    return _REAL_SCORE(clean, mix, den, path, save_dir, sr)


def test_a_failing_utterance_is_skipped_and_counted(npz, corpus, monkeypatch):
    params, bn = import_reference_npz(npz, get_model(NET), "cpu")
    monkeypatch.setattr(ev_mod, "_score_arrays", _failing_score)
    ev = Evaluator(_config(tcfg), get_model(NET), num_workers=2, device="cpu")
    meters = {}
    try:
        results = ev.evaluate(_loader(corpus, _config(tcfg)), params, bn, meters=meters)
        assert results["score_failures"] == 1
        assert meters["stoi"].count == meters["pesq"].count == 4
        # meters passed in persist: a second pass adds to them
        results = ev.evaluate(_loader(corpus, _config(tcfg)), params, bn, meters=meters)
        assert results["score_failures"] == 2 and meters["stoi"].count == 8
    finally:
        ev.close()


def test_a_dead_scorer_is_retried_then_scoring_degrades_to_threads(npz, corpus, monkeypatch):
    """A scorer process that dies breaks the pool: the pass goes on, the
    utterance is retried once on a fresh pool and then counted; the
    Evaluator then scores cleanly; after three breaks it scores in
    threads."""
    monkeypatch.setitem(globals(), "_TEST_PID", os.getpid())
    params, bn = import_reference_npz(npz, get_model(NET), "cpu")
    loader = _loader(corpus, _config(tcfg))
    monkeypatch.setattr(ev_mod, "_score_arrays", _dying_score)
    ev = Evaluator(_config(tcfg), get_model(NET), num_workers=2, device="cpu")
    try:
        results = ev.evaluate(loader, params, bn)
        assert results.get("score_failures", 0) >= 1
        assert "stoi" in results and ev._pool_breaks >= 1
        assert ev.scoring == "process"
        monkeypatch.setattr(ev_mod, "_score_arrays", _REAL_SCORE)
        ev.close()  # drop a pool forked under the dying patch
        clean = ev.evaluate(loader, params, bn, meters={})
        assert "score_failures" not in clean and np.isfinite(clean["stoi"])
        while ev._pool_breaks < 3:
            ev._get_pool()._broken = "simulated worker death"
            ev._get_pool()
        assert ev.scoring == "thread"
        monkeypatch.setattr(ev_mod, "_score_arrays", _dying_score)
        threaded = ev.evaluate(loader, params, bn, meters={})
        assert threaded["score_failures"] == 1 and ev.scoring == "thread"
    finally:
        ev.close()


def test_a_late_future_of_a_replaced_pool_leaves_its_successor(corpus):
    """Futures of a pool that broke may resolve after it was replaced: they
    mark only the pool in use, so one death costs one replacement, not a
    break toward the fallback to threads for every late future."""
    ev = Evaluator(_config(tcfg), get_model(NET), num_workers=1, device="cpu")
    try:
        first = ev._get_pool()
        first._broken = "simulated worker death"
        second = ev._get_pool()
        assert second is not first and ev._pool_breaks == 1
        ev._mark_broken(first)
        assert ev._get_pool() is second and ev._pool_breaks == 1
        ev._mark_broken(second)
        assert ev._get_pool() is not second and ev._pool_breaks == 2
        assert ev.scoring == "process"
    finally:
        ev.close()


def test_evaluator_and_cli_default_to_cuda(npz, corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Evaluator(_config(tcfg), get_model(NET))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_cli.main(["--cfg", _test_ini(tmp_path / "t.cfg", npz, corpus, tmp_path, False)])
