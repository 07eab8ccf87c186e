"""The port's Trainer and `cli/train` end to end on the CPU: one epoch on a
small corpus, checkpoints, resume, warm start, serving the checkpoint,
data parallelism started by `cli/train` itself (two gloo ranks), and the
same run as the JAX Trainer's from one npz."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from conftest import make_corpus
from fullycnnspeechenhancement_tpu import config as jcfg
from fullycnnspeechenhancement_tpu.data.dataset import SpeechDataset as JDataset
from fullycnnspeechenhancement_tpu.data.loader import DataLoader as JLoader
from fullycnnspeechenhancement_tpu.train.checkpoint import export_params_npz as j_export
from fullycnnspeechenhancement_tpu.train.trainer import Trainer as JTrainer

from fullycnnspeechenhancement_torch import config as tcfg
from fullycnnspeechenhancement_torch.cli import train as cli
from fullycnnspeechenhancement_torch.data import DataLoader, SpeechDataset
from fullycnnspeechenhancement_torch.infer import InferenceEngine
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.ops import blocked_dw
from fullycnnspeechenhancement_torch.train.step import create_train_state
from fullycnnspeechenhancement_torch.train.trainer import Trainer
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401
from test_torch_train import UPDATE_TOL, assert_training_matches, flat_leaves, global_err, update_err


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("trainer_corpus")))


def _ini(path, corpus, root, epochs=1, steps_per_call=2, extra_train="", extra_model="",
         extra_data=""):
    path.write_text(
        f"[training]\nepochs={epochs}\nbatch_size=2\nlr=0.001\nwarmup_steps=50\n"
        f"checkpoints_path={root}/ckpt\nlog_dir={root}/log\nnum_iter_print=2\n"
        f"steps_per_call={steps_per_call}\n{extra_train}"
        f"[model]\nnet_work=FullyCNNV2\nblocked_compute=True\nblocked_fb=8\ndw_pallas=True\n{extra_model}"
        f"[data]\ntrain_manifest_path={corpus['clean']}\ntrain_noise_manifest={corpus['noise']}\n"
        f"int16_transport=True\n{extra_data}"
    )
    return str(path)


def _scalars(root):
    path = glob.glob(os.path.join(root, "log", "scalars_*.jsonl"))[0]
    return [json.loads(line) for line in open(path)]


def trainer_loader(ini):
    return cli.build_loaders(tcfg.load_ini_config(ini), 1)[0]


def test_cli_trains_resumes_and_serves(tmp_path, corpus):
    """`cli/train --device cpu`: one epoch of the slice's configuration
    (V2, blocked, dW Function, steps_per_call 2, int16 transport), its
    checkpoint, a resume that starts at the next epoch, and the checkpoint
    served by `InferenceEngine`."""
    root = str(tmp_path)
    ini = _ini(tmp_path / "a.cfg", corpus, root)
    before = blocked_dw.launches
    trainer = cli.main(["--cfg", ini, "--device", "cpu", "--num-works", "2"])
    assert blocked_dw.launches == before  # the CPU path launches nothing
    n = len(trainer_loader(ini))
    assert trainer._host_step == n == int(trainer.state.step) > 1
    rows = [r for r in _scalars(root) if "loss" in r]
    assert [r["step"] for r in rows] == list(range(n))
    assert all(np.isfinite(r["loss"]) and r["epoch"] == 0 for r in rows)
    run_dir = os.path.join(root, "ckpt", "RCED_FullyCNNV2")
    assert os.listdir(run_dir) == ["epoch_0.pt"]

    ini2 = _ini(tmp_path / "b.cfg", corpus, root, epochs=2)
    resumed = cli.main(["--cfg", ini2, "--device", "cpu", "--num-works", "2"])
    assert resumed.start_epoch == 1 and int(resumed.state.step) == 2 * n
    assert sorted(os.listdir(run_dir)) == ["epoch_0.pt", "epoch_1.pt"]
    rows = [r for r in _scalars(root) if "loss" in r]
    assert [r["step"] for r in rows] == list(range(2 * n))

    for ckpt in (run_dir, os.path.join(run_dir, "epoch_1.pt")):
        engine = InferenceEngine(tcfg.load_ini_config(ini2), checkpoint=ckpt, device="cpu")
        torch.testing.assert_close(engine.params["encode_3"]["w"],
                                   resumed.state.params["encode_3"]["w"].detach())
        out = engine.denoise_array(np.random.default_rng(0).standard_normal(5000).astype(np.float32))
        assert out.shape == (5000,) and np.all(np.isfinite(out))
    orbax_like = tmp_path / "orbax_run"
    orbax_like.mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        InferenceEngine(tcfg.Config(), checkpoint=str(orbax_like), device="cpu")


def test_trainer_matches_jax_trainer(tmp_path, corpus):
    """Both trainers warm-started from one npz (fresh optimizer, step 0)
    on loaders with the same manifests and seed: per-step logged losses
    within rtol 1e-3, then the Adam moments, the params' change and the
    params after the epoch (test_torch_train.assert_training_matches)."""
    params, bn = numpy_params("FullyCNN", seed=11)
    npz = str(tmp_path / "init.npz")
    j_export(npz, params, bn)
    common = dict(epochs=1, batch_size=2, lr=1e-3, warmup_steps=50, num_iter_print=100,
                  continue_train=False, base_checkpoint_file=npz)
    runs = {}
    for tag, cfg_mod, trainer_cls, ds_cls, loader_cls in (
        ("jax", jcfg, JTrainer, JDataset, JLoader),
        ("torch", tcfg, Trainer, SpeechDataset, DataLoader),
    ):
        root = tmp_path / tag
        cfg = cfg_mod.Config(
            model=cfg_mod.ModelConfig(net_work="FullyCNN"),
            train=cfg_mod.TrainConfig(checkpoints_path=str(root / "ckpt"),
                                      log_dir=str(root / "log"), **common),
        )
        loader = loader_cls(ds_cls(corpus["clean"], corpus["noise"], 8000, seed=2), cfg.dsp, 2,
                            bucket_frames=(256,), num_workers=2, seed=2)
        trainer = trainer_cls(cfg) if tag == "jax" else trainer_cls(cfg, device="cpu")
        trainer.train(loader)
        trainer.ckpt.close()
        runs[tag] = (trainer, [r["loss"] for r in _scalars(str(root)) if "loss" in r])
    (jt, jl), (tt, tl) = runs["jax"], runs["torch"]
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert int(tt.state.opt_state.count) == 3
    assert_training_matches(tt.state, jt.state, flat_leaves(params))


def test_warm_start_from_a_port_checkpoint(tmp_path, corpus):
    root = str(tmp_path / "first")
    trainer = cli.main(["--cfg", _ini(tmp_path / "a.cfg", corpus, root), "--device", "cpu"])
    run_dir = trainer.ckpt.dir
    ini = _ini(tmp_path / "b.cfg", corpus, str(tmp_path / "second"),
               extra_train=f"base_checkpoint_file={run_dir}\n")
    warm = Trainer(tcfg.load_ini_config(ini), device="cpu")
    assert warm.start_epoch == 0 and int(warm.state.step) == 0
    assert int(warm.state.opt_state.count) == 0
    torch.testing.assert_close(warm.state.params["decode_2"]["w"],
                               trainer.state.params["decode_2"]["w"])
    torch.testing.assert_close(warm.state.bn_state["decode_2"]["var"],
                               trainer.state.bn_state["decode_2"]["var"])
    warm.ckpt.close()
    bogus = _ini(tmp_path / "c.cfg", corpus, str(tmp_path / "third"),
                 extra_train=f"base_checkpoint_file={tmp_path}/missing.ckpt\n")
    with pytest.raises(FileNotFoundError):
        Trainer(tcfg.load_ini_config(bogus), device="cpu")


@pytest.mark.parametrize(
    "section,line,item",
    [
        ("training", "data_parallel=2", "Queue 1 item 10"),
    ],
)
def test_unported_options_raise_naming_their_item(tmp_path, corpus, section, line, item, monkeypatch):
    """The one option this test once expected to raise (`data_parallel=2`,
    ROADMAP Queue 1 item 10) is ported: `cli.train --device cpu` starts two
    gloo ranks itself, trains one epoch on this file's corpus, rank 0
    validates (once, while rank 1 waits) and writes the checkpoint, which
    matches the single-process run's: the
    per-step losses at tests/test_train.py's DP tolerance (rtol 1e-5),
    Adam's moments within 1e-3 of their global scale, the BN statistics
    at tests/test_device_cache.py:635's DP-Trainer tolerance (rtol 1e-3,
    atol 1e-5), and the params.  Where a gradient is rounding noise (0.7%
    of the elements here) Adam's sign-like steps move the two runs apart
    by up to 2 lr a step (test_torch_dp.py), so every param lies within
    twice the steps' summed lr of the single run's, and the params'
    change over the epoch within test_torch_train.UPDATE_TOL of its
    norm."""
    monkeypatch.setenv("FCSE_DIST_TIMEOUT_S", "60")  # a hung rank fails this test
    extra = {"extra_train": "", "extra_model": "", "extra_data": ""}
    extra[{"data": "extra_data", "training": "extra_train", "model": "extra_model"}[section]] = line + "\n"
    dp_root, sd_root = str(tmp_path / "dp"), str(tmp_path / "sd")
    # rank 0 validates after the epoch while rank 1 waits at the barrier
    val = f"val_manifest_path={corpus['premixed']}\naudio_save_path={dp_root}/denoise\n"
    extra["extra_data"] += val
    extra["extra_train"] += "valid_every_epochs=1\n"
    ini = _ini(tmp_path / "x.cfg", corpus, dp_root, **extra)
    assert cli.main(["--cfg", ini, "--device", "cpu", "--num-works", "2"]) is None  # ranks ran
    valid = [r for r in _scalars(dp_root) if any(k.startswith("valid_") for k in r)]
    assert len(valid) == 1 and valid[0]["epoch"] == 0, valid
    assert all(np.isfinite(v) for k, v in valid[0].items() if k.startswith("valid_"))
    single = cli.main(["--cfg", _ini(tmp_path / "y.cfg", corpus, sd_root), "--device", "cpu", "--num-works", "2"])
    blobs = [torch.load(os.path.join(r, "ckpt", "RCED_FullyCNNV2", "epoch_0.pt"), weights_only=False)
             for r in (dp_root, sd_root)]
    n = len(trainer_loader(ini))
    assert int(single.state.step) == n > 1
    dp_rows, sd_rows = ([r for r in _scalars(root) if "loss" in r] for root in (dp_root, sd_root))
    assert [r["step"] for r in dp_rows] == list(range(n))
    np.testing.assert_allclose([r["loss"] for r in dp_rows], [r["loss"] for r in sd_rows], rtol=1e-5)
    dp, sd = blobs
    for m in ("mu", "nu"):
        err = global_err(flat_leaves(dp["opt_state"][m], port=True), flat_leaves(sd["opt_state"][m], port=True))
        assert err < 1e-3, f"Adam {m}: {err:.3e} of its global scale"
    for name, d in sd["bn_state"].items():
        for k, v in d.items():
            torch.testing.assert_close(dp["bn_state"][name][k], v, rtol=1e-3, atol=1e-5)
    drift = 2 * sum(r["lr"] for r in sd_rows)
    for name, d in sd["params"].items():
        for k, v in d.items():
            assert float((dp["params"][name][k] - v).abs().max()) <= drift, f"{name}/{k}"
    p0 = flat_leaves(create_train_state(tcfg.load_ini_config(ini), get_model("FullyCNNV2"), device="cpu").params,
                     port=True)
    assert update_err(flat_leaves(dp["params"], port=True), flat_leaves(sd["params"], port=True), p0) < UPDATE_TOL


def test_trainer_defaults_to_cuda(tmp_path, corpus):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    ini = _ini(tmp_path / "x.cfg", corpus, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--cfg", ini])


def test_a_failing_loader_stops_the_epoch_and_tears_down(tmp_path, corpus):
    ini = _ini(tmp_path / "x.cfg", corpus, str(tmp_path), steps_per_call=1)
    trainer = Trainer(tcfg.load_ini_config(ini), device="cpu")
    real = trainer_loader(ini)

    class Broken:
        def __len__(self):
            return len(real)

        def set_epoch(self, epoch):
            real.set_epoch(epoch)

        def __iter__(self):
            it = iter(real)
            yield next(it)
            raise OSError("disk went away")

    with pytest.raises(OSError, match="disk went away"):
        trainer.train(Broken())
    assert trainer._host_step == 1
    assert not os.path.exists(os.path.join(trainer.ckpt.dir, "epoch_0.pt"))
    trainer.ckpt.close()
