"""The port's cached train step, cached `Trainer` and `cli/train` over the
GPU-resident corpus cache, on the CPU: the cached step against the
host-batch step (the tests/test_device_cache.py:329 pattern) in float32
and bf16, a cached `Trainer` epoch against the host loader's and against
JAX's cached `Trainer`, `cli/train` with the resident and the rotating
cache (the tests/test_engine.py:391 and :422 patterns), and a cached
`Trainer` built from each `work/*/cfg/fully_cnn_train_tpu.cfg`'s
settings."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu import config as jcfg
from fullycnnspeechenhancement_tpu.cli import train as j_cli
from fullycnnspeechenhancement_tpu.train.checkpoint import export_params_npz as j_export
from fullycnnspeechenhancement_tpu.train.trainer import Trainer as JTrainer

from fullycnnspeechenhancement_torch import config as tcfg
from fullycnnspeechenhancement_torch.cli import train as cli
from fullycnnspeechenhancement_torch.data import device_cache as T
from fullycnnspeechenhancement_torch.data import write_manifest, write_wav
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.train.cached_step import (
    Meta,
    make_cached_multi_step,
    make_cached_train_step,
)
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy
from fullycnnspeechenhancement_torch.train.step import Batch, make_train_step, state_from_tensors
from fullycnnspeechenhancement_torch.train.trainer import Trainer
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401
from test_torch_train import assert_training_matches, flat_leaves

SR = 8000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eight clean utterances of 0.6-0.95 s (all in the 64-frame bucket, so
    each trainer compiles few JAX programs), two noise recordings longer
    than any of them, and premixed pairs over the same utterances."""
    root = tmp_path_factory.mktemp("cached_train_corpus")
    rng = np.random.default_rng(4)
    clean, premixed, noise = [], [], []
    for i, sec in enumerate([0.6, 0.95, 0.7, 0.85, 0.65, 0.9, 0.75, 0.8]):
        t = np.arange(int(sec * SR)) / SR
        sig = ((0.55 + 0.45 * np.sin(2 * np.pi * 4 * t)) * 0.4
               * np.sin(2 * np.pi * (250 + 90 * i) * t)).astype(np.float32)
        p, m = str(root / f"c{i}.wav"), str(root / f"m{i}.wav")
        write_wav(p, sig, SR)
        write_wav(m, sig + 0.1 * rng.standard_normal(len(sig)).astype(np.float32), SR)
        clean.append({"audio_filepath": p, "duration": sec})
        premixed.append({"clean_audio_filepath": p, "mix_audio_filepath": m, "duration": sec})
    for i, sec in enumerate([2.0, 2.5]):
        p = str(root / f"n{i}.wav")
        write_wav(p, 0.2 * rng.standard_normal(int(sec * SR)).astype(np.float32), SR)
        noise.append({"audio_filepath": p, "duration": sec})
    paths = {k: str(root / f"manifest.{k}") for k in ("clean", "noise", "premixed")}
    write_manifest(paths["clean"], clean)
    write_manifest(paths["noise"], noise)
    write_manifest(paths["premixed"], premixed)
    return paths


def _config(mod, batch, dtype="float32", steps_per_call=1, **train):
    return mod.Config(
        model=mod.ModelConfig(net_work="FullyCNN", compute_dtype=dtype),
        train=mod.TrainConfig(batch_size=batch, lr=1e-3, warmup_steps=100,
                              steps_per_call=steps_per_call, continue_train=False, **train),
    )


def _state(seed=3):
    return state_from_tensors(*params_from_numpy(*numpy_params("FullyCNN", seed, centred_bn=True)))


def _resident(corpus, batch, **kw):
    c = T.build_device_corpus(corpus["clean"], corpus["noise"], tcfg.DSPConfig(), **kw)
    loader = T.DeviceCacheLoader(c, tcfg.DSPConfig(), batch, shuffle=True, seed=0)
    loader.activate("cpu")
    return loader


def _leaves(state):
    return {(n, k): v.detach() for n, p in state.params.items() for k, v in p.items()}


def test_cached_step_matches_host_batch_step(corpus):
    """One float32 step from the cache equals the same step fed the host
    loader's waveforms (tests/test_device_cache.py's tolerances)."""
    config = _config(tcfg, 3)
    model = get_model("FullyCNN")
    loader = _resident(corpus, 3)
    host = cli.build_loaders(dataclasses.replace(
        config, data=dataclasses.replace(config.data, train_manifest_path=corpus["clean"],
                                         train_noise_manifest=corpus["noise"],
                                         bucket_frames=loader.boundaries)), 1)[0]
    host.sampler.batch_size = 3
    host.set_epoch(0)
    hb, cb = next(iter(host)), next(iter(loader))
    np.testing.assert_array_equal(hb.indices, cb.indices)
    s_host, m_host = make_train_step(config, model)(
        _state(), Batch(torch.as_tensor(hb.mix_wav), torch.as_tensor(hb.clean_wav),
                        torch.as_tensor(hb.lengths)))
    step = make_cached_train_step(make_train_step(config, model), loader.pad_len(cb.bucket_frames),
                                  False)
    s_cache, m_cache = step(_state(), *loader.flats(), Meta.from_batch(cb, "cpu"))
    np.testing.assert_allclose(m_cache["loss"].item(), m_host["loss"].item(), rtol=1e-4)
    # the first kernel, as the JAX test holds it: the biases under
    # training-mode BN have gradients that cancel analytically, and Adam
    # turns their rounding noise into steps of full size
    np.testing.assert_allclose(s_cache.params["encode_1"]["w"].detach().numpy(),
                               s_host.params["encode_1"]["w"].detach().numpy(), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_steps_equal_host_steps_on_the_rebuilt_batch(corpus, dtype):
    """In both compute dtypes the cached step is the host-batch step on the
    batch `materialize_batch` rebuilds, bit for bit, and the K-step
    dispatch is K cached steps: the analysis stays float32 and the model's
    input is cast as train/step.py casts it."""
    config = _config(tcfg, 2, dtype)
    model = get_model("FullyCNN")
    loader = _resident(corpus, 2)
    batches = list(loader)[:2]
    bucket = batches[0].bucket_frames
    assert all(b.bucket_frames == bucket for b in batches)
    L = loader.pad_len(bucket)
    host = make_train_step(config, model)
    single = make_cached_train_step(host, L, False)
    s_cache, s_host = _state(), _state()
    losses = []
    for b in batches:
        mix, clean = T.materialize_batch(*loader.flats(), b, L, False)
        assert mix.dtype == torch.float32
        s_cache, m_cache = single(s_cache, *loader.flats(), Meta.from_batch(b, "cpu"))
        s_host, m_host = host(s_host, Batch(mix, clean, torch.as_tensor(b.lengths)))
        assert m_cache["loss"].item() == m_host["loss"].item()
        losses.append(m_cache["loss"].item())
    for key, ref in _leaves(s_host).items():
        assert torch.equal(_leaves(s_cache)[key], ref), key
    s_multi, packed = make_cached_multi_step(host, L, False)(
        _state(), *loader.flats(), Meta.stack(batches, "cpu"))
    assert packed.shape == (2, 2) and packed[:, 0].tolist() == losses
    for key, ref in _leaves(s_host).items():
        assert torch.equal(_leaves(s_multi)[key], ref), key


def _scalars(log_dir):
    path = glob.glob(os.path.join(log_dir, "scalars_*.jsonl"))[0]
    rows = [json.loads(line) for line in open(path)]
    return [r["loss"] for r in sorted((r for r in rows if "loss" in r), key=lambda r: r["step"])]


@pytest.mark.parametrize("k", [1, 2])
def test_cached_trainer_epoch_matches_host_loader_and_jax(corpus, tmp_path, k):
    """One epoch from one npz (float32): the port's cached Trainer against
    its host loader's (losses rtol 1e-3, the first kernel rtol 1e-3 / atol
    1e-4, as tests/test_device_cache.py holds JAX's) and against JAX's cached
    Trainer (losses rtol 1e-3 and `assert_training_matches`)."""
    np_params, np_bn = numpy_params("FullyCNN", seed=12, centred_bn=True)
    npz = str(tmp_path / "init.npz")
    j_export(npz, np_params, np_bn)
    runs = {}
    for tag, mod, cached in (("host", tcfg, False), ("cache", tcfg, True), ("jax", jcfg, True)):
        cfg = _config(mod, 2, steps_per_call=k, epochs=1, num_iter_print=100,
                      base_checkpoint_file=npz, checkpoints_path=str(tmp_path / tag / "ck"),
                      log_dir=str(tmp_path / tag / "log"))
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, train_manifest_path=corpus["clean"], train_noise_manifest=corpus["noise"],
            use_device_cache=cached, num_workers=1))
        if tag == "jax":
            loader, _ = j_cli.build_loaders(cfg, 1)
            trainer = JTrainer(cfg)
        else:
            loader, _ = cli.build_loaders(cfg, 1)
            trainer = Trainer(cfg, device="cpu")
        assert isinstance(loader, T.DeviceCacheLoader) == (tag == "cache")
        trainer.train(loader)
        trainer.ckpt.close()
        runs[tag] = (trainer.state, _scalars(str(tmp_path / tag / "log")))
    (hs, hl), (cs, cl), (js, jl) = runs["host"], runs["cache"], runs["jax"]
    assert len(cl) == len(hl) == len(jl) == 4
    np.testing.assert_allclose(cl, hl, rtol=1e-3)
    # the first kernel, as the JAX test holds it (see the single step above)
    np.testing.assert_allclose(cs.params["encode_1"]["w"].detach().numpy(),
                               hs.params["encode_1"]["w"].detach().numpy(), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(cl, jl, rtol=1e-3)
    assert int(cs.step) == 4
    assert_training_matches(cs, js, flat_leaves(np_params))


def _cli_ini(path, corpus, root, extra_data=""):
    path.write_text(
        "[training]\nepochs=1\nbatch_size=2\nlr=0.001\nwarmup_steps=50\ncontinue_train=False\n"
        f"steps_per_call=2\ncheckpoints_path={root}/ckpts\nlog_dir={root}/logs\n"
        "[model]\nnet_arch=RCED\nnet_work=FullyCNN\n"
        f"[data]\nsample_rate=8000\ntrain_manifest_path={corpus['clean']}\n"
        f"train_noise_manifest={corpus['noise']}\nsnr=0\nuse_device_cache=True\n"
        f"audio_save_path={root}/denoise\n{extra_data}"
    )
    return str(path)


def test_cli_trains_with_the_resident_cache(tmp_path, corpus):
    """`use_device_cache` through `cli/train --device cpu`: the resident
    loader, a cached epoch, scalars and a checkpoint on disk."""
    root = str(tmp_path)
    ini = _cli_ini(tmp_path / "cache.cfg", corpus, root)
    assert isinstance(cli.build_loaders(tcfg.load_ini_config(ini), 1)[0], T.DeviceCacheLoader)
    trainer = cli.main(["--cfg", ini, "--num-works", "1", "--device", "cpu"])
    losses = _scalars(os.path.join(root, "logs"))
    assert len(losses) == 4 == int(trainer.state.step) and np.all(np.isfinite(losses))
    assert trainer._cached_fns and set(trainer._cached_fns) == {(64, 2)}
    assert os.listdir(os.path.join(root, "ckpts", "RCED_FullyCNN")) == ["epoch_0.pt"]


def test_cli_trains_with_the_rotating_cache(tmp_path, corpus):
    """A `device_cache_budget_gb` below the corpus selects the rotating
    loader: shards spill to disk, rotate mid-epoch (`generation` once per
    shard), and every item trains once (with each shard's tail repeats)."""
    root = str(tmp_path)
    ini = _cli_ini(tmp_path / "rot.cfg", corpus, root,
                   "device_cache_budget_gb=0.00003\n"  # about 32 kB: several shards
                   f"device_cache_spill_dir={root}/spill\n")
    seen = []
    real_iter = T.RotatingDeviceCacheLoader.__iter__

    def recording_iter(self):
        for b in real_iter(self):
            entries = self._corpora[self._resident].entries
            seen.extend(entries[i].audio_filepath for i in b.indices)
            yield b

    T.RotatingDeviceCacheLoader.__iter__ = recording_iter
    try:
        trainer = cli.main(["--cfg", ini, "--num-works", "1", "--device", "cpu"])
    finally:
        T.RotatingDeviceCacheLoader.__iter__ = real_iter
    rot = trainer._cached_loader
    assert isinstance(rot, T.RotatingDeviceCacheLoader) and rot.num_shards >= 3
    assert rot.generation == rot.num_shards
    losses = _scalars(os.path.join(root, "logs"))
    assert len(losses) == len(rot) == int(trainer.state.step) and np.all(np.isfinite(losses))
    manifest = [json.loads(line)["audio_filepath"] for line in open(corpus["clean"])]
    assert sorted(set(seen)) == sorted(manifest) and len(seen) == 2 * len(rot)
    assert glob.glob(os.path.join(root, "spill", "clean_*.npy"))


# Each `_tpu` profile as written (V2, bf16, blocked, the cache; aishell_2's
# rotating loader with spill and the native decoder; VoiceBank premixed),
# cut to a made-up corpus: batch 2, steps_per_call 2, aishell_2's budget
# scaled to the corpus so that it still rotates.
PROFILES = ["aishell_1", "aishell_2", "voicebank"]


def _profile(mod, name, corpus, root, npz, cached=True):
    cfg = mod.load_ini_config(os.path.join(REPO, "work", name, "cfg", "fully_cnn_train_tpu.cfg"))
    premixed = name == "voicebank"
    data = dataclasses.replace(
        cfg.data,
        train_manifest_path=corpus["premixed" if premixed else "clean"],
        train_noise_manifest=None if premixed else corpus["noise"],
        val_manifest_path="",
        use_device_cache=cached,
        device_cache_budget_gb=3e-5 if cfg.data.device_cache_budget_gb else 0.0,
        device_cache_spill_dir=os.path.join(root, "spill") if cfg.data.device_cache_spill_dir else "",
        # the host loader's native mixing draws differ from the Python path's
        use_native=cfg.data.use_native and cached,
    )
    train = dataclasses.replace(
        cfg.train, batch_size=2, steps_per_call=2, epochs=1, continue_train=False,
        base_checkpoint_file=npz, checkpoints_path=os.path.join(root, "ck"),
        log_dir=os.path.join(root, "log"), num_iter_print=100,
    )
    return dataclasses.replace(cfg, data=data, train=train)


@pytest.mark.parametrize("name", PROFILES)
def test_tpu_profiles_train_a_cached_epoch(corpus, tmp_path, name):
    """A cached Trainer from the profile's settings trains one epoch on the
    CPU: its losses match JAX's cached Trainer's from the same npz (rtol
    2e-2, the bf16 budget of
    tests/test_torch_bf16.py::test_bf16_train_steps_within_jax_budget)
    and, for the resident cache, the host loader's (rtol 1e-3; the
    rotating loader seeds each shard's draws, so aishell_2's batches are
    other than the host loader's)."""
    np_params, np_bn = numpy_params("FullyCNNV2", seed=13, centred_bn=True)
    npz = str(tmp_path / "init.npz")
    j_export(npz, np_params, np_bn)
    losses = {}
    runs = (("cache", tcfg, True), ("jax", jcfg, True))
    if name != "aishell_2":
        runs += (("host", tcfg, False),)
    for tag, mod, cached in runs:
        root = str(tmp_path / tag)
        cfg = _profile(mod, name, corpus, root, npz, cached)
        if tag == "jax":
            loader, _ = j_cli.build_loaders(cfg, 1)
            trainer = JTrainer(cfg)
        else:
            loader, _ = cli.build_loaders(cfg, 1)
            trainer = Trainer(cfg, device="cpu")
        if tag == "cache":
            assert cfg.model.compute_dtype == "bfloat16" and cfg.model.blocked_compute
            rotating = name == "aishell_2"
            assert isinstance(loader, T.RotatingDeviceCacheLoader) == rotating
            assert isinstance(loader, T.DeviceCacheLoader) != rotating
            assert loader.premixed == (name == "voicebank")
        trainer.train(loader)
        trainer.ckpt.close()
        losses[tag] = _scalars(os.path.join(root, "log"))
    assert len(losses["cache"]) == len(losses["jax"]) >= 4
    assert np.all(np.isfinite(losses["cache"]))
    rel = np.abs(np.subtract(losses["cache"], losses["jax"])) / np.abs(losses["jax"])
    print(f"{name}: cached vs JAX cached, largest relative loss difference {rel.max():.3e}")
    np.testing.assert_allclose(losses["cache"], losses["jax"], rtol=2e-2)
    if name != "aishell_2":
        np.testing.assert_allclose(losses["cache"], losses["host"], rtol=1e-3)
