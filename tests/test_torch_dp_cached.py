"""The port's data-parallel training over the device cache, in real `gloo`
ranks on the CPU: the DP cached step (and its K = 2 form) against JAX's
(tests/test_device_cache.py:729) and the single-process cached step, and a
DP `Trainer` over the rotating cache against JAX's DP Trainer and the
port's single-process one (tests/test_device_cache.py:635).  Every rank
commits the whole corpus and materializes only its metadata rows."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu import config as jcfg
from fullycnnspeechenhancement_tpu.data import device_cache as J
from fullycnnspeechenhancement_tpu.models import get_model as j_get_model
from fullycnnspeechenhancement_tpu.parallel import dp as j_dp
from fullycnnspeechenhancement_tpu.parallel import make_mesh as j_make_mesh
from fullycnnspeechenhancement_tpu.train import step as j_step
from fullycnnspeechenhancement_tpu.train.cached_step import Meta as JMeta
from fullycnnspeechenhancement_tpu.train.checkpoint import export_params_npz
from fullycnnspeechenhancement_tpu.train.trainer import Trainer as JTrainer

from fullycnnspeechenhancement_torch import config as tcfg
from fullycnnspeechenhancement_torch.data import device_cache as T
from fullycnnspeechenhancement_torch.data import write_manifest, write_wav
from fullycnnspeechenhancement_torch.train.trainer import Trainer
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401
from test_torch_dp import _assert_states_close
from test_torch_train import MOMENT_TOL, UPDATE_TOL, flat_leaves, global_err, update_err
from torch_dp_ranks import dp_cached_cases, run_cached_case, spawn

SR = 8000
BUDGET = 64_000  # bytes: three or more shards of this corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Twelve clean utterances of 0.6-0.95 s (one bucket) and two longer
    noise recordings."""
    root = tmp_path_factory.mktemp("dp_cached_corpus")
    rng = np.random.default_rng(5)
    clean, noise = [], []
    for i, sec in enumerate([0.6, 0.95, 0.7, 0.85, 0.65, 0.9, 0.75, 0.8, 0.7, 0.9, 0.6, 0.85]):
        t = np.arange(int(sec * SR)) / SR
        sig = (0.4 * np.sin(2 * np.pi * (250 + 70 * i) * t)).astype(np.float32)
        p = str(root / f"c{i}.wav")
        write_wav(p, sig, SR)
        clean.append({"audio_filepath": p, "duration": sec})
    for i, sec in enumerate([2.0, 2.5]):
        p = str(root / f"n{i}.wav")
        write_wav(p, 0.2 * rng.standard_normal(int(sec * SR)).astype(np.float32), SR)
        noise.append({"audio_filepath": p, "duration": sec})
    paths = {k: str(root / f"manifest.{k}") for k in ("clean", "noise")}
    write_manifest(paths["clean"], clean)
    write_manifest(paths["noise"], noise)
    return paths


def _jax_cached(corpus, params, bn, k):
    """JAX's DP cached step (K = 1) or cached multi-step over 2 devices."""
    dsp = jcfg.DSPConfig()
    jc = jcfg.Config(model=jcfg.ModelConfig(net_work="FullyCNN"),
                     train=jcfg.TrainConfig(batch_size=4, lr=1e-3, warmup_steps=100))
    c = J.build_device_corpus(corpus["clean"], corpus["noise"], dsp, commit=False)
    loader = J.DeviceCacheLoader(c, dsp, 4, shuffle=False, seed=0)
    batches = list(loader)[:k]
    mesh = j_make_mesh(n_data=2, devices=jax.devices()[:2])
    c.commit(j_dp.replicate(mesh))
    p, b = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, bn)
    state = j_step.TrainState(p, b, j_step.make_optimizer(jc).init(p), jnp.zeros([], jnp.int32))
    samples = loader.pad_len(batches[0].bucket_frames)
    if k == 1:
        fn = j_dp.make_parallel_cached_step(jc, j_get_model("FullyCNN"), mesh, samples, c.premixed)
        state, m = fn(state, c.clean, c.other, j_dp.shard_meta(mesh, JMeta.from_batch(batches[0])))
        losses = np.asarray([float(m["loss"])])
    else:
        fn = j_dp.make_parallel_cached_multi_step(jc, j_get_model("FullyCNN"), mesh, samples, c.premixed)
        state, packed = fn(state, c.clean, c.other, j_dp.shard_stacked_meta(mesh, JMeta.stack(batches)))
        losses = np.asarray(packed)[:, 0]
    return {"loss": losses, "params": flat_leaves(state.params), "mu": flat_leaves(state.opt_state.mu),
            "bn": {(n, s): np.asarray(v, np.float64) for n, d in state.bn_state.items() for s, v in d.items()},
            "step": int(state.step)}


CACHED_SEED, TRAINER_SEED = 21, 22


def _config(mod, root, n_dp, npz):
    return mod.Config(
        model=mod.ModelConfig(net_work="FullyCNN"),
        train=mod.TrainConfig(batch_size=4, lr=1e-3, warmup_steps=100, steps_per_call=2,
                              continue_train=False, base_checkpoint_file=npz, num_iter_print=100,
                              data_parallel=n_dp, checkpoints_path=f"{root}/ck", log_dir=f"{root}/log"),
    )


@pytest.fixture(scope="module")
def dp_ranks(corpus, tmp_path_factory):
    """One 2-rank group: both ranks' states after the cached DP step and
    multi-step, then after the rotating-cache DP Trainer's two epochs
    (its checkpoints and logs under `root`)."""
    root = tmp_path_factory.mktemp("dp_cached_ranks")
    params, bn = numpy_params("FullyCNN", seed=CACHED_SEED, centred_bn=True)
    npz = str(root / "init.npz")
    export_params_npz(npz, *numpy_params("FullyCNN", seed=TRAINER_SEED, centred_bn=True))
    spawn(dp_cached_cases, 2, root,
          (corpus, params, bn, _config(tcfg, str(root), 2, npz), BUDGET, str(root)))
    load = lambda name: [torch.load(root / f"{name}{r}.pt", weights_only=False) for r in range(2)]  # noqa: E731
    return {"cached": load("cached_rank"), "trainer": load("rank"), "root": str(root), "npz": npz}


@pytest.mark.parametrize("k", [1, 2])
def test_cached_dp_step_matches_jax_and_single_process(corpus, dp_ranks, k):
    """Two ranks' cached DP step (K = 1) and cached multi-step (K = 2) from
    one numpy state: the ranks equal bit for bit, and each against JAX's
    DP cached step over 2 devices and the port's single-process cached
    step, as tests/test_torch_dp.py holds the host-batch DP step."""
    params, bn = numpy_params("FullyCNN", seed=CACHED_SEED, centred_bn=True)
    r0, r1 = (r[k] for r in dp_ranks["cached"])
    for part in ("params", "bn", "mu"):
        for key, v in r0[part].items():
            np.testing.assert_array_equal(r1[part][key], v, err_msg=f"ranks differ: {part} {key}")
    p_before = flat_leaves(params)
    _assert_states_close(r0, _jax_cached(corpus, params, bn, k), "JAX DP", p_before)
    _assert_states_close(r0, run_cached_case(None, corpus, params, bn, k), "single process", p_before)


def _losses(root):
    path = glob.glob(os.path.join(root, "log", "scalars_*.jsonl"))[0]
    rows = [json.loads(line) for line in open(path)]
    return [r["loss"] for r in sorted((r for r in rows if "loss" in r), key=lambda r: r["step"])]


def test_rotating_cache_dp_trainer_matches_jax_and_single_process(corpus, dp_ranks, tmp_path):
    """A 2-rank DP Trainer over the rotating cache (3 or more shards, each
    rank's own spill directory, generation-keyed K = 2 groups), two epochs
    from one npz: the ranks' states equal; rank 0 alone logs and
    checkpoints; its losses and params against the port's single-process
    rotating Trainer (tests/test_device_cache.py:635's tolerances: losses
    rtol 2e-4, the first kernel rtol 1e-3, atol 1e-5) and against JAX's DP
    rotating Trainer (the port's float32 standard against JAX: losses rtol
    1e-3 and `assert_training_matches`'s checks)."""
    params, _ = numpy_params("FullyCNN", seed=TRAINER_SEED, centred_bn=True)
    npz, dp_root, ranks = dp_ranks["npz"], dp_ranks["root"], dp_ranks["trainer"]
    for key, v in ranks[0]["params"].items():
        np.testing.assert_array_equal(ranks[1]["params"][key], v)
    n, shards = ranks[0]["batches"], ranks[0]["num_shards"]
    assert shards >= 3
    for r in ranks:
        assert r["step"] == r["host_step"] == 2 * n
        assert 2 * shards - 1 <= r["generation"] <= 2 * shards
    assert sorted(os.listdir(os.path.join(dp_root, "ck", "RCED_FullyCNN"))) == ["epoch_0.pt", "epoch_1.pt"]
    assert len(glob.glob(os.path.join(dp_root, "log", "scalars_*.jsonl"))) == 1
    dp_losses = _losses(dp_root)
    assert len(dp_losses) == 2 * n

    sd_root = str(tmp_path / "sd")
    rot = T.RotatingDeviceCacheLoader(corpus["clean"], corpus["noise"], tcfg.DSPConfig(), 4,
                                      hbm_budget_bytes=BUDGET, shuffle=True, seed=0,
                                      spill_dir=f"{sd_root}/spill")
    single = Trainer(_config(tcfg, sd_root, 1, npz), device="cpu")
    single.train(rot, epochs=2)
    single.ckpt.close()
    np.testing.assert_allclose(dp_losses, _losses(sd_root), rtol=2e-4)
    np.testing.assert_allclose(ranks[0]["params"][("encode_1", "w")],
                               flat_leaves(single.state.params, port=True)[("encode_1", "w")],
                               rtol=1e-3, atol=1e-5)

    j_root = str(tmp_path / "jax")
    j_rot = J.RotatingDeviceCacheLoader(corpus["clean"], corpus["noise"], jcfg.DSPConfig(), 4,
                                        hbm_budget_bytes=BUDGET, shuffle=True, seed=0,
                                        spill_dir=f"{j_root}/spill")
    jt = JTrainer(_config(jcfg, j_root, 2, npz))
    jt.train(j_rot, epochs=2)
    jt.ckpt.close()
    np.testing.assert_allclose(dp_losses, _losses(j_root), rtol=1e-3)
    # test_torch_train.assert_training_matches, on the rank's numpy state
    for m in ("mu", "nu"):
        err = global_err(ranks[0][m], flat_leaves(getattr(jt.state.opt_state, m)))
        assert err < MOMENT_TOL, f"Adam {m}: {err:.3e} of its global scale"
    j_params = flat_leaves(jt.state.params)
    assert update_err(ranks[0]["params"], j_params, flat_leaves(params)) < UPDATE_TOL
    for key, v in j_params.items():
        np.testing.assert_allclose(ranks[0]["params"][key], v, atol=5e-4, rtol=0.2, err_msg=str(key))
