"""The port's data-parallel train step in real `gloo` ranks on the CPU,
against the JAX package's DP step on a 2-device mesh (the parent's
virtual CPU devices) and against the single-process step on the same
global batch.

Two ranks (spawned processes that import only the port,
`tests/torch_dp_ranks.py`) run every case once in one group; the JAX
references are computed here.  Tolerances start from tests/test_train.py's
for its DP step (loss rtol 1e-5; weights and BN statistics rtol 1e-4,
atol 1e-6; see `_assert_states_close` for where float32 noise needs
more), and the gradients equal JAX's in float64 to 1e-12 of their global
scale: that is the sync-BN backward check (a forward-only all-reduce of
the moments drops the other ranks' loss terms through them)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu import config as jcfg
from fullycnnspeechenhancement_tpu.models import apply_blocked as j_apply_blocked
from fullycnnspeechenhancement_tpu.models import get_model as j_get_model
from fullycnnspeechenhancement_tpu.parallel import dp as j_dp
from fullycnnspeechenhancement_tpu.parallel import make_mesh as j_make_mesh
from fullycnnspeechenhancement_tpu.train import step as j_step

from fullycnnspeechenhancement_torch import config as tcfg
from fullycnnspeechenhancement_torch.models import V2
from fullycnnspeechenhancement_torch.parallel import dp as pdp
from fullycnnspeechenhancement_torch.train.cached_step import Meta
from fullycnnspeechenhancement_torch.train.step import Batch, make_train_step
from fullycnnspeechenhancement_torch.train.trainer import Trainer
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401
from test_torch_train import MOMENT_TOL, UPDATE_TOL, flat_leaves, global_err, update_err
from torch_dp_ranks import dp_cases, run_step_case, spawn

SR = 8000
WORLD = 2
TRAIN = dict(batch_size=4, lr=1e-3, warmup_steps=100)
BLOCKED = dict(blocked_compute=True, blocked_fb=8, dw_pallas=True)

# name: (model, ModelConfig fields, TrainConfig fields, per-step lengths)
STEP_CASES = {
    "plain": ("FullyCNN", {}, {}, [(7200, 6000, 6800, 5200)]),
    # rank 1's rows are all short: its own frame-count max would mask
    # frames that the global batch-max mask keeps
    "short_rows_on_one_rank": ("FullyCNN", {}, {}, [(7200, 6400, 2000, 1200)]),
    "mask_loss": ("FullyCNN", {}, {"mask_loss": True}, [(7200, 3000, 6400, 2400)]),
    # the port runs dw_pallas=True (its dW Function, the plain version on
    # the CPU); JAX's blocked DP step runs dw_pallas=False, since its
    # Pallas dW in interpret mode under sharding is untested on a CPU mesh.
    # The dW is the same function (tests/test_torch_blocked_dw.py).
    "blocked_dw": ("FullyCNN", BLOCKED, {}, [(7200, 5600, 6400, 4000)]),
    "multi_step_k2": ("FullyCNN", {}, {}, [(7200, 6000, 6800, 5200), (6400, 7200, 3000, 7000)]),
}

# name: (model, blocked with the dW Function, mask_loss, lengths in frames)
GRAD_CASES = {
    "plain": ("FullyCNN", False, False, (20, 17, 6, 4)),
    "mask_loss": ("FullyCNN", False, True, (20, 9, 14, 5)),
    "blocked_dw": ("FullyCNN", True, False, (18, 20, 7, 12)),
}


def _waves(seed, lens, L=7200):
    rng = np.random.default_rng(seed)
    mix = np.zeros((len(lens), L), np.float32)
    clean = np.zeros((len(lens), L), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / SR
        c = 0.4 * np.sin(2 * np.pi * (300 + 150 * i) * t)
        clean[i, :n] = c
        mix[i, :n] = c + 0.2 * rng.standard_normal(n)
    return mix, clean, np.asarray(lens, np.int32)


@functools.lru_cache(maxsize=None)
def step_cases():
    out = {}
    for i, (name, (net, model, train, lengths)) in enumerate(sorted(STEP_CASES.items())):
        params, bn = numpy_params(net, seed=40 + i, centred_bn=True)
        out[name] = {
            "net": net, "model": model, "train": {**TRAIN, **train}, "params": params, "bn": bn,
            "batches": [_waves(50 + 10 * i + k, lens) for k, lens in enumerate(lengths)],
        }
    return out


@functools.lru_cache(maxsize=None)
def grad_cases():
    out = {}
    for i, (name, (net, blocked, mask_loss, lengths)) in enumerate(sorted(GRAD_CASES.items())):
        rng = np.random.default_rng(70 + i)
        B, T = len(lengths), 20
        lengths = np.asarray(lengths)
        if mask_loss:
            mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float64)
        else:
            mask = (np.arange(T) < lengths.max()).astype(np.float64)[None]
        params, bn = numpy_params(net, seed=80 + i, centred_bn=True)
        out[name] = {
            "net": net, "blocked": blocked, "mask_loss": mask_loss, "batch_size": B,
            "params": params, "bn": bn, "mask": mask,
            "x": np.abs(rng.standard_normal((B, T, 129, 1))),
            "tgt": np.abs(rng.standard_normal((B, T, 129, 1))),
        }
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results for every case, from one 2-rank gloo group."""
    out = tmp_path_factory.mktemp("dp_ranks")
    spawn(dp_cases, WORLD, out, (step_cases(), grad_cases(), str(out)))
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _jax_dp(case):
    """JAX's DP step (or K-step) over a 2-device mesh from the case's state."""
    model = dict(case["model"], dw_pallas=False) if case["model"] else {}
    jc = jcfg.Config(model=jcfg.ModelConfig(**model), train=jcfg.TrainConfig(**case["train"]))
    jm = j_get_model(case["net"])
    params = jax.tree.map(jnp.asarray, case["params"])
    bn = jax.tree.map(jnp.asarray, case["bn"])
    state = j_step.TrainState(params, bn, j_step.make_optimizer(jc).init(params), jnp.zeros([], jnp.int32))
    mesh = j_make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    batches = [j_step.Batch(*(jnp.asarray(a) for a in w)) for w in case["batches"]]
    if len(batches) > 1:
        stacked = j_step.Batch(*(None if f[0] is None else jnp.stack(f) for f in zip(*batches)))
        state, packed = j_dp.make_parallel_multi_step(jc, jm, mesh)(
            state, j_dp.shard_stacked_batch(mesh, stacked))
        losses = np.asarray(packed)[:, 0]
    else:
        state, metrics = j_dp.make_parallel_train_step(jc, jm, mesh)(state, j_dp.shard_batch(mesh, batches[0]))
        losses = np.asarray([float(metrics["loss"])])
    bn = {(n, k): np.asarray(v, np.float64) for n, d in state.bn_state.items() for k, v in d.items()}
    return {"loss": losses, "params": flat_leaves(state.params), "bn": bn,
            "mu": flat_leaves(state.opt_state.mu), "step": int(state.step)}


# Float32 parity.  After one Adam step a parameter has moved by about
# +-lr on the sign of its gradient, so where a gradient lies within float32
# rounding noise of 0 (the biases of BN layers, analytically 0, among them)
# its sign, and the move, are noise in either package.  The parameters are
# held at tests/test_train.py's tolerance wherever the gradient (Adam's mu)
# exceeds GRAD_FLOOR of its global scale on both sides (about 5-8% of the
# elements fall below it; the gradients differ by at most 1.5e-3 of that
# scale from JAX's, 1.4e-4 from the single process's: measured), and the
# gradients themselves through mu against their global scale.  After K = 2
# steps Adam's second update also carries the first step's noise, so the
# multi-step case holds the params as the port's float32 steps against JAX
# are held (test_torch_train.assert_training_matches's moments, update and
# params).  The float64 gradient test below holds the math to 1e-12.
GRAD_FLOOR = 1e-3
# reference: (loss rtol, mu tolerance).  The loss differs from JAX's by up
# to 1.9e-5 (blocked: E[y^2] - mean^2 in float32 cancels), from the single
# process's by up to 2.4e-7 (measured).
TOLS = {"JAX DP": (1e-4, MOMENT_TOL), "single process": (1e-5, 1e-3)}


def _assert_states_close(got, ref, what, p_before):
    loss_rtol, mu_tol = TOLS[what]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=loss_rtol, err_msg=f"{what}: loss")
    assert got["step"] == ref["step"]
    for key, v in ref["bn"].items():
        np.testing.assert_allclose(got["bn"][key], v, rtol=1e-4, atol=1e-6, err_msg=f"{what}: BN {key}")
    err = global_err(got["mu"], ref["mu"])
    print(f"{what}: Adam mu {err:.3e} of its global scale")
    assert err < mu_tol, f"{what}: Adam mu off by {err:.3e} of its global scale"
    if got["step"] > 1:
        err = update_err(got["params"], ref["params"], p_before)
        assert err < UPDATE_TOL, f"{what}: param update off by {err:.3e} of its norm"
        for key, v in ref["params"].items():
            np.testing.assert_allclose(got["params"][key], v, atol=5e-4, rtol=0.2, err_msg=f"{what}: {key}")
        return
    floor = GRAD_FLOOR * max(np.abs(v).max() for v in ref["mu"].values())
    for key, v in ref["params"].items():
        live = (np.abs(ref["mu"][key]) > floor) & (np.abs(got["mu"][key]) > floor)
        np.testing.assert_allclose(got["params"][key][live], v[live], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what}: {key}")


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_dp_step_matches_jax_dp_and_single_process(case, ranks):
    """Rank 0's state after the DP step(s) equals rank 1's bit for bit,
    and JAX's DP step over 2 devices and the port's single-process step on
    the whole batch as `_assert_states_close` holds them."""
    got, other = ranks[0][("step", case)], ranks[1][("step", case)]
    for part in ("params", "bn", "mu"):
        for key, v in got[part].items():
            np.testing.assert_array_equal(other[part][key], v, err_msg=f"ranks differ: {part} {key}")
    np.testing.assert_array_equal(other["loss"], got["loss"])
    c = step_cases()[case]
    p_before = flat_leaves(c["params"])
    _assert_states_close(got, _jax_dp(c), "JAX DP", p_before)
    _assert_states_close(got, run_step_case(None, c), "single process", p_before)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_dp_gradients_match_jax_f64(case, ranks):
    """The DP loss gradient (sync-BN forward and backward, the global mask
    mean, the summed gradients; blocked with the dW Function) in float64,
    summed over two ranks, against JAX's gradient of the whole batch's
    loss: to 1e-12 of the global gradient scale on both ranks."""
    c = grad_cases()[case]
    jm = j_get_model(c["net"])
    j_forward = jm.apply
    if c["blocked"]:
        j_forward = functools.partial(j_apply_blocked, jm, fb=8, precision=jax.lax.Precision.HIGHEST)
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        jbn = to64(c["bn"])

        def j_loss(p):
            y, _ = j_forward(p, jbn, jnp.asarray(c["x"]), is_training=True, frame_mask=jnp.asarray(c["mask"]))
            return j_step.spectral_l2_loss(y, jnp.asarray(c["tgt"]), c["batch_size"], jnp.asarray(c["mask"]),
                                           normalize_mask=c["mask_loss"])

        jl, jg = jax.jit(jax.value_and_grad(j_loss))(to64(c["params"]))
        jl, jg = float(jl), flat_leaves(jg)
    for r in range(WORLD):
        got = ranks[r][("grad", case)]
        np.testing.assert_allclose(got["loss"], jl, rtol=1e-12)
        err = global_err(got["grads"], jg)
        print(f"{case} rank {r}: gradient {err:.3e} of its global scale")
        assert err < 1e-12


def test_dp_rejects_indivisible_batch():
    """A DP step for a global batch that the group's size does not divide
    raises when it is made (the multi-step and cached steps are built over
    it), and so does a batch or metadata of such a size when it is
    sharded (tests/test_train.py:267)."""
    cfg = tcfg.Config(train=tcfg.TrainConfig(batch_size=3))
    dp = pdp.DataParallel(world=2)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(cfg, V2, dp=dp)
    make_train_step(tcfg.Config(train=tcfg.TrainConfig(batch_size=4)), V2, dp=dp)
    lengths = np.full(5, 8000, np.int32)
    with pytest.raises(ValueError, match="not divisible"):
        pdp.shard_batch(dp, Batch(np.zeros((5, 8000)), np.zeros((5, 8000)), lengths, None))
    with pytest.raises(ValueError, match="not divisible"):
        pdp.shard_stacked_batch(dp, Meta(*[np.zeros((2, 5), np.int32)] * len(Meta._fields)))


def test_dp_trainer_needs_a_process_group(tmp_path):
    """Without a process group a DP Trainer raises, naming how to start
    the ranks; it never trains alone on its rows."""
    cfg = tcfg.Config(train=tcfg.TrainConfig(data_parallel=2, checkpoints_path=str(tmp_path),
                                             log_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        Trainer(cfg, device="cpu")
