"""The port's schedule, optimizer, loss, train/eval steps and checkpoint
format against the JAX package, on the CPU: the same numpy state and
batches go through both packages' steps."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu import config as jcfg
from fullycnnspeechenhancement_tpu.models import apply_blocked as j_apply_blocked
from fullycnnspeechenhancement_tpu.models import get_model as j_get_model
from fullycnnspeechenhancement_tpu.train import optim as j_optim
from fullycnnspeechenhancement_tpu.train import step as j_step

from fullycnnspeechenhancement_torch import config as tcfg
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.models.blocked import apply_blocked
from fullycnnspeechenhancement_torch.train import checkpoint as ckpt
from fullycnnspeechenhancement_torch.train import optim, step
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401

SR = 8000


def _configs(**model):
    train = dict(batch_size=2, lr=1e-3, warmup_steps=100)
    mask_loss = model.pop("mask_loss", False)
    return (
        jcfg.Config(model=jcfg.ModelConfig(**model), train=jcfg.TrainConfig(mask_loss=mask_loss, **train)),
        tcfg.Config(model=tcfg.ModelConfig(**model), train=tcfg.TrainConfig(mask_loss=mask_loss, **train)),
    )


def _waves(seed, lens=(4000, 7200), pad_to=None):
    """Two tone-plus-noise utterances of different lengths, zero-padded."""
    rng = np.random.default_rng(seed)
    L = pad_to or max(lens)
    mix = np.zeros((len(lens), L), np.float32)
    clean = np.zeros((len(lens), L), np.float32)
    for i, n in enumerate(lens):
        t = np.arange(n) / SR
        c = 0.4 * np.sin(2 * np.pi * (300 + 200 * i) * t)
        clean[i, :n] = c
        mix[i, :n] = c + 0.2 * rng.standard_normal(n)
    return mix, clean, np.asarray(lens, np.int32)


def _int16(mix, clean):
    peak = np.maximum(np.abs(mix).max(axis=1), np.abs(clean).max(axis=1))
    scale = (np.maximum(peak, 1e-12) * (32768.0 / 32767.0)).astype(np.float32)
    q = 32768.0 / scale[:, None]
    to16 = lambda a: np.clip(np.round(a * q), -32768, 32767).astype(np.int16)  # noqa: E731
    return to16(mix), to16(clean), scale


def _batches(mix, clean, lengths, scale=None):
    jb = j_step.Batch(jnp.asarray(mix), jnp.asarray(clean), jnp.asarray(lengths),
                      None if scale is None else jnp.asarray(scale))
    tb = step.Batch(torch.as_tensor(mix), torch.as_tensor(clean), torch.as_tensor(lengths),
                    None if scale is None else torch.as_tensor(scale))
    return jb, tb


def _jax_state(name, jc, seed):
    params, bn = numpy_params(name, seed)
    params = jax.tree.map(jnp.asarray, params)
    bn = jax.tree.map(jnp.asarray, bn)
    opt = j_step.make_optimizer(jc).init(params)
    return j_step.TrainState(params, bn, opt, jnp.zeros([], jnp.int32))


def _port_state(js):
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return ckpt.train_state_from_numpy(
        np_tree(js.params), np_tree(js.bn_state), np_tree(js.opt_state.mu),
        np_tree(js.opt_state.nu), np.asarray(js.step),
    )


def _assert_params_close(ts, js, atol=5e-4, rtol=0.2):
    """Adam's sign-like updates amplify reduction-order noise, so params are
    held against the update scale (tests/test_train.py's tolerance)."""
    for name, p in js.params.items():
        for k, v in p.items():
            ref = np.asarray(v)
            got = ts.params[name][k].detach()
            got = (got.permute(2, 3, 1, 0) if k == "w" else got).numpy()
            np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol, err_msg=f"{name}/{k}")


def flat_leaves(tree, port=False):
    """{(layer, leaf): float64 array} in the JAX layout (port kernels
    OIHW -> HWIO)."""
    out = {}
    for name, p in tree.items():
        for k, v in p.items():
            if port:
                v = v.detach().cpu()
                v = (v.permute(2, 3, 1, 0) if k == "w" else v).numpy()
            out[(name, k)] = np.asarray(v, np.float64)
    return out


def global_err(got, ref):
    """max |got - ref| over all leaves, over max |ref| over all leaves.  The
    scale is global because biases under training-mode BN have gradients
    that cancel analytically: a per-leaf scale would blow their rounding
    noise up (tests/test_blocked.py:85-94)."""
    scale = max(np.abs(v).max() for v in ref.values())
    return max(np.abs(got[k] - ref[k]).max() for k in ref) / scale


def update_err(after, ref_after, before):
    """|d - d_ref| / |d_ref| for the params' change d = after - before over
    all leaves as one vector: 1 for steps that leave the params where they
    were, 2 for a sign-flipped update."""
    keys = sorted(ref_after)
    d = np.concatenate([(after[k] - before[k]).ravel() for k in keys])
    d_ref = np.concatenate([(ref_after[k] - before[k]).ravel() for k in keys])
    return np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref)


# f32 tolerances of the moments and the update against the JAX package.
# Over the steps below, reduction order alone moves the moments by up to
# 1.2e-3 of their global scale and the update by up to 6.6e-2 (plain V2:
# Adam gives the cancelled biases noise-sized steps of full size); a fault
# that stops, flips or drops a gradient moves them by O(1).
MOMENT_TOL = 1e-2  # tests/test_blocked.py:102-103, f32 gradients vs scale
UPDATE_TOL = 0.2


def assert_training_matches(ts, js, p_before):
    """The port's state after some steps against the JAX package's: Adam
    moments (weighted sums of every step's gradient) against their global
    scale, the params' change as one vector, and the params themselves at
    the JAX package's reduction-order tolerance."""
    for m in ("mu", "nu"):
        err = global_err(flat_leaves(getattr(ts.opt_state, m), port=True),
                         flat_leaves(getattr(js.opt_state, m)))
        assert err < MOMENT_TOL, f"Adam {m}: {err:.3e} of its global scale"
    err = update_err(flat_leaves(ts.params, port=True), flat_leaves(js.params), p_before)
    assert err < UPDATE_TOL, f"param update off by {err:.3e} of its norm"
    _assert_params_close(ts, js)


def test_noam_schedule_matches_jax():
    j = j_optim.noam_schedule(1.5e-3, 10000)
    t = optim.noam_schedule(1.5e-3, 10000)
    steps = [0, 1, 99, 9999, 10000, 50000]
    for s in steps:
        np.testing.assert_allclose(t(s), float(j(s)), rtol=1e-6)
    got = t(torch.tensor(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j(jnp.asarray(steps))), rtol=1e-6)


def test_tf_adam_matches_jax():
    """Three TF-Adam updates under the Noam schedule, on a small tree;
    `torch.optim.Adam` would differ (eps inside the corrected root)."""
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                    "b": rng.standard_normal(4).astype(np.float32)}}
    grads = [{"a": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                    "b": rng.standard_normal(4).astype(np.float32)}} for _ in range(3)]
    sched_j = j_optim.noam_schedule(1e-2, 2.0)
    tx = j_optim.tf_adam(sched_j, eps=1e-3)
    jp = jax.tree.map(jnp.asarray, params)
    js = tx.init(jp)
    tp = {"a": {k: torch.as_tensor(v.copy()) for k, v in params["a"].items()}}
    ts = optim.tf_adam_init(tp)
    for g in grads:
        upd, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, upd)
        ts = optim.tf_adam_update(
            tp, {"a": {k: torch.as_tensor(v) for k, v in g["a"].items()}}, ts,
            optim.noam_schedule(1e-2, 2.0), eps=1e-3,
        )
    assert int(ts.count) == int(js.count) == 3
    for k in ("w", "b"):
        np.testing.assert_allclose(tp["a"][k].numpy(), np.asarray(jp["a"][k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.mu["a"][k].numpy(), np.asarray(js.mu["a"][k]), rtol=1e-6)
        np.testing.assert_allclose(ts.nu["a"][k].numpy(), np.asarray(js.nu["a"][k]), rtol=1e-6)


@pytest.mark.parametrize("mode", ["none", "batchmax", "normalized"])
def test_spectral_l2_loss_matches_jax(mode):
    rng = np.random.default_rng(1)
    pred = rng.standard_normal((2, 7, 129, 1)).astype(np.float32)
    tgt = rng.standard_normal((2, 7, 129, 1)).astype(np.float32)
    mask = None
    if mode == "batchmax":
        mask = (np.arange(7) < 5).astype(np.float32)[None]
    elif mode == "normalized":
        mask = (np.arange(7)[None] < np.array([[3], [6]])).astype(np.float32)
    ref = j_step.spectral_l2_loss(pred, tgt, 4, None if mask is None else jnp.asarray(mask),
                                  normalize_mask=mode == "normalized")
    got = step.spectral_l2_loss(torch.as_tensor(pred), torch.as_tensor(tgt), 4,
                                None if mask is None else torch.as_tensor(mask),
                                normalize_mask=mode == "normalized")
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)


STEP_CASES = {
    # name: (model, ModelConfig fields, int16 batches)
    "plain": ("FullyCNNV2", {}, False),
    "blocked_dw": ("FullyCNNV2", {"blocked_compute": True, "dw_pallas": True}, False),
    "mask_loss": ("FullyCNN", {"mask_loss": True}, False),
    "int16": ("FullyCNN", {}, True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(case):
    """One JAX step, then its state carried into the port (params, BN,
    Adam moments, step), then five steps in both packages on the same
    batches: per-step losses within rtol 1e-3, then the Adam moments, the
    params' change and the params (`assert_training_matches`)."""
    name, fields, int16 = STEP_CASES[case]
    jc, tc = _configs(**fields)
    jstep = jax.jit(j_step.make_train_step(jc, j_get_model(name)))
    tstep = step.make_train_step(tc, get_model(name))
    batches = []
    for i in range(3):
        mix, clean, lengths = _waves(10 + i, pad_to=8000)
        if int16:
            m16, c16, scale = _int16(mix, clean)
            batches.append(_batches(m16, c16, lengths, scale))
        else:
            batches.append(_batches(mix, clean, lengths))
    js = _jax_state(name, jc, seed=2)
    js, _ = jstep(js, batches[0][0])
    ts = _port_state(js)
    p_before = flat_leaves(js.params)
    assert int(ts.step) == 1
    for i in range(5):
        jb, tb = batches[i % len(batches)]
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-3)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
        assert int(tm["step"]) == int(jm["step"]) == i + 1
    assert int(ts.step) == int(ts.opt_state.count) == 6
    assert_training_matches(ts, js, p_before)
    for lname, s in js.bn_state.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(ts.bn_state[lname][k].numpy(), np.asarray(s[k]),
                                       rtol=1e-3, atol=1e-5, err_msg=f"{lname}/{k}")


GRAD_CASES = {
    # name: (model, blocked with the dW Function, mask_loss)
    "plain": ("FullyCNNV2", False, False),
    "blocked_dw": ("FullyCNNV2", True, False),
    "mask_loss": ("FullyCNN", False, True),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_train_loss_gradients_match_jax_f64(case):
    """The gradient of the train step's loss (training-mode BN and its
    masked moments, the loss mask, and for blocked_dw the weight gather's
    scatter-add and the dW Function) in float64 in both packages from one
    numpy state, to 1e-12 of the global gradient scale.  In float32 the
    two differ by about 1e-3 of that scale from reduction order alone,
    which would hide a small fault both forms of the port shared."""
    name, blocked, mask_loss = GRAD_CASES[case]
    rng = np.random.default_rng(8)
    B, T = 2, 20
    x = np.abs(rng.standard_normal((B, T, 129, 1)))
    tgt = np.abs(rng.standard_normal((B, T, 129, 1)))
    lengths = np.array([12, 17])
    if mask_loss:
        mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float64)
    else:
        mask = (np.arange(T) < lengths.max()).astype(np.float64)[None]
    params, bn = numpy_params(name, seed=3)

    jm = j_get_model(name)
    j_forward = jm.apply
    if blocked:
        j_forward = functools.partial(j_apply_blocked, jm, fb=8, precision=jax.lax.Precision.HIGHEST)
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        jbn = to64(bn)

        def j_loss(p):
            y, _ = j_forward(p, jbn, jnp.asarray(x), is_training=True, frame_mask=jnp.asarray(mask))
            return j_step.spectral_l2_loss(y, jnp.asarray(tgt), 4, jnp.asarray(mask),
                                           normalize_mask=mask_loss)

        jl, jg = jax.value_and_grad(j_loss)(to64(params))
        jl, jg = float(jl), flat_leaves(jg)

    tp, tbn = ckpt.params_from_numpy(params, bn)
    tp = {n: {k: v.double().requires_grad_() for k, v in d.items()} for n, d in tp.items()}
    tbn = {n: {k: v.double() for k, v in d.items()} for n, d in tbn.items()}
    model = get_model(name)
    t_forward = functools.partial(apply_blocked, model, fb=8, dw_pallas=True) if blocked else model.apply
    y, _ = t_forward(tp, tbn, torch.as_tensor(x), is_training=True, frame_mask=torch.as_tensor(mask))
    loss = step.spectral_l2_loss(y, torch.as_tensor(tgt), 4, torch.as_tensor(mask),
                                 normalize_mask=mask_loss)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jl, rtol=1e-12)
    tg = flat_leaves({n: {k: v.grad for k, v in d.items()} for n, d in tp.items()}, port=True)
    assert global_err(tg, jg) < 1e-12


def test_multi_step_matches_sequential():
    """K steps in one multi-step call == K single steps: the same losses
    and the same final params (one process, the same kernels in the same
    order, so equal to the bit)."""
    _, tc = _configs()
    model = get_model("FullyCNN")
    tstep = step.make_train_step(tc, model)
    multi = step.make_multi_step(tstep)
    waves = [_waves(20 + i) for i in range(3)]
    sa = step.create_train_state(tc, model, torch.Generator().manual_seed(7), device="cpu")
    sb = step.create_train_state(tc, model, torch.Generator().manual_seed(7), device="cpu")
    losses = []
    for w in waves:
        sa, m = tstep(sa, step.Batch(*(torch.as_tensor(a) for a in w)))
        losses.append(m["loss"].item())
    stacked = step.Batch(*(torch.as_tensor(np.stack([w[j] for w in waves])) for j in range(3)))
    sb, packed = multi(sb, stacked)
    assert packed.shape == (3, 2)
    np.testing.assert_array_equal(packed[:, 0].numpy(), np.asarray(losses, np.float32))
    assert int(sb.step) == 3
    for name in sa.params:
        for k in sa.params[name]:
            assert torch.equal(sa.params[name][k], sb.params[name][k])


def test_bucket_slack_matches_batchmax_padding():
    """Training on a bucket-padded batch equals training on the reference's
    batch-max-padded collate (tests/test_train.py's parity contract): BN
    statistics and the loss mask out the bucket slack.  After the first
    step the moving statistics are plain masked averages of one forward and
    are held at tests/test_train.py's rtol 1e-4 / atol 1e-7; after three,
    Adam has amplified the two paddings' f32 reduction-order noise, and
    they are held at the train-step parity tolerance (rtol 1e-3 / atol
    1e-5, test_train_steps_match_jax)."""
    dsp = tcfg.DSPConfig()
    _, tc = _configs()
    model = get_model("FullyCNNV2")
    lens = (4000, 7200)
    batchmax_pad = dsp.padded_samples(max(dsp.num_frames(n) for n in lens))
    bucket_pad = dsp.padded_samples(128)
    assert bucket_pad > batchmax_pad
    tstep = step.make_train_step(tc, model)
    after_one, states, losses = [], [], []
    for pad in (batchmax_pad, bucket_pad):
        s = step.create_train_state(tc, model, torch.Generator().manual_seed(0), device="cpu")
        b = step.Batch(*(torch.as_tensor(a) for a in _waves(5, lens, pad_to=pad)))
        ls = []
        for i in range(3):
            s, m = tstep(s, b)
            ls.append(m["loss"].item())
            if i == 0:
                after_one.append(s.bn_state)
        states.append(s)
        losses.append(ls)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for lname in after_one[0]:
        for k in ("mean", "var"):
            np.testing.assert_allclose(after_one[1][lname][k].numpy(), after_one[0][lname][k].numpy(),
                                       rtol=1e-4, atol=1e-7, err_msg=f"{lname}/{k}")
            np.testing.assert_allclose(states[1].bn_state[lname][k].numpy(),
                                       states[0].bn_state[lname][k].numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=f"{lname}/{k}")


def test_int16_transport_matches_jax():
    mix, clean, lengths = _waves(3, pad_to=8000)
    m16, c16, scale = _int16(mix, clean)
    ref = np.asarray(j_step._as_wav(jnp.asarray(m16), jnp.asarray(scale)))
    got = step._as_wav(torch.as_tensor(m16), torch.as_tensor(scale))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # one quantization step of each utterance's own peak
    assert np.abs(got.numpy() - mix).max() <= scale.max() / 32768.0
    assert step._as_wav(torch.as_tensor(mix), None).data_ptr() == torch.as_tensor(mix).data_ptr()


@pytest.mark.parametrize("mode", ["bn_eval", "bn_train", "fused"])
def test_eval_step_matches_jax(mode):
    jc, tc = _configs(fused_inference=mode == "fused")
    name = "FullyCNNV2"
    is_training = mode == "bn_train"
    params, bn = numpy_params(name, seed=4)
    mix, _, lengths = _waves(6, lens=(3000, 5500), pad_to=6000)
    jfn = jax.jit(j_step.make_eval_step(jc, j_get_model(name), is_training=is_training))
    ref = [np.asarray(a) for a in jfn(params, bn, jnp.asarray(mix), jnp.asarray(lengths))]
    tp, tb = ckpt.params_from_numpy(params, bn)
    got = step.make_eval_step(tc, get_model(name), is_training=is_training)(
        tp, tb, torch.as_tensor(mix), torch.as_tensor(lengths)
    )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=1e-4 * max(np.abs(r).max(), 1.0))


def test_checkpoint_manager_round_trip(tmp_path):
    _, tc = _configs()
    model = get_model("FullyCNN")
    state = step.create_train_state(tc, model, torch.Generator().manual_seed(1), device="cpu")
    tstep = step.make_train_step(tc, model)
    state, _ = tstep(state, step.Batch(*(torch.as_tensor(a) for a in _waves(1))))
    mgr = ckpt.CheckpointManager(str(tmp_path), "run", max_to_keep=2)
    for epoch in range(4):
        mgr.save(epoch, state)
    assert mgr.latest_epoch() == 3
    assert sorted(os.listdir(tmp_path / "run")) == ["epoch_2.pt", "epoch_3.pt"]
    fresh = step.create_train_state(tc, model, torch.Generator().manual_seed(9), device="cpu")
    restored, epoch = mgr.restore(fresh)
    mgr.close()
    assert epoch == 3 and int(restored.step) == 1 == int(restored.opt_state.count)
    for name in state.params:
        for k in state.params[name]:
            assert torch.equal(restored.params[name][k], state.params[name][k])
            assert restored.params[name][k].requires_grad
            assert torch.equal(restored.opt_state.nu[name][k], state.opt_state.nu[name][k])
    for name in state.bn_state:
        assert torch.equal(restored.bn_state[name]["var"], state.bn_state[name]["var"])
    assert ckpt.CheckpointManager(str(tmp_path), "empty").restore(fresh) == (None, None)
    np.save(tmp_path / "x.npy", np.zeros(2))
    with pytest.raises(Exception):
        ckpt.read_checkpoint_file(str(tmp_path / "x.npy"))


def test_train_state_from_numpy_converts_layouts():
    params, bn = numpy_params("FullyCNN", seed=5)
    mu = jax.tree.map(lambda a: a + 1, params)
    nu = jax.tree.map(lambda a: a * a, params)
    ts = ckpt.train_state_from_numpy(params, bn, mu, nu, np.int32(7))
    assert int(ts.step) == 7 == int(ts.opt_state.count)
    w = params["encode_1"]["w"]
    np.testing.assert_array_equal(ts.params["encode_1"]["w"].detach().numpy(), w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ts.opt_state.mu["encode_1"]["w"].numpy(), (w + 1).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ts.opt_state.nu["decode_5"]["b"].numpy(), params["decode_5"]["b"] ** 2)
    np.testing.assert_array_equal(ts.bn_state["encode_8"]["var"].numpy(), bn["encode_8"]["var"])


def test_create_train_state_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    _, tc = _configs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        step.create_train_state(tc, get_model("FullyCNNV2"))
