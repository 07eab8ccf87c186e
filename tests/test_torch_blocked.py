"""The port's training-mode forward and its freq-to-depth (blocked) form,
against the JAX package and the committed TF-semantics oracle fixture, on
the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu.models import blocked as j_blocked
from fullycnnspeechenhancement_tpu.models import blocks as j_blocks
from fullycnnspeechenhancement_tpu.models import get_model as j_get_model

from fullycnnspeechenhancement_torch.models import blocked, blocks, get_model
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy
from test_torch_cuda import NAMES, numpy_params, one_cpu_thread_per_worker  # noqa: F401

FIXTURE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fixtures", "parity_oracle.npz"
)
ORACLE_CASES = {"train": False, "train_masked": True}


def _frame_mask(rows, T, real):
    m = np.zeros((rows, T), np.float32)
    m[:, :real] = 1.0
    return m


def _close_state(got, ref, rtol, atol):
    assert sorted(got) == sorted(ref)
    for lname in ref:
        for k in ref[lname]:
            np.testing.assert_allclose(
                got[lname][k].numpy(), np.asarray(ref[lname][k]), rtol=rtol, atol=atol,
                err_msg=f"{lname}/{k}",
            )


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("is_training", [False, True], ids=["eval", "train"])
def test_apply_blocked_matches_jax(name, is_training):
    """Outputs and new BN state of the blocked forward, with the [1, T]
    batch-max mask, at the tolerances of tests/test_blocked.py."""
    params, bn = numpy_params(name, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 20, 129, 1)).astype(np.float32)
    fm = _frame_mask(1, 20, 15)
    fn = jax.jit(
        lambda p, s, x, m: j_blocked.apply_blocked(
            j_get_model(name), p, s, x, is_training=is_training, frame_mask=m, dw_pallas=True
        )
    )
    ref, ref_state = fn(params, bn, x, fm)
    tp, tb = params_from_numpy(params, bn)
    got, got_state = blocked.apply_blocked(
        get_model(name), tp, tb, torch.as_tensor(x), is_training=is_training,
        frame_mask=torch.as_tensor(fm), dw_pallas=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-4)
    _close_state(got_state, ref_state, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("rows", [1, 2], ids=["batchmax_mask", "per_utterance_mask"])
def test_training_apply_matches_jax(name, rows):
    """`ModelDef.apply` with training-mode BN against the JAX `apply`, with
    a [1, T] and a [B, T] frame mask."""
    params, bn = numpy_params(name, seed=3)
    x = np.random.default_rng(4).standard_normal((2, 14, 129, 1)).astype(np.float32)
    fm = _frame_mask(rows, 14, 9)
    if rows == 2:
        fm[1, 9:12] = 1.0
    fn = jax.jit(
        lambda p, s, x, m: j_get_model(name).apply(p, s, x, is_training=True, frame_mask=m)
    )
    ref, ref_state = fn(params, bn, x, fm)
    tp, tb = params_from_numpy(params, bn)
    got, got_state = get_model(name).apply(
        tp, tb, torch.as_tensor(x), is_training=True, frame_mask=torch.as_tensor(fm)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=1e-4)
    _close_state(got_state, ref_state, rtol=2e-4, atol=1e-6)


def _oracle_params(blobs, name):
    params, bn = {}, {}
    for key, v in blobs.items():
        parts = key.split("/")
        if parts[0] == name and parts[1] == "params":
            params.setdefault(parts[2], {})[parts[3]] = v
        elif parts[0] == name and parts[1] == "bn":
            bn.setdefault(parts[2], {})[parts[3]] = v
    return params_from_numpy(params, bn)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
@pytest.mark.parametrize("form", ["apply", "apply_blocked"])
def test_training_forward_matches_oracle_fixture(name, case, form):
    """The tolerances of tests/test_parity_oracle.py."""
    blobs = dict(np.load(FIXTURE))
    tp, tb = _oracle_params(blobs, name)
    x = torch.as_tensor(blobs["input"])
    fm = torch.as_tensor(blobs["frame_mask"]) if ORACLE_CASES[case] else None
    model = get_model(name)
    if form == "apply":
        y, new_bn = model.apply(tp, tb, x, is_training=True, frame_mask=fm)
    else:
        y, new_bn = blocked.apply_blocked(model, tp, tb, x, is_training=True, frame_mask=fm)
    ref = blobs[f"{name}/{case}/out"]
    np.testing.assert_allclose(
        y.numpy(), ref, rtol=2e-4, atol=2e-5 * max(np.abs(ref).max(), 1.0)
    )
    for lname in tb:
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                new_bn[lname][k].numpy(), blobs[f"{name}/{case}/new_bn/{lname}/{k}"],
                rtol=1e-4, atol=1e-6, err_msg=f"{lname}/{k}",
            )


def _f64(tree):
    return {n: {k: v.double() for k, v in d.items()} for n, d in tree.items()}


def test_blocked_matches_unblocked_exactly_in_f64():
    """Same math, only the reduction order differs: in float64 the outputs
    and every gradient agree to 1e-12 of their scale (the claim of
    tests/test_blocked.py::test_blocked_gradients_exact_f64), with the dW
    Function on."""
    model = get_model("FullyCNNV2")
    params, bn = params_from_numpy(*numpy_params("FullyCNNV2", seed=5))
    params, bn = _f64(params), _f64(bn)
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((2, 12, 129, 1)))
    tgt = torch.as_tensor(rng.standard_normal((2, 12, 129, 1)))
    fm = torch.as_tensor(_frame_mask(1, 12, 10)).double()
    outs, grads = [], []
    for form in ("apply", "blocked"):
        p = {n: {k: v.clone().requires_grad_() for k, v in d.items()} for n, d in params.items()}
        if form == "apply":
            y, _ = model.apply(p, bn, x, is_training=True, frame_mask=fm)
        else:
            y, _ = blocked.apply_blocked(model, p, bn, x, is_training=True, frame_mask=fm,
                                         dw_pallas=True)
        ((y - tgt) ** 2).sum().backward()
        outs.append(y.detach())
        grads.append({(n, k): v.grad for n, d in p.items() for k, v in d.items()})
    assert outs[0].dtype == torch.float64
    assert (outs[0] - outs[1]).abs().max().item() < 1e-12
    gscale = max(g.abs().max().item() for g in grads[0].values())
    worst = max((grads[0][k] - grads[1][k]).abs().max().item() for k in grads[0]) / gscale
    assert worst < 1e-12, worst


@pytest.mark.parametrize("kw,fb", [(5, 8), (7, 8), (11, 8), (13, 8), (9, 4), (8, 3)])
def test_block_index_map_and_weight_match_jax(kw, fb):
    J, dc = blocked._block_index_map(kw, fb)
    Jj, dcj = j_blocked._block_index_map(kw, fb)
    np.testing.assert_array_equal(J, Jj)
    assert dc == dcj
    w = np.random.default_rng(kw).standard_normal((1, kw, 3, 5)).astype(np.float32)
    ref, dc_ref = j_blocked._block_weight(jnp.asarray(w), fb)
    got, dc_got = blocked._block_weight(torch.as_tensor(w).permute(3, 2, 0, 1), fb)
    assert dc_got == dc_ref
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_block_weight_gradient_skips_the_sentinel():
    """The gather's backward is a scatter-add: each canonical tap receives
    the sum of its copies, and the sentinel's zero row passes nothing on."""
    kw, fb = 5, 8
    w = torch.randn(3, 2, 1, kw, generator=torch.Generator().manual_seed(0), requires_grad=True)
    wb, _ = blocked._block_weight(w, fb)
    wb.sum().backward()
    J, _ = blocked._block_index_map(kw, fb)
    copies = torch.as_tensor(np.bincount(J.reshape(-1), minlength=kw + 1)[:kw], dtype=w.dtype)
    torch.testing.assert_close(w.grad, copies.expand_as(w), rtol=0, atol=0)


def test_blocked_non129_freq_dim():
    """The blocked path handles any F (pads to a block multiple)."""
    model = get_model("FullyCNNV2")
    tp, tb = params_from_numpy(*numpy_params("FullyCNNV2", seed=7))
    x = torch.as_tensor(np.random.default_rng(8).standard_normal((1, 9, 65, 1)).astype(np.float32))
    ref, _ = model.apply(tp, tb, x)
    got, _ = blocked.apply_blocked(model, tp, tb, x, is_training=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=1e-5)


def test_training_block_matches_jax_block():
    """One conv+BN+skip+ReLU block in training mode with a [B, T] mask, and
    its new BN state."""
    rng = np.random.default_rng(9)
    p = {
        "w": rng.standard_normal((1, 7, 6, 5)).astype(np.float32),
        "b": rng.standard_normal(5).astype(np.float32),
        "gamma": rng.random(5).astype(np.float32) + 0.5,
        "beta": rng.standard_normal(5).astype(np.float32),
    }
    s = {"mean": rng.standard_normal(5).astype(np.float32), "var": rng.random(5).astype(np.float32) + 0.5}
    x = rng.standard_normal((2, 9, 129, 6)).astype(np.float32)
    skip = rng.standard_normal((2, 9, 129, 5)).astype(np.float32)
    fm = _frame_mask(2, 9, 6)
    ref, ref_s = j_blocks.conv_bn_relu_apply(
        p, s, x, kernel=(1, 7), is_training=True, skip_input=skip, frame_mask=fm
    )
    tp, ts = params_from_numpy({"l": p}, {"l": s})
    got, got_s = blocks.conv_bn_relu_apply(
        tp["l"], ts["l"], torch.as_tensor(x).permute(0, 3, 1, 2), is_training=True,
        skip_input=torch.as_tensor(skip).permute(0, 3, 1, 2), frame_mask=torch.as_tensor(fm),
    )
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(ref_s[k]), rtol=1e-5, atol=1e-6)
