"""The port's V1/V2/V3 eval forward, init and npz bridge against the JAX
package and the committed TF-semantics oracle fixture, on the CPU."""

import os

import jax
import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu.models import blocks as j_blocks
from fullycnnspeechenhancement_tpu.models import get_model as j_get_model
from fullycnnspeechenhancement_tpu.train.checkpoint import (
    export_params_npz as j_export,
    import_reference_npz as j_import,
)

from fullycnnspeechenhancement_torch.models import blocks as t_blocks
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.train.checkpoint import (
    export_params_npz,
    import_reference_npz,
    params_from_numpy,
)
from test_torch_cuda import NAMES, numpy_params, one_cpu_thread_per_worker  # noqa: F401

FIXTURE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fixtures", "parity_oracle.npz"
)


@pytest.mark.parametrize(
    "name,count", [("FullyCNN", 32765), ("FullyCNNV2", 32192), ("FullyCNNV3", 32653)]
)
def test_param_count(name, count):
    model = get_model(name)
    assert model.param_count() == count == j_get_model(name).param_count()
    params, _ = model.init(torch.Generator().manual_seed(0))
    assert sum(v.numel() for p in params.values() for v in p.values()) == count


@pytest.mark.parametrize("name", NAMES)
def test_eval_apply_matches_oracle_fixture(name):
    blobs = dict(np.load(FIXTURE))
    params, bn = {}, {}
    for key, v in blobs.items():
        parts = key.split("/")
        if parts[0] == name and parts[1] == "params":
            params.setdefault(parts[2], {})[parts[3]] = v
        elif parts[0] == name and parts[1] == "bn":
            bn.setdefault(parts[2], {})[parts[3]] = v
    tp, tb = params_from_numpy(params, bn)
    y, _ = get_model(name).apply(tp, tb, torch.as_tensor(blobs["input"]))
    ref = blobs[f"{name}/eval/out"]
    scale = np.abs(ref).max()
    # the tolerance of tests/test_parity_oracle.py
    np.testing.assert_allclose(y.numpy(), ref, rtol=2e-4, atol=2e-5 * max(scale, 1.0))


@pytest.mark.parametrize("name", NAMES)
def test_eval_apply_matches_jax(name):
    params, bn = numpy_params(name, seed=0)
    x = np.random.default_rng(2).random((2, 12, 129, 1)).astype(np.float32)
    apply = jax.jit(lambda p, s, x: j_get_model(name).apply(p, s, x, is_training=False))
    ref, _ = apply(params, bn, x)
    ref = np.asarray(ref)
    tp, tb = params_from_numpy(params, bn)
    got, _ = get_model(name).apply(tp, tb, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5 * max(np.abs(ref).max(), 1.0))


def test_block_with_skip_matches_jax():
    rng = np.random.default_rng(3)
    p = {
        "w": rng.standard_normal((1, 7, 6, 5)).astype(np.float32),
        "b": rng.standard_normal(5).astype(np.float32),
        "gamma": rng.random(5).astype(np.float32) + 0.5,
        "beta": rng.standard_normal(5).astype(np.float32),
    }
    s = {"mean": rng.standard_normal(5).astype(np.float32), "var": rng.random(5).astype(np.float32) + 0.5}
    x = rng.standard_normal((2, 9, 129, 6)).astype(np.float32)
    skip = rng.standard_normal((2, 9, 129, 5)).astype(np.float32)
    ref, _ = j_blocks.conv_bn_relu_apply(p, s, x, kernel=(1, 7), is_training=False, skip_input=skip)
    tp, ts = params_from_numpy({"l": p}, {"l": s})
    got, new_state = t_blocks.conv_bn_relu_apply(
        tp["l"], ts["l"], torch.as_tensor(x).permute(0, 3, 1, 2),
        skip_input=torch.as_tensor(skip).permute(0, 3, 1, 2),
    )
    got = got.permute(0, 2, 3, 1)
    assert new_state is ts["l"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel", [(8, 11), (8, 13), (1, 7), (1, 129)])
def test_tf_same_pads_match_jax(kernel):
    assert t_blocks.tf_same_pads(kernel) == j_blocks.tf_same_pads(kernel)


def test_npz_bridge_round_trips_through_both_packages(tmp_path):
    params, bn = numpy_params("FullyCNN", seed=4)
    j_path, t_path = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_export(j_path, params, bn)
    model = get_model("FullyCNN")
    tp, tb = import_reference_npz(j_path, model)
    # V1's fifth encoder scope is encode_8, as in the reference
    assert tp["encode_8"]["w"].shape == (32, 24, 1, 7)
    np.testing.assert_array_equal(tp["encode_1"]["w"].numpy(), params["encode_1"]["w"].transpose(3, 2, 0, 1))
    export_params_npz(t_path, tp, tb)
    assert sorted(np.load(t_path).files) == sorted(np.load(j_path).files)
    p2, b2 = j_import(t_path, j_get_model("FullyCNN"))
    for name in params:
        for k in params[name]:
            np.testing.assert_array_equal(np.asarray(p2[name][k]), params[name][k])
    for name in bn:
        for k in bn[name]:
            np.testing.assert_array_equal(np.asarray(b2[name][k]), bn[name][k])


def test_glorot_init_is_seeded_and_bounded():
    model = get_model("FullyCNNV2")
    p1, s1 = model.init(torch.Generator().manual_seed(0))
    p2, _ = model.init(torch.Generator().manual_seed(0))
    p3, _ = model.init(torch.Generator().manual_seed(1))
    jp, _ = numpy_params("FullyCNNV2", seed=0)
    for spec in model.layers:
        w = p1[spec.name]["w"]
        kh, kw = spec.kernel
        assert w.shape == jp[spec.name]["w"].transpose(3, 2, 0, 1).shape
        limit = np.sqrt(6.0 / (kh * kw * (w.shape[1] + w.shape[0])))
        assert w.abs().max().item() <= limit and w.abs().max().item() > 0.5 * limit
        assert torch.equal(w, p2[spec.name]["w"]) and not torch.equal(w, p3[spec.name]["w"])
        assert torch.count_nonzero(p1[spec.name]["b"]) == 0
        if spec.use_norm:
            assert torch.all(p1[spec.name]["gamma"] == 1) and torch.all(s1[spec.name]["var"] == 1)


def test_training_mode_is_not_ported_yet():
    """The name is from when bf16 training raised; it is ported now (the
    raise is gone, tests/test_torch_bf16.py holds it to JAX): under
    `compute_dtype=bfloat16` `make_train_step` builds, and one step on a
    tiny batch runs the model in bf16 and leaves a finite float32 loss."""
    from fullycnnspeechenhancement_torch import Config, ModelConfig, TrainConfig
    from fullycnnspeechenhancement_torch.train.step import Batch, create_train_state, make_train_step

    config = Config(model=ModelConfig(compute_dtype="bfloat16"), train=TrainConfig(batch_size=1))
    model = get_model("FullyCNNV2")
    train_step = make_train_step(config, model)
    state = create_train_state(config, model, device="cpu")
    wav = torch.as_tensor(np.random.default_rng(0).standard_normal((1, 2000)).astype(np.float32))
    state, metrics = train_step(state, Batch(wav, 0.5 * wav, torch.tensor([2000], dtype=torch.int32)))
    assert metrics["loss"].dtype == torch.float32 and torch.isfinite(metrics["loss"])
    assert int(state.step) == 1


def test_unknown_net_work_falls_back_to_v1():
    assert get_model("nope").name == "FullyCNN" == j_get_model("nope").name
