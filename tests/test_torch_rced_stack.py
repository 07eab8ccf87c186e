"""The port's fused inner-stack path (ops/rced_stack.py) against the JAX
package's Pallas path, run on the CPU in interpret mode.  The CUDA kernel
itself is held against its plain version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu.models import get_model as j_get_model
from fullycnnspeechenhancement_tpu.ops import (
    fold_bn_inference as j_fold,
    fused_inference_forward as j_fused,
)

from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.models.rced import ConvSpec, ModelDef
from fullycnnspeechenhancement_torch.ops import build, rced_stack
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy
from test_torch_cuda import NAMES, numpy_params, one_cpu_thread_per_worker  # noqa: F401


def _params(name, seed):
    """(JAX numpy params, JAX numpy BN, port params, port BN)."""
    params, bn = numpy_params(name, seed)
    return (params, bn, *params_from_numpy(params, bn))


@pytest.mark.parametrize("name", NAMES)
def test_fold_bn_matches_jax(name):
    jp, jb, tp, tb = _params(name, seed=2)
    ref = j_fold(j_get_model(name), jp, jb)
    got = rced_stack.fold_bn_inference(get_model(name), tp, tb)
    for (jspec, jw, jbias), (spec, w, b) in zip(ref, got):
        assert jspec.name == spec.name
        np.testing.assert_allclose(w.permute(2, 3, 1, 0).numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(b.numpy(), np.asarray(jbias), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,T", [(n, 70) for n in NAMES] + [("FullyCNNV2", 45)])
def test_fused_forward_matches_jax(name, T):
    """T=45 is not a multiple of the JAX kernel's 32-frame tile."""
    jp, jb, tp, tb = _params(name, seed=0)
    mag = np.random.default_rng(1).random((2, T, 129)).astype(np.float32)
    ref = np.asarray(j_fused(j_get_model(name), jp, jb, mag, t_tile=32))
    got = rced_stack.fused_inference_forward(get_model(name), tp, tb, torch.as_tensor(mag))
    assert got.shape == (2, T, 129)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_fused_forward_matches_layer_by_layer(name):
    _, _, tp, tb = _params(name, seed=4)
    model = get_model(name)
    mag = torch.as_tensor(np.random.default_rng(6).random((1, 33, 129)).astype(np.float32))
    ref, _ = model.apply(tp, tb, mag[..., None])
    got = rced_stack.fused_inference_forward(model, tp, tb, mag)
    np.testing.assert_allclose(got.numpy(), ref[..., 0].numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,rows", [("FullyCNN", 128), ("FullyCNNV2", 162), ("FullyCNNV3", 72)])
def test_shared_memory_rows_never_alias_live_values(name, rows):
    """Every value a layer reads keeps its rows until after that layer,
    and no two values that are live together share a row."""
    _, _, tp, tb = _params(name, seed=0)
    packed = rced_stack.pack_inference_stack(get_model(name), tp, tb)
    assert packed.smem_rows == rows
    assert packed.smem_floats * 4 <= rced_stack.SMEM_BYTES
    span = {rced_stack.INPUT: (packed.in_row, packed.c_in, -1)}
    reads = {rced_stack.INPUT: 0}
    prev = rced_stack.INPUT
    for i, lay in enumerate(packed.layers):
        span[lay.name] = (lay.out_row, lay.cout, i)
        reads[prev] = max(reads.get(prev, i), i)
        for ref in (lay.skip_from, lay.add_from):
            if ref is not None:
                reads[ref] = max(reads[ref], i)
        prev = lay.name
    reads[prev] = len(packed.layers)
    for a, (ra, na, da) in span.items():
        for b, (rb, nb, db) in span.items():
            if a < b and max(da, db) <= min(reads[a], reads[b]):
                assert ra + na <= rb or rb + nb <= ra, (a, b)
    assert packed.layers[0].in_row == packed.in_row
    for i, lay in enumerate(packed.layers[1:], start=1):
        assert lay.in_row == packed.layers[i - 1].out_row
    np.testing.assert_array_equal(packed.plan[:, 0], [lay.kw for lay in packed.layers])


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    _, _, tp, tb = _params("FullyCNNV2", seed=0)
    packed = rced_stack.pack_inference_stack(get_model("FullyCNNV2"), tp, tb)
    x = torch.rand(1, packed.c_in, 5, 129)
    before = rced_stack.launches
    torch.testing.assert_close(
        rced_stack.stack_forward(packed, x), rced_stack.stack_forward_plain(packed, x), rtol=0, atol=0
    )
    assert rced_stack.launches == before


def test_wrapper_rejects_other_devices():
    _, _, tp, tb = _params("FullyCNNV3", seed=0)
    packed = rced_stack.pack_inference_stack(get_model("FullyCNNV3"), tp, tb)
    with pytest.raises(ValueError, match="cpu or cuda"):
        rced_stack.stack_forward(packed, torch.empty(1, packed.c_in, 3, 129, device="meta"))


def test_pack_rejects_inner_layer_with_time_extent():
    model = ModelDef(
        "bad",
        (
            ConvSpec("a", 4, (8, 5)),
            ConvSpec("b", 4, (2, 5)),
            ConvSpec("c", 1, (1, 129), use_norm=False, use_act=False),
        ),
    )
    params, bn = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="inner layer b"):
        rced_stack.pack_inference_stack(model, params, bn)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
