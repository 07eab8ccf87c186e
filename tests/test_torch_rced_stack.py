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
from fullycnnspeechenhancement_torch.ops import build, rced_edges, rced_stack
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy
from test_torch_cuda import NAMES, assert_live, numpy_params, one_cpu_thread_per_worker  # noqa: F401


def _params(name, seed):
    """(JAX numpy params, JAX numpy BN, port params, port BN), with BN means
    centred so that every inner layer's ReLUs fire on inputs in [0, 1)."""
    params, bn = numpy_params(name, seed, centred_bn=True)
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
    and no two values that are live together share a row; the rows, at
    the kernel's stride, and the slack after them fit one block."""
    _, _, tp, tb = _params(name, seed=0)
    packed = rced_stack.pack_inference_stack(get_model(name), tp, tb)
    assert packed.smem_rows == rows
    assert packed.smem_floats == rows * rced_stack.ROW + rced_stack.SMEM_SLACK
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
    np.testing.assert_array_equal(packed.plan[:, 0], [lay.chunks for lay in packed.layers])
    np.testing.assert_array_equal(packed.plan[:, 1], [lay.n_tiles for lay in packed.layers])


# -- the kernel's arithmetic and memory layout, emulated -----------------------

ROW, HALO, F_DIM, M_PAD = rced_stack.ROW, rced_stack.HALO, rced_stack.F_DIM, rced_stack.M_PAD


def _writes(lay):
    """(shared-memory index, bin, channel) of every C element the kernel's
    epilogue stores for `lay`: all M_PAD x n_tiles * 8 elements pass its
    rule (bin < 129 and channel < cout)."""
    m, co = np.meshgrid(np.arange(M_PAD), np.arange(lay.n_tiles * 8), indexing="ij")
    keep = (m < F_DIM) & (co < lay.cout)
    m, co = m[keep], co[keep]
    return lay.out_row * ROW + co * ROW + HALO + m, m, co


def emulate_kernel(packed, x, passes=3):
    """The kernel in plain torch, frame by frame in a float32 image of one
    block's shared memory: A gathered through the offset table (K order
    and padding as the kernel reads them, indexing past the image raises),
    split by masking; B from the packed fragments; the float32 products
    small*big + big*small + big*big (passes=3), or big*big alone (passes=1,
    one-pass TF32); the epilogue's write rule.  Returns (output, the image
    after the stack)."""
    B, C, T, _ = x.shape
    n = B * T
    sm = torch.zeros(n, packed.smem_floats)
    data = HALO + torch.arange(F_DIM)
    rows_in = packed.in_row * ROW + torch.arange(C)[:, None] * ROW + data
    sm[:, rows_in] = x.permute(0, 2, 1, 3).reshape(n, C, F_DIM)
    m = torch.arange(M_PAD)
    for lay in packed.layers:
        koff = packed.koffs[lay.k_off : lay.k_off + lay.chunks * 8].long()
        a = sm[:, lay.in_row * ROW + koff[None, :] + m[:, None]]  # [n, M_PAD, K]
        a_big, a_small = rced_stack.split_tf32(a.contiguous())
        b_big, b_small = rced_stack.unpack_fragments(
            packed.weights[lay.w_off : lay.b_off], lay.chunks, lay.n_tiles)
        c = a_big @ b_big
        if passes == 3:
            c = a_small @ b_big + a_big @ b_small + c
        bias = packed.weights[lay.b_off : lay.b_off + lay.n_tiles * 8]
        idx, mm, co = (torch.as_tensor(v) for v in _writes(lay))
        y = c[:, mm, co] + bias[co]
        if lay.skip_row >= 0:
            y = y + sm[:, idx - (lay.out_row - lay.skip_row) * ROW]
        if lay.use_act:
            y = torch.relu(y)
        if lay.add_row >= 0:
            y = y + sm[:, idx - (lay.out_row - lay.add_row) * ROW]
        sm[:, idx] = y
    rows_out = packed.out_row * ROW + torch.arange(packed.c_out)[:, None] * ROW + data
    out = sm[:, rows_out].reshape(B, T, packed.c_out, F_DIM).permute(0, 2, 1, 3)
    return out, sm


def _fused_emulated(model, packed, mag, passes=3):
    """`fused_inference_forward` with the emulated kernel as its stack."""
    from fullycnnspeechenhancement_torch.models.blocks import conv2d_same

    y1 = torch.relu(conv2d_same(mag[:, None], *packed.first[1:])).contiguous()
    z, _ = emulate_kernel(packed, y1, passes)
    return conv2d_same(z, *packed.last[1:])[:, 0]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("T", [70, 45])
def test_emulated_kernel_matches_plain_and_jax(name, T):
    """The kernel's 3xTF32 arithmetic, K order, padding and write rule
    against its plain version and against JAX's fused forward in interpret
    mode, at the kernel test's tolerance; the halos, the gaps between rows
    and the slack stay zero."""
    jp, jb, tp, tb = _params(name, seed=1)
    model = get_model(name)
    packed = rced_stack.pack_inference_stack(model, tp, tb)
    mag = np.random.default_rng(T).random((2, T, 129)).astype(np.float32)
    y1 = rced_edges.first_plain(packed.edges, torch.as_tensor(mag))
    got, sm = emulate_kernel(packed, y1.contiguous())
    plain = rced_stack.stack_forward_plain(packed, y1)
    assert_live(plain)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-5)
    ref = np.asarray(j_fused(j_get_model(name), jp, jb, mag, t_tile=32))
    np.testing.assert_allclose(_fused_emulated(model, packed, torch.as_tensor(mag)).numpy(), ref,
                               rtol=1e-4, atol=1e-5)
    data = np.zeros(packed.smem_floats, bool)
    for r in range(packed.smem_rows):
        data[r * ROW + HALO : r * ROW + HALO + F_DIM] = True
    assert sm[:, torch.as_tensor(~data)].abs().max() == 0


def test_one_pass_tf32_misses_the_tolerance():
    """big*big alone (one-pass TF32) falls outside rtol 1e-4 / atol 1e-5
    on V2, so the kernel needs the split."""
    _, _, tp, tb = _params("FullyCNNV2", seed=1)
    packed = rced_stack.pack_inference_stack(get_model("FullyCNNV2"), tp, tb)
    x = torch.as_tensor(np.random.default_rng(3).random((2, packed.c_in, 45, 129)).astype(np.float32))
    ref = rced_stack.stack_forward_plain(packed, x)
    assert_live(ref)
    torch.testing.assert_close(emulate_kernel(packed, x)[0], ref, rtol=1e-4, atol=1e-5)
    with pytest.raises(AssertionError, match="not close"):
        torch.testing.assert_close(emulate_kernel(packed, x, passes=1)[0], ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_packed_weights_split_and_round_trip(name):
    """Each layer's big + small fragments give back its folded weights in
    the (tap, channel) K order within 2^-20 of their scale, big and small
    are TF32 values, and unpacking then packing the fragments returns them
    bit for bit; the biases follow, padded with zeros."""
    _, _, tp, tb = _params(name, seed=5)
    packed = rced_stack.pack_inference_stack(get_model(name), tp, tb)
    for lay, (w, b) in zip(packed.layers, packed.folded):
        frag = packed.weights[lay.w_off : lay.b_off]
        big, small = rced_stack.unpack_fragments(frag, lay.chunks, lay.n_tiles)
        want = torch.zeros(lay.chunks * 8, lay.n_tiles * 8)
        for j in range(lay.kw):
            want[j * lay.cin : (j + 1) * lay.cin, : lay.cout] = w[:, j]
        assert (big + small - want).abs().max() <= 2.0**-20 * want.abs().max()
        assert ((big.view(torch.int32) | small.view(torch.int32)) & 0x1FFF).max() == 0
        assert torch.equal(rced_stack.pack_fragments(big + small), frag)
        bias = packed.weights[lay.b_off : lay.b_off + lay.n_tiles * 8]
        assert torch.equal(bias[: lay.cout], b) and not bias[lay.cout :].any()


@pytest.mark.parametrize("name", NAMES)
def test_padded_rows_never_written(name):
    """The epilogue stores only bins 0..128 of channels below cout, each in
    its own output row's bins: no padded bin (129..143) or padded channel
    lands in a halo, a gap between rows, or another channel's row."""
    _, _, tp, tb = _params(name, seed=0)
    packed = rced_stack.pack_inference_stack(get_model(name), tp, tb)
    for lay in packed.layers:
        idx, m, co = _writes(lay)
        assert m.max() < F_DIM and co.max() < lay.cout and len(idx) == F_DIM * lay.cout
        row, pos = np.divmod(idx, ROW)
        np.testing.assert_array_equal(row, lay.out_row + co)
        assert ((pos >= HALO) & (pos < HALO + F_DIM)).all()


@pytest.mark.parametrize("name", NAMES)
def test_a_fragment_loads_avoid_bank_conflicts(name):
    """ROW leaves each row's 6 halo zeros on both sides and is 8 mod 32, so
    the four lanes t of an A fragment load whose k lie in one tap read
    4 x 8 distinct banks (lanes g add 0..7, a tile's m0 shifts all alike);
    loads whose k straddle two taps are at most 2-way, and the padded k
    repeat an address (a broadcast)."""
    assert ROW % 32 == 8 and ROW - F_DIM >= HALO + 1
    _, _, tp, tb = _params(name, seed=0)
    packed = rced_stack.pack_inference_stack(get_model(name), tp, tb)
    for lay in packed.layers:
        koff = packed.koffs[lay.k_off : lay.k_off + lay.chunks * 8].numpy() + lay.in_row * ROW
        for q in range(2 * lay.chunks):  # the quads k0 + t and k0 + t + 4
            k = 4 * q + np.arange(4)
            words = np.unique(koff[k][:, None] + np.arange(8)[None, :])  # a repeat is a broadcast
            degree = np.bincount(words % 32, minlength=32).max()
            taps = {kk // lay.cin for kk in k if kk < lay.k}
            if len(taps) == 1 and k[-1] < lay.k:
                assert degree == 1, (lay.name, q)
            assert degree <= 2, (lay.name, q)


def test_launch_plan_fills_the_card():
    """One block of 288 threads per frame; V2's 88 KB of shared memory a
    block lets 2 share an SM; the m16n8k8 tiles compute 1.386x the
    products V2's layers need (1.367x of all their taps, halo taps too)."""
    _, _, tp, tb = _params("FullyCNNV2", seed=0)
    packed = rced_stack.pack_inference_stack(get_model("FullyCNNV2"), tp, tb)
    plan = rced_stack.launch_plan(packed)
    assert (plan.threads, plan.blocks_per_sm, plan.frames_per_block) == (rced_stack.THREADS, 2, 1)
    assert plan.smem_bytes == packed.smem_floats * 4 == 88_208
    assert abs(plan.padded_product_ratio - 1.3862) < 1e-4
    assert rced_stack.launch_plan(packed, blocks_per_sm=1).blocks_per_sm == 1


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
