"""The blocked dW contraction and its autograd Function, on the CPU: the
plain version against the JAX package's einsum reference and its Pallas
kernel in interpret mode, the Function's gradients against autograd of the
raw conv, the kernel's launch plan, and its staged layout and 3xTF32
arithmetic emulated in torch.  The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu.ops.pallas_dw import blocked_dw_pallas, blocked_dw_reference

from fullycnnspeechenhancement_torch.models import blocked, get_model
from fullycnnspeechenhancement_torch.ops import blocked_dw
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401


@pytest.mark.parametrize("rows_shape", [(4, 8), (8, 33)], ids=["rows32", "rows264"])
def test_plain_matches_jax_reference_and_interpret_kernel(rows_shape):
    """(8, 33) leaves a partial final 128-row tile in the Pallas kernel.
    The tolerances of tests/test_pallas_dw.py: f32 sums in another order,
    entries up to ~|90|."""
    B, T = rows_shape
    NB, CI, CO, kb, dc = 17, 16, 24, 4, 2
    rng = np.random.default_rng(2)
    z = rng.standard_normal((B, T, NB, CI)).astype(np.float32)
    dy = rng.standard_normal((B, T, NB, CO)).astype(np.float32)
    want = np.asarray(blocked_dw_reference(jnp.asarray(z), jnp.asarray(dy), kb, dc))
    interp = np.asarray(blocked_dw_pallas(jnp.asarray(z), jnp.asarray(dy), kb, dc, interpret=True))
    before = blocked_dw.launches
    got = blocked_dw.blocked_dw(torch.as_tensor(z), torch.as_tensor(dy), kb, dc)
    assert blocked_dw.launches == before  # the CPU path launches nothing
    assert got.shape == (1, kb, CI, CO) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=5e-4)
    np.testing.assert_allclose(got.numpy(), interp.reshape(want.shape), rtol=1e-5, atol=5e-4)


def test_plain_is_exact_in_f64():
    rng = np.random.default_rng(3)
    z = torch.as_tensor(rng.standard_normal((2, 5, 7, 6)))
    dy = torch.as_tensor(rng.standard_normal((2, 5, 7, 4)))
    got = blocked_dw.blocked_dw_plain(z, dy, 5, 2)
    assert got.dtype == torch.float64
    # the definition, term by term
    zp = np.pad(z.numpy(), ((0, 0), (0, 0), (2, 2), (0, 0)))
    want = np.stack([
        np.einsum("btnc,btno->co", zp[:, :, d : d + 7], dy.numpy()) for d in range(5)
    ])[None]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("kb,dc", [(4, 2), (6, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_function_gradients_match_autograd(kb, dc, dtype):
    """`blocked_freq_conv` (transposed-conv dX, `blocked_dw` dW) against
    autograd of the raw conv; tolerances of tests/test_pallas_dw.py."""
    rng = np.random.default_rng(0)
    B, T, NB, CI, CO = 2, 9, 5, 24, 16
    z0 = torch.as_tensor(rng.standard_normal((B, T, NB, CI)), dtype=dtype)
    w0 = torch.as_tensor(rng.standard_normal((1, kb, CI, CO)) * 0.1, dtype=dtype)
    g = torch.as_tensor(rng.standard_normal((B, T, NB, CO)), dtype=dtype)
    results = []
    for fn in (
        lambda z, w: blocked_dw.blocked_freq_conv(z, w, dc),
        lambda z, w: blocked_dw.conv_nhwc(z, w, ((0, 0), (dc, kb - 1 - dc))),
    ):
        z, w = z0.clone().requires_grad_(), w0.clone().requires_grad_()
        loss = (fn(z, w) * g).sum()
        loss.backward()
        results.append((loss.detach(), z.grad, w.grad))
    (lc, dzc, dwc), (lr, dzr, dwr) = results
    assert dzc.dtype == dwc.dtype == dtype
    if dtype == torch.float64:
        tol = dict(rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(dzc, dzr, **tol)
        torch.testing.assert_close(dwc, dwr, **tol)
    else:
        torch.testing.assert_close(lc, lr, rtol=1e-6, atol=0)
        torch.testing.assert_close(dzc, dzr, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dwc, dwr, rtol=1e-5, atol=1e-4)


def test_blocked_model_grads_unchanged_by_the_function():
    """apply_blocked with `dw_pallas` (the Function) gives the gradients of
    the same blocked forward under plain autograd, normalised by the global
    gradient scale (tests/test_pallas_dw.py's check)."""
    model = get_model("FullyCNNV2")
    params, bn = params_from_numpy(*numpy_params("FullyCNNV2", seed=0))
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 12, 129, 1)).astype(np.float32))
    grads = []
    for dw_pallas in (True, False):
        p = {n: {k: v.clone().requires_grad_() for k, v in d.items()} for n, d in params.items()}
        y, _ = blocked.apply_blocked(model, p, bn, x, is_training=True, dw_pallas=dw_pallas)
        torch.square(y).sum().backward()
        grads.append({(n, k): v.grad for n, d in p.items() for k, v in d.items()})
    gscale = max(g.abs().max().item() for g in grads[1].values())
    for key in grads[1]:
        np.testing.assert_allclose(
            grads[0][key].numpy() / gscale, grads[1][key].numpy() / gscale,
            rtol=1e-5, atol=1e-6, err_msg=str(key),
        )


# V2's 14 inner layers in blocked form at fb 8: (Ci, Co) = 8 x its channels
V2_DW_SHAPES = [(80, 96), (96, 112), (112, 120), (120, 152), (152, 168), (168, 184), (184, 200),
                (200, 184), (184, 168), (168, 152), (152, 120), (120, 112), (112, 96), (96, 80)]
# The products the kernel's 32 x 32 tiles compute over V2's 14 layers,
# against the sum of Ci * Co they need (286,720).
V2_PADDED_RATIO = 1.179


@pytest.mark.parametrize(
    "rows,nb,ci,co,kb",
    [(32768, 17, 200, 184, 4), (32768, 17, 80, 96, 4), (111, 17, 80, 96, 4), (1, 3, 8, 8, 1),
     (64 * 512, 129, 8, 80, 8)],
)
def test_launch_plan_covers_the_rows(rows, nb, ci, co, kb):
    plan = blocked_dw.launch_plan(rows, nb, ci, co, kb, sm_count=132)
    tile = blocked_dw.TILE
    assert plan.tiles == -(-ci // tile) * -(-co // tile)
    # a stage is whole k8 chunks of the flat K index, and two fit a block
    assert plan.stage_rows * (nb + kb - 1) % 8 == 0
    assert plan.smem_bytes == blocked_dw.smem_bytes(plan.stage_rows, nb, kb) <= blocked_dw.SMEM_BYTES
    assert plan.blocks_per_sm == blocked_dw.model_blocks_per_sm(kb, plan.smem_bytes) >= 1
    assert plan.rows_per_split % plan.stage_rows == 0
    # every split has rows, and together they cover all of them: the
    # kernel's own check on its arguments
    assert (plan.splits - 1) * plan.rows_per_split < rows <= plan.splits * plan.rows_per_split
    if rows >= 32768:
        # whole waves: the blocks fill at least 95% of their waves' slots
        slots = 132 * plan.blocks_per_sm
        waves = -(-plan.tiles * plan.splits // slots)
        assert plan.tiles * plan.splits >= 0.95 * waves * slots
    if (ci, co) in V2_DW_SHAPES:
        padded = sum(-(-i // tile) * -(-o // tile) * tile * tile for i, o in V2_DW_SHAPES)
        assert padded <= V2_PADDED_RATIO * sum(i * o for i, o in V2_DW_SHAPES)


def tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """float32 `x` cut to TF32's 10 mantissa bits, still as float32: "rna"
    to nearest with ties away from zero (PTX cvt.rna.tf32.f32, as TF32
    convs round), "rz" toward zero (the low 13 bits cleared, as the kernel
    splits)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def staged_dw(z, dy, kb, dc, passes):
    """dW [KB, Ci, Co] as the kernel stages and multiplies it: dy with row
    stride nbp = NB + KB - 1 (zeros after its NB blocks), z shifted by dc
    in the same stride with KB - 1 zero positions after the last row, and
    tap d as dy^T times z at p + d over one flat K index.  passes 0
    multiplies the float32 values; 1 their TF32 roundings (one-pass TF32);
    3 the kernel's 3xTF32 split, big = rz(x) and small = rz(x - big),
    as small_a big_b + big_a small_b + big_a big_b.  Products and sums in
    float64."""
    rows, nb, ci = z.shape
    nbp = nb + kb - 1
    zs = torch.zeros(rows, nbp, ci)
    zs[:, dc : dc + nb] = z
    zs = torch.cat([zs.reshape(rows * nbp, ci), torch.zeros(kb - 1, ci)])
    ds = torch.zeros(rows, nbp, dy.shape[2])
    ds[:, :nb] = dy
    ds = ds.reshape(rows * nbp, -1)

    def mm(a, b):
        return a.double().T @ b.double()

    taps = []
    for d in range(kb):
        b = zs[d : d + rows * nbp]
        if passes == 0:
            taps.append(mm(ds, b))
        elif passes == 1:
            taps.append(mm(tf32(ds, "rna"), tf32(b, "rna")))
        else:
            a_big, b_big = tf32(ds, "rz"), tf32(b, "rz")
            a_small, b_small = tf32(ds - a_big, "rz"), tf32(b - b_big, "rz")
            taps.append(mm(a_small, b_big) + mm(a_big, b_small) + mm(a_big, b_big))
    return torch.stack(taps).transpose(1, 2)


@pytest.mark.parametrize("kb", range(1, blocked_dw.MAX_KB + 1))
def test_staged_3xtf32_matches_plain_within_dw_tol(kb):
    """The kernel's staged layout and 3xTF32 split, emulated in torch at
    300 rows, against `blocked_dw_plain` in float64 for every dc: the
    layout alone is exact; 3xTF32 lands within chip_smoke.py's DW_TOL
    (rtol 1e-4, atol 1e-4 * max|plain|) with room to spare, measured at
    1.8e-3 to 2.6e-3 of it; one-pass TF32 (about 3 digits) lands outside,
    measured at 2.1x to 3.1x of it, which is why the kernel takes three
    products."""
    rng = np.random.default_rng(kb)
    z = torch.as_tensor(rng.standard_normal((300, 17, 24)).astype(np.float32))
    dy = torch.as_tensor(rng.standard_normal((300, 17, 16)).astype(np.float32))
    for dc in range(kb):
        ref = blocked_dw.blocked_dw_plain(z.double()[None], dy.double()[None], kb, dc)[0]
        tol = 1e-4 * ref.abs() + 1e-4 * ref.abs().max()
        torch.testing.assert_close(staged_dw(z, dy, kb, dc, 0), ref, rtol=1e-12, atol=1e-12)
        err3 = ((staged_dw(z, dy, kb, dc, 3) - ref).abs() / tol).max().item()
        err1 = ((staged_dw(z, dy, kb, dc, 1) - ref).abs() / tol).max().item()
        assert err3 < 1e-2, (dc, err3)
        assert err1 > 1.0, (dc, err1)


@pytest.mark.parametrize("kb", range(1, blocked_dw.MAX_KB + 1))
def test_staged_3xtf32_is_exact_on_bf16_values(kb):
    """The route of a bf16 pair the wgmma kernel does not take (Ci 20, Co
    14): the 3xTF32 kernel on float32 copies.  A bf16 value is its own
    TF32 big part, so every small part is zero and the 3xTF32 staging
    equals the float32 values' products bit for bit in float64, within
    1e-12 of `blocked_dw_plain` in float64, for every dc."""
    rng = np.random.default_rng(10 + kb)
    z = torch.as_tensor(rng.standard_normal((300, 17, 20)).astype(np.float32)).to(torch.bfloat16)
    dy = torch.as_tensor(rng.standard_normal((300, 17, 14)).astype(np.float32)).to(torch.bfloat16)
    assert not blocked_dw.takes_wgmma(z[None], dy[None], kb)
    z32, dy32 = z.float(), dy.float()
    for x in (z32, dy32):
        assert not tf32(x - tf32(x, "rz"), "rz").any()
    for dc in range(kb):
        ref = blocked_dw.blocked_dw_plain(z.double()[None], dy.double()[None], kb, dc)[0]
        exact = staged_dw(z32, dy32, kb, dc, 0)
        assert torch.equal(staged_dw(z32, dy32, kb, dc, 3), exact)
        torch.testing.assert_close(exact, ref, rtol=1e-12, atol=1e-12)


def test_wrapper_rejects_other_devices_before_launching():
    z = torch.zeros(1, 2, 3, 8, device="meta")
    before = blocked_dw.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        blocked_dw.blocked_dw(z, z, 4, 2)
    assert blocked_dw.launches == before
