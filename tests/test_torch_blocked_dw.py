"""The blocked dW contraction and its autograd Function, on the CPU: the
plain version against the JAX package's einsum reference and its Pallas
kernel in interpret mode, the Function's gradients against autograd of the
raw conv, and the kernel's launch plan.  The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

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


@pytest.mark.parametrize(
    "rows,nb,ci,co,kb",
    [(32768, 17, 200, 184, 4), (32768, 17, 80, 96, 4), (111, 17, 80, 96, 4), (1, 3, 8, 8, 1),
     (64 * 512, 129, 8, 80, 8)],
)
def test_launch_plan_covers_the_rows(rows, nb, ci, co, kb):
    stage, per_split, splits = blocked_dw.launch_plan(rows, nb, ci, co, kb, sm_count=132)
    assert 1 <= stage <= blocked_dw.MAX_STAGE_ROWS
    assert 4 * stage * (2 * nb + kb - 1) * blocked_dw.TILE <= max(
        blocked_dw.STAGE_SMEM_BYTES, 4 * (2 * nb + kb - 1) * blocked_dw.TILE
    )
    assert per_split % stage == 0
    # every split has rows, and together they cover all of them: the
    # kernel's own check on its arguments
    assert (splits - 1) * per_split < rows <= splits * per_split


def test_wrapper_rejects_other_devices_before_launching():
    z = torch.zeros(1, 2, 3, 8, device="meta")
    before = blocked_dw.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        blocked_dw.blocked_dw(z, z, 4, 2)
    assert blocked_dw.launches == before
