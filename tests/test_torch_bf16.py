"""The port's bf16 compute path against the JAX package's, on the CPU.

The two packages round to bf16 at different points: XLA fuses elementwise
chains and rounds at fusion boundaries, torch after every op.  So their
whole-model bf16 results differ from each other about as much as either
differs from float32, and no float32-style tolerance holds between them.
These tests hold exact what can be exact (the fused stack's bf16 mode
where both round the same operands, the dW contraction, where dW is
rounded, the dtypes of the state) and hold whole models and train steps
to the JAX package's own bf16 error budget: the port's distance from a
float64 result at most BUDGET times JAX bf16's, plus BUDGET_ATOL of the
result's scale.  `-s` prints each measured distance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu.models import apply_blocked as j_apply_blocked
from fullycnnspeechenhancement_tpu.models import blocks as j_blocks
from fullycnnspeechenhancement_tpu.models import get_model as j_get_model
from fullycnnspeechenhancement_tpu.models.rced import ConvSpec as JConvSpec, ModelDef as JModelDef
from fullycnnspeechenhancement_tpu.ops import fused_inference_forward as j_fused
from fullycnnspeechenhancement_tpu.ops.pallas_dw import blocked_dw_pallas, blocked_dw_reference
from fullycnnspeechenhancement_tpu.train import step as j_step

from fullycnnspeechenhancement_torch.dsp.features import SpectrogramExtractor
from fullycnnspeechenhancement_torch.models import blocks as t_blocks
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.models.blocked import apply_blocked
from fullycnnspeechenhancement_torch.ops import blocked_dw, rced_stack
from fullycnnspeechenhancement_torch.train import step
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy
from test_torch_cuda import (  # noqa: F401
    NAMES,
    ONE_LAYER_CASES,
    assert_bf16_stack_close,
    assert_live,
    numpy_params,
    one_cpu_thread_per_worker,
    one_layer_model,
)
from test_torch_train import _batches, _configs, _jax_state, _port_state, _waves, flat_leaves

BF16 = torch.bfloat16
BUDGET = 1.5  # the port's distance from float64 against JAX bf16's
BUDGET_ATOL = 1e-3  # of the float64 result's scale


def _dist(got, ref) -> float:
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max())


def assert_within_budget(what, port, jax_bf16, ref64):
    """max|port - ref64| <= BUDGET * max|jax - ref64| + BUDGET_ATOL * max|ref64|,
    with ref64 a float64 result (a float32 one for the eval step)."""
    scale = float(np.abs(np.asarray(ref64)).max())
    d_port, d_jax = _dist(port, ref64), _dist(jax_bf16, ref64)
    print(f"{what}: port bf16 {d_port / scale:.3e}, JAX bf16 {d_jax / scale:.3e} of max|ref| {scale:.3e}")
    assert d_port <= BUDGET * d_jax + BUDGET_ATOL * scale, (what, d_port, d_jax, scale)


def _f64(tree):
    return {n: {k: v.double() for k, v in d.items()} for n, d in tree.items()}


# -- one block --------------------------------------------------------------

# One conv + BN + skip + ReLU block in bf16, the port against JAX (x
# [2, 9, 129, 6], kernel (1, 7), 5 channels).  Measured on the CPU: 1.075e-2
# of max|ref| apart at inference and 5.128e-3 in training, one to three
# bf16 ulps of max|ref|, from where each package rounds (torch rounds the
# conv and its bias once, JAX the conv and then the bias add; torch rounds
# after the scale and again after the shift, XLA once after both).
BLOCK_TOL = 2.0**-6


@pytest.mark.parametrize("is_training", [False, True], ids=["eval", "train"])
def test_block_bf16_matches_jax(is_training):
    """Params and BN state stay float32, the activations bf16; training
    mode takes the moments in float32 from the bf16 conv output; the
    result within BLOCK_TOL of max|JAX's|."""
    rng = np.random.default_rng(3)
    p = {
        "w": (0.3 * rng.standard_normal((1, 7, 6, 5))).astype(np.float32),
        "b": rng.standard_normal(5).astype(np.float32),
        "gamma": rng.random(5).astype(np.float32) + 0.5,
        "beta": rng.standard_normal(5).astype(np.float32),
    }
    s = {"mean": rng.standard_normal(5).astype(np.float32), "var": rng.random(5).astype(np.float32) + 0.5}
    x = rng.standard_normal((2, 9, 129, 6)).astype(np.float32)
    skip = rng.standard_normal((2, 9, 129, 5)).astype(np.float32)
    jx, jskip = jnp.asarray(x, jnp.bfloat16), jnp.asarray(skip, jnp.bfloat16)
    ref, jstate = j_blocks.conv_bn_relu_apply(p, s, jx, kernel=(1, 7), is_training=is_training,
                                              skip_input=jskip)
    tp, ts = params_from_numpy({"l": p}, {"l": s})
    got, state = t_blocks.conv_bn_relu_apply(
        tp["l"], ts["l"], torch.as_tensor(x).to(BF16).permute(0, 3, 1, 2),
        is_training=is_training, skip_input=torch.as_tensor(skip).to(BF16).permute(0, 3, 1, 2),
    )
    assert got.dtype == BF16 and all(v.dtype == torch.float32 for v in state.values())
    got = got.float().permute(0, 2, 3, 1).numpy()
    ref = np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    print(f"block bf16 ({'train' if is_training else 'eval'}): {_dist(got, ref) / scale:.3e} of max|JAX|")
    assert _dist(got, ref) <= BLOCK_TOL * scale
    for k in ("mean", "var"):
        # float32 moments of the two packages' bf16 conv outputs
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]), rtol=2e-2, atol=2e-3)


def test_masked_moments_of_bf16_are_float32():
    """BN's batch moments of a bf16 conv output are taken in float32: equal
    to the moments of the same values held in float32."""
    y = torch.randn(2, 5, 7, 129, generator=torch.Generator().manual_seed(0)).to(BF16)
    mask = torch.tensor([[1.0] * 5 + [0.0] * 2])
    for m in (None, mask):
        mean, var = t_blocks.masked_moments(y, m)
        mean32, var32 = t_blocks.masked_moments(y.float(), m)
        assert mean.dtype == var.dtype == torch.float32
        assert torch.equal(mean, mean32) and torch.equal(var, var32)


# -- whole models, eval -------------------------------------------------------


@pytest.mark.parametrize("form", ["apply", "blocked"])
@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_bf16_within_jax_budget(name, form):
    """`model.apply` and `apply_blocked` on a bf16 input: the output in
    bf16, and its distance from the float64 forward within the budget of
    JAX bf16's distance."""
    params, bn = numpy_params(name, seed=0)
    x = np.random.default_rng(2).random((1, 24, 129, 1)).astype(np.float32)
    jm = j_get_model(name)
    j_forward = jm.apply if form == "apply" else functools.partial(j_apply_blocked, jm)
    jy, _ = jax.jit(lambda p, s, x: j_forward(p, s, x, is_training=False))(
        params, bn, jnp.asarray(x, jnp.bfloat16))
    model = get_model(name)
    forward = model.apply if form == "apply" else functools.partial(apply_blocked, model)
    tp, tb = params_from_numpy(params, bn)
    y, _ = forward(tp, tb, torch.as_tensor(x).to(BF16), is_training=False)
    assert y.dtype == BF16
    y64, _ = forward(_f64(tp), _f64(tb), torch.as_tensor(x).double(), is_training=False)
    assert_within_budget(f"{name} {form} eval", y.float().numpy(), np.asarray(jy, np.float32), y64.numpy())


# -- the fused stack's bf16 mode ----------------------------------------------


def dyadic_params(model, seed):
    """(params, bn_state) of `model` as the JAX package holds them (HWIO),
    with every value a multiple of 2^-6 of few bits and var + 1e-3 exactly
    1 in float32, so that BN folding and layer 1's float32 conv on inputs
    that are multiples of 2^-6 in [0, 1) are exact in any order of
    summation: both packages then round the same values to bf16."""
    rng = np.random.default_rng(seed)
    var = np.float32(1.0) - np.float32(1e-3)
    assert var + np.float32(1e-3) == np.float32(1.0)
    dy = lambda *shape: (rng.integers(-32, 32, shape) / 64).astype(np.float32)  # noqa: E731
    params, bn, ch = {}, {}, 1
    for spec in model.layers:
        kh, kw = spec.kernel
        params[spec.name] = {"w": dy(kh, kw, ch, spec.out_ch), "b": dy(spec.out_ch)}
        if spec.use_norm:
            params[spec.name]["gamma"] = (1 + rng.integers(-4, 5, spec.out_ch) / 8).astype(np.float32)
            params[spec.name]["beta"] = dy(spec.out_ch)
            bn[spec.name] = {"mean": dy(spec.out_ch), "var": np.full(spec.out_ch, var, np.float32)}
        ch = spec.out_ch
    return params, bn


def _exact_fold_bn(bn, seed):
    """`bn` with each var replaced by 4^j - 1e-3 (j in -1, 0, 1), so that var
    + 1e-3 is 4^j exactly in float32 and BN folds to the same float32
    weights in both packages (their rsqrt differ in the last bit
    elsewhere, which can round a folded weight to the next bf16
    value)."""
    rng = np.random.default_rng(seed)
    eps = np.float32(1e-3)
    choices = np.asarray([np.float32(4.0**j) - eps for j in (-1, 0, 1)], np.float32)
    assert all(c + eps == np.float32(4.0**j) for c, j in zip(choices, (-1, 0, 1)))
    return {k: {"mean": v["mean"], "var": choices[rng.integers(0, 3, v["var"].shape)]} for k, v in bn.items()}


@pytest.mark.parametrize("name", NAMES)
def test_fused_bf16_mode_matches_jax(name):
    """`fused_inference_forward(dtype="bfloat16")` (plain bf16 stack) against
    JAX's in interpret mode at (1, 40, 129), centred BN: both round the
    same folded weights and, up to float32 summation order, the same
    activations (see BF16_STACK_*); both within 0.05 * max of the float32
    forward (tests/test_pallas.py::test_fused_bfloat16_mode_close)."""
    params, bn = numpy_params(name, seed=6, centred_bn=True)
    bn = _exact_fold_bn(bn, seed=7)
    mag = np.random.default_rng(8).random((1, 40, 129)).astype(np.float32)
    ref = np.asarray(j_fused(j_get_model(name), params, bn, mag, t_tile=32, dtype="bfloat16"))
    f32 = np.asarray(j_fused(j_get_model(name), params, bn, mag, t_tile=32))
    tp, tb = params_from_numpy(params, bn)
    got = rced_stack.fused_inference_forward(get_model(name), tp, tb, torch.as_tensor(mag), dtype="bfloat16")
    assert got.dtype == torch.float32
    assert_bf16_stack_close(got, ref)
    scale = np.abs(f32).max()
    print(f"{name} fused bf16: port {_dist(got, f32) / scale:.3e}, JAX {_dist(ref, f32) / scale:.3e}, "
          f"port vs JAX {_dist(got, ref) / scale:.3e} of max|f32|")
    assert _dist(got, f32) < 0.05 * scale and _dist(ref, f32) < 0.05 * scale


@pytest.mark.parametrize("case", ONE_LAYER_CASES, ids=lambda c: "_".join(map(str, c)))
def test_fused_bf16_one_layer_matches_jax(case):
    """A single inner layer on multiples of 2^-6: layer 1 and BN folding are
    exact in both packages, so both round the same input and weights to
    bf16, the products are exact and only float32 sums differ in order:
    rtol 1e-4, atol 1e-5 * max|JAX|."""
    kw, cin, cout, link = case
    model = one_layer_model(*case)
    jmodel = JModelDef(model.name, tuple(
        JConvSpec(s.name, s.out_ch, s.kernel, s.use_norm, s.use_act, s.skip_from, s.add_from)
        for s in model.layers))
    params, bn = dyadic_params(model, seed=kw)
    mag = (np.random.default_rng(cout).integers(0, 64, (2, 45, 129)) / 64).astype(np.float32)
    ref = np.asarray(j_fused(jmodel, params, bn, mag, t_tile=32, dtype="bfloat16"))
    tp, tb = params_from_numpy(params, bn)
    got = rced_stack.fused_inference_forward(model, tp, tb, torch.as_tensor(mag), dtype="bfloat16")
    assert_live(torch.as_tensor(ref))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_fused_bf16_rejects_a_pack_of_the_other_mode():
    params, bn = params_from_numpy(*numpy_params("FullyCNNV2", seed=0))
    model = get_model("FullyCNNV2")
    packed = rced_stack.pack_inference_stack(model, params, bn)
    with pytest.raises(ValueError, match="packed for float32"):
        rced_stack.fused_inference_forward(model, params, bn, torch.rand(1, 5, 129), packed=packed,
                                           dtype="bfloat16")
    with pytest.raises(ValueError, match="dtype 'float16'"):
        rced_stack.pack_inference_stack(model, params, bn, "float16")


# -- dW ------------------------------------------------------------------------


@pytest.mark.parametrize("rows_shape", [(4, 8), (8, 33)], ids=["rows32", "rows264"])
def test_blocked_dw_plain_bf16_matches_jax(rows_shape):
    """bf16 z and dy: the plain dW, JAX's einsum reference and its Pallas
    kernel in interpret mode all promote to float32, so every product is
    exact and only the order of float32 sums differs: rtol 1e-5, atol 1e-6
    * max|ref|."""
    B, T = rows_shape
    NB, CI, CO, kb, dc = 17, 16, 24, 4, 2
    rng = np.random.default_rng(2)
    z = jnp.asarray(rng.standard_normal((B, T, NB, CI)), jnp.bfloat16)
    dy = jnp.asarray(rng.standard_normal((B, T, NB, CO)), jnp.bfloat16)
    want = np.asarray(blocked_dw_reference(z, dy, kb, dc))
    interp = np.asarray(blocked_dw_pallas(z, dy, kb, dc, interpret=True)).reshape(want.shape)
    tz = torch.as_tensor(np.asarray(z, np.float32)).to(BF16)
    tdy = torch.as_tensor(np.asarray(dy, np.float32)).to(BF16)
    before = blocked_dw.launches_bf16
    got = blocked_dw.blocked_dw(tz, tdy, kb, dc)
    assert blocked_dw.launches_bf16 == before  # the CPU path launches nothing
    assert got.dtype == torch.float32 and want.dtype == np.float32
    for ref in (want, interp):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_blocked_freq_conv_rounds_dw_to_bf16():
    """Under bf16 the Function's dW is `blocked_dw_plain(z, dy)` rounded to
    bf16, where JAX rounds it (`dw.astype(wb.dtype)`), and the cast that
    made the bf16 weight lifts it back to float32 exactly."""
    g = torch.Generator().manual_seed(1)
    z0 = torch.randn(2, 9, 5, 24, generator=g).to(BF16)
    dy = torch.randn(2, 9, 5, 16, generator=g).to(BF16)
    w = (0.1 * torch.randn(1, 4, 24, 16, generator=g)).requires_grad_()
    z = z0.clone().requires_grad_()
    y = blocked_dw.blocked_freq_conv(z, w.to(BF16), 2)
    assert y.dtype == BF16
    y.backward(dy)
    assert w.grad.dtype == torch.float32 and z.grad.dtype == BF16
    want = blocked_dw.blocked_dw_plain(z0, dy, 4, 2).to(BF16).float()
    assert torch.equal(w.grad, want)
    assert not torch.equal(w.grad, blocked_dw.blocked_dw_plain(z0, dy, 4, 2))  # it was rounded


# -- the train step --------------------------------------------------------------

TRAIN_CASES = {
    "plain": {},
    "blocked": {"blocked_compute": True},
    "blocked_dw": {"blocked_compute": True, "dw_pallas": True},
}


def _grad64(name, fields, params, bn, batch):
    """The float64 gradient of the train step's loss on `batch` (float32
    analysis, then the model and loss in float64), per (layer, leaf) in
    the JAX layout."""
    _, tc = _configs(**fields)
    ext = SpectrogramExtractor(tc.dsp)
    mix = ext(batch.mix_wav, batch.lengths)
    clean = ext(batch.clean_wav, batch.lengths)
    mask = ext.batch_max_frame_mask(batch.lengths, mix.shape[1]).double()
    model = get_model(name)
    forward = model.apply
    if fields.get("blocked_compute"):
        forward = functools.partial(apply_blocked, model, fb=8)
    tp, tb = params_from_numpy(params, bn)
    tp = {n: {k: v.double().requires_grad_() for k, v in d.items()} for n, d in tp.items()}
    y, _ = forward(tp, _f64(tb), mix[..., None].double(), is_training=True, frame_mask=mask)
    step.spectral_l2_loss(y, clean[..., None].double(), tc.train.batch_size, mask).backward()
    return flat_leaves({n: {k: v.grad for k, v in d.items()} for n, d in tp.items()}, port=True)


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_bf16_train_steps_within_jax_budget(case):
    """Three bf16 train steps of V2 at B = 2 (0.5 and 0.9 s) from one numpy
    state: the losses within rtol 2e-2 of JAX bf16's; the first step's
    gradient of each layer's kernel (from Adam's first moment, 0.1 g) no
    farther from the float64 gradient than BUDGET times JAX bf16's
    distance plus BUDGET_ATOL of its scale; params, BN state and moments
    stay float32."""
    fields = dict(TRAIN_CASES[case], compute_dtype="bfloat16")
    jc, tc = _configs(**fields)
    name = "FullyCNNV2"
    jstep = jax.jit(j_step.make_train_step(jc, j_get_model(name)))
    tstep = step.make_train_step(tc, get_model(name))
    batches = [_batches(*_waves(20 + i, pad_to=8000)) for i in range(3)]
    js = _jax_state(name, jc, seed=2)
    params, bn = jax.tree.map(np.asarray, js.params), jax.tree.map(np.asarray, js.bn_state)
    ts = _port_state(js)
    for i, (jb, tb) in enumerate(batches):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        print(f"{case} step {i}: loss port {tm['loss'].item():.4f} JAX {float(jm['loss']):.4f}")
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=2e-2)
        if i == 0:
            g64 = _grad64(name, fields, params, bn, tb)
            gp = flat_leaves(ts.opt_state.mu, port=True)
            gj = flat_leaves(js.opt_state.mu)
            for key in sorted(g64):
                if key[1] == "w":
                    assert_within_budget(f"{case} grad {key[0]}/w", gp[key] / 0.1, gj[key] / 0.1, g64[key])
    for tree in (ts.params, ts.bn_state, ts.opt_state.mu, ts.opt_state.nu):
        assert all(v.dtype == torch.float32 for d in tree.values() for v in d.values())


# -- the eval step ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bn_eval", "bn_train"])
def test_bf16_eval_step_within_jax_budget(mode):
    """The unfused eval step under bf16, both BN modes: the prediction in
    float32, no farther from the float32 step's than BUDGET times JAX
    bf16's distance from JAX float32's (plus BUDGET_ATOL of its scale);
    the phase is the float32 analysis's, bit for bit."""
    name, is_training = "FullyCNNV2", mode == "bn_train"
    params, bn = numpy_params(name, seed=4)
    mix, _, lengths = _waves(6, lens=(3000, 5500), pad_to=6000)
    tp, tb = params_from_numpy(params, bn)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jc, tc = _configs(compute_dtype=dtype)
        jfn = jax.jit(j_step.make_eval_step(jc, j_get_model(name), is_training=is_training))
        tfn = step.make_eval_step(tc, get_model(name), is_training=is_training)
        out[dtype] = ([np.asarray(a) for a in jfn(params, bn, jnp.asarray(mix), jnp.asarray(lengths))],
                      tfn(tp, tb, torch.as_tensor(mix), torch.as_tensor(lengths)))
    (j32, t32), (j16, t16) = out["float32"], out["bfloat16"]
    assert t16[0].dtype == torch.float32
    assert_within_budget(f"eval step {mode}", t16[0].numpy(), j16[0], t32[0].numpy())
    for a, b in zip(t16[1:], t32[1:]):
        assert torch.equal(a, b)


def test_fused_eval_step_ignores_compute_dtype():
    """With `fused_inference` the eval step runs the float32 stack kernel
    whatever `compute_dtype` says (JAX's make_eval_step calls its fused
    forward without a dtype): its output is bit-equal to the float32
    step's."""
    params, bn = params_from_numpy(*numpy_params("FullyCNNV2", seed=4))
    mix, _, lengths = _waves(6, lens=(3000, 5500), pad_to=6000)
    outs = []
    for dtype in ("float32", "bfloat16"):
        _, tc = _configs(compute_dtype=dtype, fused_inference=True)
        outs.append(step.make_eval_step(tc, get_model("FullyCNNV2"))(
            params, bn, torch.as_tensor(mix), torch.as_tensor(lengths)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_unknown_compute_dtype_raises():
    _, tc = _configs(compute_dtype="float16")
    with pytest.raises(ValueError, match="compute_dtype=float16"):
        step.make_train_step(tc, get_model("FullyCNN"))
