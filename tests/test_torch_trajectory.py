"""A long float64 training trajectory of the port against the JAX package,
on the CPU.

Both packages start from one numpy state (`numpy_params`, carried into
the port by `ckpt.params_from_numpy`) and train on the same seeded
batches of speech-like utterances of unequal lengths (zero-padded past
the batch's longest, so the batch-max mask, or `mask_loss`'s
per-utterance mask, cuts real frames from slack), for `STEPS` steps of
the training-mode forward with its BN moving-average update, the spectral
L2 loss, TF Adam and the Noam schedule, two thirds of them past its
warmup.  The port's side composes its own functions (`model.apply` /
`apply_blocked` with the dW Function, `spectral_l2_loss`,
`tf_adam_update`, `noam_schedule`): its `make_train_step` casts to the
float32 or bf16 compute dtype, and this test runs in float64 throughout,
with JAX under `jax.enable_x64`.

Adam's step size is a float32 scalar in both packages (the JAX package
casts the count to float32).  Where the port's differed from JAX's in the
last bit (a Noam rate evaluated in float32; torch's float32 square root,
one ulp off at some counts), this trajectory left JAX's: one such step
grew to 0.89 of the moments' global scale 100 steps later, while JAX
against itself from a start 4 ulps away stays within 4e-11.  With the
step size equal to the bit, the two stay together.

In float64 the biases that training-mode BN cancels get gradients of
rounding size (about 1e-16 of the gradient scale), far under Adam's
epsilon, so they take no full-size steps of random sign as they do in
float32 (tests/test_torch_train.py, MOMENT_TOL); they drift by Adam's
noise over epsilon, differently in each package, and set the params' and
the BN means' tolerances.  Held: every step's loss; the params, Adam's
moments and the BN moving statistics after steps 1, `WARMUP` and `STEPS`
against their global scale (`global_err`); and the inference-mode
prediction on a held-out input at the end.  Both V2 cases are held
against one JAX trajectory of the plain model (the blocked form is the
same function: tests/test_blocked.py)."""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu.models import get_model as j_get_model
from fullycnnspeechenhancement_tpu.train import optim as j_optim
from fullycnnspeechenhancement_tpu.train import step as j_step

from fullycnnspeechenhancement_torch.config import DSPConfig
from fullycnnspeechenhancement_torch.dsp.features import SpectrogramExtractor
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.models.blocked import apply_blocked
from fullycnnspeechenhancement_torch.quality import speechlike
from fullycnnspeechenhancement_torch.train import checkpoint as ckpt
from fullycnnspeechenhancement_torch.train import optim, step
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401
from test_torch_train import MOMENT_TOL, flat_leaves, global_err

SR = 8000
LR = 1.5e-3
WARMUP = 50  # the Noam schedule peaks at step 50, so most steps run past it
STEPS = 150
N_BATCHES = 8  # distinct batches, cycled
T_PAD = 32  # frames every batch is padded to: past each batch's longest
LENGTHS = (2400, 4000)  # 0.3-0.5 s at 8 kHz, drawn per utterance
CHECK_AT = (1, WARMUP, STEPS)

# float64 against float64.  Largest errors measured over the three cases
# in brackets: each step's loss, relative (4.8e-12); Adam's mu (1.3e-10)
# and nu (4.9e-13); the BN statistics (4.0e-8), from the cancelled biases'
# drift; the params (1.3e-6), the same drift; the prediction against
# max|JAX's| (7.3e-7).  Each at least 1e3 under float32's MOMENT_TOL.
TOL = {"loss": 1e-9, "mu": 1e-8, "nu": 1e-8, "bn": 1e-6, "params": 1e-5, "prediction": 1e-5}
DATA_SEED = 5

# name: (model, blocked with the dW Function, mask_loss, batch size)
CASES = {
    "plain": ("FullyCNNV2", False, False, 2),
    # the port runs dw_pallas=True (its dW Function, the plain version on
    # the CPU)
    "blocked_dw": ("FullyCNNV2", True, False, 2),
    "mask_loss": ("FullyCNN", False, True, 2),
}
# JAX's trajectory of each (model, mask_loss, batch size), run once, in a
# thread beside the port's (both release the GIL while they compute)
_JAX_POOL = ThreadPoolExecutor(1)
_JAX_RUNS = {}


def _batches(B, seed, mask_loss=False):
    """`N_BATCHES` (mix magnitude, clean magnitude, frame mask) float64
    arrays: speech-like utterances of unequal lengths mixed with white
    noise at 0 dB, through the port's float32 analysis.  Both packages
    train on these same arrays."""
    dsp = DSPConfig()
    ext = SpectrogramExtractor(dsp)
    L = dsp.padded_samples(T_PAD)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N_BATCHES):
        lengths = np.sort(rng.integers(LENGTHS[0], LENGTHS[1] + 1, B))
        if i % 2:  # every other batch holds a longest utterance
            lengths[-1] = LENGTHS[1]
        mix = np.zeros((B, L), np.float32)
        clean = np.zeros((B, L), np.float32)
        for b, n in enumerate(lengths):
            c = speechlike(seed * 1000 + i * B + b, int(n), SR)
            noise = np.random.default_rng(seed * 2000 + i * B + b).standard_normal(int(n)).astype(np.float32)
            noise *= np.sqrt((c**2).sum() / (noise**2).sum())
            clean[b, :n] = c
            mix[b, :n] = c + noise
        lt = torch.as_tensor(lengths.astype(np.int32))
        mix_mag = ext(torch.as_tensor(mix), lt)
        clean_mag = ext(torch.as_tensor(clean), lt)
        T = mix_mag.shape[1]
        mask = ext.frame_mask(lt, T) if mask_loss else ext.batch_max_frame_mask(lt, T)
        out.append(tuple(np.asarray(a.numpy(), np.float64)
                         for a in (mix_mag[..., None], clean_mag[..., None], mask)))
    return out


def _jax_run(name, mask_loss, B, params, bn, batches, held_out):
    """The JAX package's trajectory: (losses, {step: state}, prediction)."""
    jm = j_get_model(name)
    tx = j_optim.tf_adam(j_optim.noam_schedule(LR, WARMUP))
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731

        @jax.jit
        def train_step(p, s, opt, x, tgt, mask):
            def loss_fn(p):
                y, new_s = jm.apply(p, s, x, is_training=True, frame_mask=mask)
                return j_step.spectral_l2_loss(y, tgt, B, mask, normalize_mask=mask_loss), new_s

            (loss, new_s), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
            upd, opt = tx.update(g, opt, p)
            return jax.tree.map(lambda a, u: a + u, p, upd), new_s, opt, loss

        p, s = to64(params), to64(bn)
        opt = tx.init(p)
        losses, states = [], {}
        for i in range(STEPS):
            x, tgt, mask = batches[i % len(batches)]
            p, s, opt, loss = train_step(p, s, opt, x, tgt, mask)
            losses.append(float(loss))
            if i + 1 in CHECK_AT:
                states[i + 1] = {k: flat_leaves(v) for k, v in
                                 (("params", p), ("mu", opt.mu), ("nu", opt.nu), ("bn", s))}
        pred, _ = jm.apply(p, s, jnp.asarray(held_out), is_training=False)
        return np.asarray(losses), states, np.asarray(pred)


def _port_run(name, blocked, mask_loss, B, params, bn, batches, held_out):
    """The port's trajectory from the same numpy state, composed of its
    own functions: (losses, {step: state}, prediction)."""
    model = get_model(name)
    forward = functools.partial(apply_blocked, model, fb=8, dw_pallas=True) if blocked else model.apply
    schedule = optim.noam_schedule(LR, WARMUP)
    tp, ts = ckpt.params_from_numpy(params, bn)
    tp = {n: {k: v.double().requires_grad_() for k, v in d.items()} for n, d in tp.items()}
    ts = {n: {k: v.double() for k, v in d.items()} for n, d in ts.items()}
    names = [(n, k) for n in sorted(tp) for k in sorted(tp[n])]
    leaves = [tp[n][k] for n, k in names]
    opt = optim.tf_adam_init(tp)
    losses, states = [], {}
    for i in range(STEPS):
        x, tgt, mask = (torch.as_tensor(a) for a in batches[i % len(batches)])
        pred, ts = forward(tp, ts, x, is_training=True, frame_mask=mask)
        loss = step.spectral_l2_loss(pred, tgt, B, mask, normalize_mask=mask_loss)
        flat = torch.autograd.grad(loss, leaves)
        grads = {}
        for (n, k), g in zip(names, flat):
            grads.setdefault(n, {})[k] = g
        opt = optim.tf_adam_update(tp, grads, opt, schedule)
        losses.append(loss.item())
        if i + 1 in CHECK_AT:
            # copies: the port updates params and moments in place
            states[i + 1] = {k: {n: a.copy() for n, a in flat_leaves(v, port=True).items()} for k, v in
                             (("params", tp), ("mu", opt.mu), ("nu", opt.nu), ("bn", ts))}
    assert int(opt.count) == STEPS
    with torch.no_grad():
        pred, _ = model.apply(tp, ts, torch.as_tensor(held_out), is_training=False)
    return np.asarray(losses), states, pred.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_trajectory_matches_jax(case):
    """`STEPS` float64 steps in both packages from one numpy state on the
    same batches: each step's loss, the state after steps 1, `WARMUP` and
    `STEPS`, and the final inference-mode prediction within `TOL`."""
    name, blocked, mask_loss, B = CASES[case]
    batches = _batches(B, seed=DATA_SEED, mask_loss=mask_loss)
    held_out = _batches(1, seed=99)[0][0]
    params, bn = numpy_params(name, seed=11)
    key = (name, mask_loss, B)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = _JAX_POOL.submit(_jax_run, name, mask_loss, B, params, bn, batches, held_out)
    tl, ts, tp = _port_run(name, blocked, mask_loss, B, params, bn, batches, held_out)
    jl, js, jp = _JAX_RUNS[key].result()

    assert jl[-1] < 0.75 * jl[0], "the recipe must train: the trajectory would test nothing"
    errs = {"loss": float(np.max(np.abs(tl - jl) / np.abs(jl)))}
    for at in CHECK_AT:
        for part in ("params", "mu", "nu", "bn"):
            errs[f"{part}@{at}"] = global_err(ts[at][part], js[at][part])
    errs["prediction"] = float(np.abs(tp - jp).max() / np.abs(jp).max())
    worst = {part: max(v for k, v in errs.items() if k.split("@")[0] == part) for part in TOL}
    print(f"\n{case}: loss {jl[0]:.6g} -> {jl[-1]:.6g}; largest errors " +
          ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    assert all(t * 1e3 <= MOMENT_TOL for t in TOL.values())
    bad = {k: v for k, v in errs.items() if not v < TOL[k.split("@")[0]]}
    assert not bad, f"past {TOL}: {bad}"
