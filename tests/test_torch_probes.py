"""The port's kernel probes (`fullycnnspeechenhancement_torch/probes/`) against
the Pallas probes they replace (`benchmarks/micro_pallas_*.py`), run on the
CPU in interpret mode, and `ops/freq_conv.py`'s plain versions against
independent references.  The CUDA kernels themselves are held against
their plain versions in test_torch_cuda.py.

The benchmark scripts draw unseeded inputs and time their kernels at top
level, so `_pallas_defs` compiles only their imports and function
definitions, into a namespace that holds small shape constants.
"""

import ast
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fullycnnspeechenhancement_torch.ops import freq_conv as fc
from fullycnnspeechenhancement_torch.probes import __main__ as probes_main
from fullycnnspeechenhancement_torch.probes import all_probes
from test_torch_cuda import one_cpu_thread_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmarks")

# Small shapes: the port's `inputs` keywords per probe module, and the
# constants each benchmark script's functions read.
SMALL = {
    "conv": dict(T=3, F=129, C=5, D=6, K=11),
    "roll": dict(T_TILE=2, C=8, K=11),
    "min": dict(T=3, F=129, C=5, D=6, K=11),
}
ROLL_CONSTS = dict(T_TILE=2, F_PAD=256, C=8, K=11, N=2 * 256)
PROBES = {p.name: (m, p) for m, p in all_probes()}
ROWS = ["3a", "3b", "3c", "4a", "4b", "4c", "4d", "5a", "5b", "5c", "5d", "5e", "5f"]


def _pallas_defs(filename, consts, nested=None):
    """Imports and function definitions of `benchmarks/<filename>`, executed
    in a namespace holding `consts`.  `nested` = ("main", "vA", "kernel")
    takes that nested definition instead of the top-level ones."""
    path = os.path.join(BENCH, filename)
    tree = ast.parse(open(path).read(), path)
    keep = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    if nested is None:
        keep += [n for n in tree.body if isinstance(n, ast.FunctionDef)]
    else:
        body = tree.body
        for name in nested:
            node = next(n for n in body if isinstance(n, ast.FunctionDef) and n.name == name)
            body = node.body
        keep.append(node)
    ns = dict(consts)
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns


def _interpret(kernel, args, out_shape):
    fn = pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM) for _ in args],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True,
    )
    return np.asarray(fn(*args))


def _jax_probe(name, arrays):
    """The Pallas probe `name` (the port's probe name) on `arrays`, at the
    SMALL shapes, in interpret mode."""
    c = SMALL["conv"]
    conv_out = (1, c["T"], c["F"], c["D"])
    if name.startswith("conv."):
        variant = name.split(".")[1]
        ns = _pallas_defs("micro_pallas_conv.py", c, ("main", variant, "kernel"))
        if variant == "vC":
            # the probe's negative roll shift means jnp.roll (see probes/conv.py)
            ns["pltpu"] = types.SimpleNamespace(roll=jnp.roll)
            conv_out = (1, c["T"], c["D"], c["F"])
        kernel = ns["kernel"]
        out = conv_out
    elif name.startswith("roll."):
        out = (ROLL_CONSTS["C"], ROLL_CONSTS["N"])
        if name.startswith("roll.im2col_stack("):
            ns = _pallas_defs("micro_pallas_roll2.py", ROLL_CONSTS)
            kernel = ns["mk_stack"](int(name[len("roll.im2col_stack(") : -1]))
        else:
            kernel = _pallas_defs("micro_pallas_roll.py", ROLL_CONSTS)[name.split(".")[1]]
    else:
        fname = name.split(".")[1]
        consts = SMALL["min"]
        if fname.startswith("min2_"):
            kernel = _pallas_defs("micro_pallas_min2.py", consts)[fname[len("min2_") :]]
        else:
            kernel = _pallas_defs("micro_pallas_min.py", consts)[fname]
        out = (1, consts["T"], consts["F"], consts["D"])
    _, probe = PROBES[name]
    return _interpret(kernel, [arrays[a] for a in probe.args], out)


def _small_inputs(module, seed):
    short = module.__name__.rsplit(".", 1)[-1]
    return module.inputs(np.random.default_rng(seed), **SMALL[short])


def _assert_matches(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_probes_cover_every_row_and_name_their_pallas_kernel():
    assert sorted({p.row for _, p in all_probes()}) == ROWS
    assert len(PROBES) == 17
    for name, (_, probe) in PROBES.items():
        path, line = probe.replaces.rsplit(":", 1)
        text = open(os.path.join(REPO, path)).read().splitlines()[int(line) - 1].strip()
        assert text.startswith("def ") and text.endswith("):"), (name, text)
        assert probe.kernel == ("freq_conv_stack" if probe.row in ("4c", "4d") else "freq_conv")


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_matches_pallas_probe(name):
    module, probe = PROBES[name]
    arrays = _small_inputs(module, seed=len(name))
    ref = _jax_probe(name, arrays)
    args = [torch.as_tensor(arrays[a]) for a in probe.args]
    got = probe(*args)
    assert got.shape == ref.shape
    _assert_matches(got.numpy(), ref)
    assert torch.equal(probe(*args, plain=True), got)


def test_probe_path_matches_pallas_probes():
    """The slice as a whole: `python -m ...probes --device cpu` at small
    shapes, every output against its Pallas probe."""
    lines = []
    results = probes_main.run_all("cpu", seed=3, reps=1, shapes=SMALL, log=lines.append)
    assert [p.name for p, *_ in results] == [p.name for _, p in all_probes()]
    assert len(lines) == len(results) and all("run " in line for line in lines)
    rng = np.random.default_rng(3)
    arrays = {}
    for (module, probe), (_, out, _, _) in zip(all_probes(), results):
        short = module.__name__.rsplit(".", 1)[-1]
        if short not in arrays:
            arrays[short] = module.inputs(rng, **SMALL[short])
        _assert_matches(out.numpy(), _jax_probe(probe.name, arrays[short]))


def test_probe_cli_runs_on_cpu_and_wants_cuda_by_default(capsys, monkeypatch):
    monkeypatch.setattr(probes_main, "run_all", lambda device, **kw: print("ran", device, kw["reps"]))
    assert probes_main.main(["--device", "cpu", "--reps", "2"]) == 0
    assert capsys.readouterr().out.strip() == "ran cpu 2"
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        probes_main.main([])


# -- the plain versions against independent references, in float64 --------


def _conv2d_ref(x, w, lo, dil):
    """F.conv2d of x [B, R, P, C] viewed as NCHW [B, C, R, P] with the
    [K, C, D] taps as a (1, K) OIHW kernel dilated by `dil`."""
    K = w.shape[0]
    xp = F.pad(x.permute(0, 3, 1, 2), (lo, (K - 1) * dil - lo))
    return F.conv2d(xp, w.permute(2, 1, 0)[:, :, None, :], dilation=(1, dil)).permute(0, 2, 3, 1)


@pytest.mark.parametrize(
    "K,lo,dil,layout",
    [(11, None, 1, "nhwc"), (11, None, 1, "nchw"), (1, 0, 1, "nhwc"), (7, 3, 1, "nchw"),
     (2, 3, 6, "nhwc"), (5, 0, 2, "nchw"), (4, None, 1, "nhwc")],
)
def test_freq_conv_plain_matches_conv2d_f64(K, lo, dil, layout):
    rng = np.random.default_rng(K * 10 + dil)
    B, R, P, C, D = 2, 3, 29, 4, 5
    if layout == "nhwc":
        x = torch.as_tensor(rng.standard_normal((B, R, P, C)))
    else:  # the port's NCHW activations, viewed as [B, R, P, C]
        x = torch.as_tensor(rng.standard_normal((B, C, R, P))).permute(0, 2, 3, 1)
    w = torch.as_tensor(rng.standard_normal((K, C, D)))
    got = fc.freq_conv(x, w, lo=lo, dilation=dil)
    ref = _conv2d_ref(x, w, (K - 1) // 2 if lo is None else lo, dil)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)


def _roll_ref(x, w, lo, dil, period, valid, relu, scale):
    """numpy: sum over taps of x rolled along P, then mask, ReLU, scale."""
    y = sum(np.roll(x, -(j * dil - lo), axis=2) @ w[j] for j in range(w.shape[0]))
    if period:
        y = np.where((np.arange(x.shape[2]) % period < valid)[:, None], y, 0.0)
    if relu:
        y = np.maximum(y, 0.0)
    return y * scale


@pytest.mark.parametrize(
    "K,lo,dil,period,valid,relu,scale",
    [(11, 5, 1, 0, 0, False, 1.0), (1, 3, 1, 0, 0, False, 1.0), (11, 5, 1, 16, 9, False, 1.0),
     (11, 5, 1, 16, 9, True, 1e-2), (3, -2, 4, 8, 8, True, 0.5)],
)
def test_freq_conv_plain_circular_matches_np_roll_f64(K, lo, dil, period, valid, relu, scale):
    rng = np.random.default_rng(K + 100 * dil)
    x = rng.standard_normal((1, 2, 48, 3))
    w = rng.standard_normal((K, 3, 4))
    got = fc.freq_conv(torch.as_tensor(x), torch.as_tensor(w), lo=lo, dilation=dil, circular=True,
                       period=period, valid=valid, relu=relu, scale=scale)
    ref = _roll_ref(x, w, lo, dil, period, valid, relu, scale)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("depth,scale", [(1, 1.0), (3, 1e-2)])
def test_freq_conv_stack_plain_matches_chained_np_roll_f64(depth, scale):
    """The chain on [C, N]: each layer circular over all N lanes (frames
    cross into each other), masked to n % frame < valid."""
    rng = np.random.default_rng(depth)
    C, frame, valid, N = 3, 16, 9, 64
    x = rng.standard_normal((C, N))
    w = rng.standard_normal((5, C, C))
    h = x.T[None, None]
    for _ in range(depth):
        h = _roll_ref(h, w, 2, 1, frame, valid, True, scale)
    got = fc.freq_conv_stack(torch.as_tensor(x), torch.as_tensor(w), depth, frame=frame,
                             valid=valid, scale=scale)
    np.testing.assert_allclose(got.numpy(), h[0, 0].T, rtol=1e-12, atol=1e-12)


def test_cpu_wrappers_run_plain_and_launch_nothing():
    g = torch.Generator().manual_seed(0)
    x = torch.rand(1, 2, 129, 5, generator=g)
    w = torch.rand(11, 5, 6, generator=g)
    xs = torch.rand(4, 512, generator=g)
    ws = torch.rand(11, 4, 4, generator=g)
    before = (fc.launches, fc.stack_launches)
    assert torch.equal(fc.freq_conv(x, w, circular=True), fc.freq_conv_plain(x, w, circular=True))
    assert torch.equal(fc.freq_conv_stack(xs, ws, 2), fc.freq_conv_stack_plain(xs, ws, 2))
    assert (fc.launches, fc.stack_launches) == before


def test_wrappers_raise_on_other_devices():
    """Off the CPU the wrappers launch the kernel or raise: a tensor on
    another device is not run by the plain version."""
    x = torch.empty(1, 2, 129, 5, device="meta")
    w = torch.empty(11, 5, 6, device="meta")
    before = (fc.launches, fc.stack_launches)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fc.freq_conv(x, w)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fc.freq_conv_stack(torch.empty(4, 512, device="meta"), torch.empty(11, 4, 4, device="meta"), 2)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fc.freq_conv(torch.zeros(1, 2, 129, 5), w)
    assert (fc.launches, fc.stack_launches) == before


def test_probe_modules_import_no_benchmarks():
    pkg = os.path.join(REPO, "fullycnnspeechenhancement_torch")
    paths = [os.path.join(pkg, "probes", f) for f in os.listdir(os.path.join(pkg, "probes")) if f.endswith(".py")]
    paths.append(os.path.join(pkg, "ops", "freq_conv.py"))
    assert len(paths) == 6
    for path in paths:
        for node in ast.walk(ast.parse(open(path).read(), path)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert all(n.split(".")[0] not in ("benchmarks", "jax", "jaxlib") for n in names), path
