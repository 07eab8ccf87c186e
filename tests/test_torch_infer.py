"""The port's whole serving slice against the JAX package's, on the CPU:
`InferenceEngine` on the same npz and the same waveforms, with the fused
flag on and off; the CLI; device handling; and the import guard that keeps
JAX out of the port."""

import ast
import os

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu import config as jcfg
from fullycnnspeechenhancement_tpu.infer import InferenceEngine as JEngine
from fullycnnspeechenhancement_tpu.train.checkpoint import export_params_npz as j_export

from fullycnnspeechenhancement_torch import config as tcfg
from fullycnnspeechenhancement_torch.data.audio_io import read_wav, write_wav
from fullycnnspeechenhancement_torch.infer import InferenceEngine
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Short buckets keep the JAX compiles small; the two signals land in
# different buckets (0.25 s and 0.5 s).
BUCKETS = (0.25, 0.5)
LENGTHS = (1500, 3500)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """V2 weights written by the JAX package's npz exporter."""
    params, bn = numpy_params("FullyCNNV2", seed=3)
    path = str(tmp_path_factory.mktemp("w") / "v2.npz")
    j_export(path, params, bn)
    return path


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("fused", [False, True], ids=["layerwise", "fused"])
def test_engine_matches_jax(npz, fused):
    j_engine = JEngine(
        jcfg.Config(
            model=jcfg.ModelConfig(net_work="FullyCNNV2", fused_inference=fused),
            eval=jcfg.EvalConfig(checkpoint_filepath=npz),
        ),
        bucket_seconds=BUCKETS,
    )
    engine = InferenceEngine(
        tcfg.Config(
            model=tcfg.ModelConfig(net_work="FullyCNNV2", fused_inference=fused),
            eval=tcfg.EvalConfig(checkpoint_filepath=npz),
        ),
        bucket_seconds=BUCKETS,
        device="cpu",
    )
    assert (engine._packed is not None) == fused
    for i, n in enumerate(LENGTHS):
        sig = _signal(n, seed=i)
        ref = np.asarray(j_engine.denoise_array(sig))
        got = engine.denoise_array(sig)
        assert got.shape == ref.shape == (n,)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_engine_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(tcfg.Config())


def test_engine_random_init_follows_the_seed():
    a = InferenceEngine(tcfg.Config(), device="cpu")
    b = InferenceEngine(tcfg.Config(), device="cpu")
    c = InferenceEngine(tcfg.Config(train=tcfg.TrainConfig(seed=1)), device="cpu")
    assert torch.equal(a.params["encode_1"]["w"], b.params["encode_1"]["w"])
    assert not torch.equal(a.params["encode_1"]["w"], c.params["encode_1"]["w"])


def test_non_npz_checkpoint_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="export_params_npz"):
        InferenceEngine(tcfg.Config(), checkpoint=str(tmp_path / "run_dir"), device="cpu")


def test_pad_len_matches_jax(npz):
    j_engine = JEngine(jcfg.Config(eval=jcfg.EvalConfig(checkpoint_filepath=npz)))
    engine = InferenceEngine(tcfg.Config(eval=tcfg.EvalConfig(checkpoint_filepath=npz)), device="cpu")
    for n in (1, 16000, 16001, 64000, 256000, 256001, 600000):
        assert engine._pad_len(n) == j_engine._pad_len(n)


def test_cli_writes_de_wav(tmp_path, npz):
    from fullycnnspeechenhancement_torch.cli import infer as cli

    wav = str(tmp_path / "noisy.wav")
    write_wav(wav, _signal(4321, seed=5), 8000)
    out_dir = tmp_path / "out"
    cfg = tmp_path / "infer.cfg"
    cfg.write_text(
        f"[inference]\ncheckpoint_filepath={npz}\n[model]\nnet_work=FullyCNNV2\n"
        f"fused_inference=True\n[data]\naudio_save_path={out_dir}\n"
    )
    cli.main(["--cfg", str(cfg), "--audio-file", wav, "--device", "cpu"])
    out, sr = read_wav(str(out_dir / "noisy_de.wav"))
    assert sr == 8000 and len(out) == 4321 and np.all(np.isfinite(out))


def _port_sources():
    pkg = os.path.join(REPO, "fullycnnspeechenhancement_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    banned = ("jax", "jaxlib", "fullycnnspeechenhancement_tpu")
    sources = list(_port_sources())
    assert len(sources) > 15
    for module in ("streaming.py", "export.py", os.path.join("cli", "stream.py"),
                   os.path.join("cli", "export.py"), os.path.join("data", "device_cache.py"),
                   os.path.join("train", "cached_step.py")):
        assert any(p.endswith(os.path.join("fullycnnspeechenhancement_torch", module))
                   for p in sources), module
    for path in sources:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path} imports {name}"


_PATH_CALLS = {"join", "Path", "PurePath", "CDLL", "LoadLibrary", "open", "abspath", "realpath", "resolve"}


def _path_strings(node):
    """String constants among the arguments of calls that build or open a
    path (`os.path.join`, `Path`, `ctypes.CDLL`, `open`, ...) and in the
    operands of `/` between paths."""
    for sub in ast.walk(node):
        parts = []
        if isinstance(sub, ast.Call):
            func = sub.func
            name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")
            if name in _PATH_CALLS:
                parts = list(sub.args) + [k.value for k in sub.keywords]
        elif isinstance(sub, ast.BinOp) and isinstance(sub.op, ast.Div):
            parts = [sub.left, sub.right]
        for part in parts:
            for c in ast.walk(part):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    yield c.value


def test_port_builds_no_path_into_the_jax_package():
    """No port module (nor chip_smoke.py) joins, opens or loads a path into
    the JAX package's directory: no `"..", "runtime"` join as in JAX
    `data/native.py`, no `fullycnnspeechenhancement_tpu` in a path, no
    load of its committed `libfcse_runtime.so`."""
    sources = list(_port_sources())
    assert any(p.endswith(os.path.join("data", "native.py")) for p in sources)
    assert any(p.endswith(os.path.join("eval", "evaluator.py")) for p in sources)
    assert any(p.endswith(os.path.join("cli", "test.py")) for p in sources)
    for path in sources:
        tree = ast.parse(open(path).read(), path)
        for text in _path_strings(tree):
            assert text != "..", f"{path} joins '..' into a path"
            assert "fullycnnspeechenhancement_tpu" not in text, f"{path} builds a path from {text!r}"
            assert text != "libfcse_runtime.so", f"{path} names the JAX package's library"
