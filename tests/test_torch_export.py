"""The port's export (npz and a `torch.export` artefact of the BN-folded
inference forward) and `cli/export` on the CPU: round trips through both
formats (the tests/test_engine.py::test_stablehlo_export_roundtrip
pattern), the artefact against JAX's StableHLO artefact on the same
weights, and the npz against JAX's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fullycnnspeechenhancement_tpu import config as jcfg
from fullycnnspeechenhancement_tpu.export import export_stablehlo, load_stablehlo
from fullycnnspeechenhancement_tpu.train.checkpoint import export_params_npz as j_export

from fullycnnspeechenhancement_torch.cli import export as export_cli
from fullycnnspeechenhancement_torch.config import Config, ModelConfig
from fullycnnspeechenhancement_torch.export import export_npz, export_torch, load_torch_export
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.train.checkpoint import import_reference_npz, params_from_numpy
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401

FRAMES = 64
MODELS = ["FullyCNN", "FullyCNNV2", "FullyCNNV3"]


def _input(seed=0):
    return np.random.default_rng(seed).random((1, FRAMES, 129, 1), dtype=np.float32)


@pytest.mark.parametrize("name", MODELS)
def test_export_roundtrip(tmp_path, name):
    """Both formats reload to the forward they were written from: the npz
    bit for bit, the artefact within the JAX round trip's tolerance (BN is
    folded into the convs, which rounds differently)."""
    model = get_model(name)
    params, bn = params_from_numpy(*numpy_params(name, seed=7, centred_bn=True))
    x = torch.as_tensor(_input())
    ref, _ = model.apply(params, bn, x)
    npz = export_npz(str(tmp_path / "w.npz"), params, bn)
    p2, bn2 = import_reference_npz(npz, model)
    torch.testing.assert_close(model.apply(p2, bn2, x)[0], ref, rtol=0, atol=0)
    path = export_torch(Config(model=ModelConfig(net_work=name)), params, bn,
                        str(tmp_path / "model.pt2"), batch=1, frames=FRAMES)
    program = load_torch_export(path)
    y = program.module()(x)
    assert y.shape == (1, FRAMES, 129, 1) and y.dtype == torch.float32
    assert ref.abs().max() > 1e-2  # a live model
    np.testing.assert_allclose(y.detach().numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_torch_export_matches_jax_stablehlo(tmp_path, name):
    """The port's artefact and JAX's StableHLO artefact of the same
    weights on the same input, within the engine's tolerance against JAX
    (tests/test_torch_infer.py: 1e-4 of the largest JAX output)."""
    np_params, np_bn = numpy_params(name, seed=8, centred_bn=True)
    j_params = {n: {k: jnp.asarray(v) for k, v in p.items()} for n, p in np_params.items()}
    shlo = export_stablehlo(jcfg.Config(model=jcfg.ModelConfig(net_work=name)), j_params, np_bn,
                            str(tmp_path / "model.shlo"), batch=1, frames=FRAMES)
    x = _input(1)
    ref = np.asarray(load_stablehlo(shlo).call(jnp.asarray(x)))
    params, bn = params_from_numpy(np_params, np_bn)
    path = export_torch(Config(model=ModelConfig(net_work=name)), params, bn,
                        str(tmp_path / "model.pt2"), batch=1, frames=FRAMES)
    got = load_torch_export(path).module()(torch.as_tensor(x)).detach().numpy()
    err = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"{name}: torch.export artefact vs StableHLO max abs err {err:.3e} of max|JAX|")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_export_cli_writes_both_formats(tmp_path, capsys):
    """`cli/export --device cpu` from a JAX-written npz: the npz it writes
    holds JAX's arrays exactly, and the artefact reloads to the forward."""
    np_params, np_bn = numpy_params("FullyCNNV2", seed=9, centred_bn=True)
    src = str(tmp_path / "src.npz")
    j_export(src, np_params, np_bn)
    cfg = tmp_path / "export.cfg"
    cfg.write_text("[model]\nnet_work=FullyCNNV2\n")
    out_npz, out_pt2 = str(tmp_path / "out" / "w.npz"), str(tmp_path / "out" / "m.pt2")
    (tmp_path / "out").mkdir()
    written = export_cli.main(["--cfg", str(cfg), "--checkpoint", src, "--npz", out_npz,
                               "--torch-export", out_pt2, "--device", "cpu"])
    assert written == [out_npz, out_pt2]
    assert capsys.readouterr().out.split() == written
    a, b = np.load(src), np.load(out_npz)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    model = get_model("FullyCNNV2")
    params, bn = params_from_numpy(np_params, np_bn)
    x = torch.as_tensor(_input(2))
    # the CLI writes frames=512; an input of FRAMES frames zero-padded to
    # 512 gives the same first FRAMES output frames (only the first layer
    # looks across frames, and SAME padding is zeros too)
    padded = torch.zeros(1, 512, 129, 1)
    padded[:, :FRAMES] = x
    y = load_torch_export(out_pt2).module()(padded)[:, :FRAMES]
    ref = model.apply(params, bn, x)[0]
    np.testing.assert_allclose(y.detach().numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)
    with pytest.raises(SystemExit):
        export_cli.main(["--cfg", str(cfg), "--checkpoint", src, "--device", "cpu"])


def test_export_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    cfg = tmp_path / "export.cfg"
    cfg.write_text("[model]\nnet_work=FullyCNNV2\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_cli.main(["--cfg", str(cfg), "--npz", str(tmp_path / "w.npz")])
