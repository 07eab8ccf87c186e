"""The port's time-sharded halo forward and the engine's `mesh=` route,
against the JAX package's `make_time_sharded_forward` on its 8 virtual
CPU devices and against the unsharded forward, at tests/test_halo.py's
tolerances (rtol 2e-4, atol 2e-5).  The port's mesh names the CPU eight
times: every shard runs on it, with the same halo copies as between
cards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu.models import get_model as j_get_model
from fullycnnspeechenhancement_tpu.parallel import make_mesh as j_make_mesh
from fullycnnspeechenhancement_tpu.parallel.halo import make_time_sharded_forward as j_sharded

from fullycnnspeechenhancement_torch.config import Config, DataConfig
from fullycnnspeechenhancement_torch.infer import InferenceEngine
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.parallel import DATA_AXIS, make_mesh
from fullycnnspeechenhancement_torch.parallel.halo import make_time_sharded_forward
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401

TOL = dict(rtol=2e-4, atol=2e-5)
CPU8 = ["cpu"] * 8


def _both(name, seed, shape):
    params, bn = numpy_params(name, seed, centred_bn=True)
    mag = np.random.default_rng(seed).random(shape).astype(np.float32)
    jm = j_get_model(name)
    jp, jb = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, bn)
    j_got = np.asarray(j_sharded(jm, j_make_mesh(n_data=8))(jp, jb, jnp.asarray(mag)))
    tp, tb = params_from_numpy(params, bn)
    model = get_model(name)
    got = make_time_sharded_forward(model, make_mesh(n_data=8, devices=CPU8))(tp, tb, torch.as_tensor(mag))
    with torch.no_grad():
        ref = model.apply(tp, tb, torch.as_tensor(mag)[..., None])[0][..., 0]
    return got.numpy(), ref.numpy(), j_got


@pytest.mark.parametrize("name", ["FullyCNN", "FullyCNNV2", "FullyCNNV3"])
def test_time_sharded_matches_jax_and_unsharded(name):
    got, ref, j_got = _both(name, 0, (2, 8 * 16, 129))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, j_got, **TOL)
    assert np.abs(ref).max() > 0.1


def test_time_sharded_small_shards():
    """Exact when a shard is barely longer than the halo (8 frames)."""
    got, ref, j_got = _both("FullyCNNV2", 1, (1, 8 * 8, 129))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, j_got, **TOL)


def test_time_sharded_rejects_uneven_and_tiny_shards():
    model = get_model("FullyCNN")
    fwd = make_time_sharded_forward(model, make_mesh(n_data=4, devices=CPU8))
    params, bn = params_from_numpy(*numpy_params("FullyCNN", 2))
    with pytest.raises(ValueError, match="equal shards"):
        fwd(params, bn, torch.zeros(1, 30, 129))
    with pytest.raises(ValueError, match="halo"):
        fwd(params, bn, torch.zeros(1, 12, 129))


def test_engine_routes_long_audio_through_halo(tmp_path):
    """An engine with a mesh sends a 20 s utterance (past its 2 s top
    bucket) through the halo forward: it equals the meshless engine and
    JAX's mesh engine on the same weights; a 1 s signal keeps the bucketed
    path and agrees too."""
    from fullycnnspeechenhancement_tpu import config as jcfg
    from fullycnnspeechenhancement_tpu.infer import InferenceEngine as JEngine
    from fullycnnspeechenhancement_tpu.train.checkpoint import export_params_npz

    npz = str(tmp_path / "w.npz")
    export_params_npz(npz, *numpy_params("FullyCNNV2", 3, centred_bn=True))
    buckets = (1.0, 2.0)
    config = Config(data=DataConfig(audio_save_path=str(tmp_path)))
    mesh = make_mesh(n_data=8, devices=CPU8)
    eng_mesh = InferenceEngine(config, checkpoint=npz, bucket_seconds=buckets, device="cpu", mesh=mesh)
    eng_plain = InferenceEngine(config, checkpoint=npz, bucket_seconds=buckets, device="cpu")
    j_eng = JEngine(jcfg.Config(data=jcfg.DataConfig(audio_save_path=str(tmp_path))), checkpoint=npz,
                    bucket_seconds=buckets, mesh=j_make_mesh(n_data=8))
    assert eng_mesh.mesh.shape[DATA_AXIS] == 8

    sr = config.dsp.sample_rate
    rng = np.random.default_rng(3)
    long_sig = (0.3 * rng.standard_normal(20 * sr)).astype(np.float32)
    assert config.dsp.num_frames(len(long_sig)) > 1024
    calls = []
    real = eng_mesh._sharded_model

    def recording(params, bn, mag):
        out = real(params, bn, mag)
        calls.append((mag.numpy().copy(), out.numpy().copy()))
        return out

    eng_mesh._sharded_model = recording
    got = eng_mesh.denoise_array(long_sig)
    assert len(calls) == 1 and calls[0][0].shape[1] % 8 == 0  # frames padded to a multiple of 8
    ref = eng_plain.denoise_array(long_sig)
    assert got.shape == ref.shape == long_sig.shape
    np.testing.assert_allclose(got, ref, **TOL)
    # the route's forward against JAX's mesh engine's on the same input;
    # the waveforms at tests/test_torch_infer.py's engine tolerance (the
    # rebuild's de-emphasis IIR amplifies the two frameworks' float32
    # differences about 33x)
    mag, pred = calls[0]
    j_pred = np.asarray(j_eng._sharded_model(j_eng.params, j_eng.bn_state, jnp.asarray(mag)))
    np.testing.assert_allclose(pred, j_pred, **TOL)
    j_out = j_eng.denoise_array(long_sig)
    np.testing.assert_allclose(got, j_out, rtol=0, atol=1e-4 * np.abs(j_out).max())

    short_sig = (0.3 * rng.standard_normal(sr)).astype(np.float32)
    np.testing.assert_allclose(eng_mesh.denoise_array(short_sig), eng_plain.denoise_array(short_sig), **TOL)
    assert len(calls) == 1


def test_cli_infer_time_shard(tmp_path):
    """`cli.infer --time-shard 4 --device cpu` serves a 70 s file (past the
    32 s top bucket) through the halo path; a card mesh wider than the
    cards raises."""
    from fullycnnspeechenhancement_torch.cli import infer as cli
    from fullycnnspeechenhancement_torch.data.audio_io import read_wav, write_wav

    cfg = tmp_path / "i.cfg"
    cfg.write_text(f"[data]\naudio_save_path={tmp_path}/out\n[model]\nnet_work=FullyCNN\n")
    wav = str(tmp_path / "long.wav")
    write_wav(wav, (0.3 * np.random.default_rng(4).standard_normal(70 * 8000)).astype(np.float32), 8000)
    cli.main(["--cfg", str(cfg), "--audio-file", wav, "--device", "cpu", "--time-shard", "4"])
    out, _ = read_wav(str(tmp_path / "out" / "long_de.wav"))
    assert out.shape == (70 * 8000,) and np.all(np.isfinite(out))
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match="needs 4 devices"):
            cli.main(["--cfg", str(cfg), "--audio-file", wav, "--time-shard", "4"])
