"""The port's streaming denoiser and `cli/stream` on the CPU: the three
patterns of tests/test_streaming.py (streamed equals the whole-utterance
overlap-add path, chunking invariance, the latency contract), the port's
streamer against JAX's `StreamingDenoiser` on the same pushes and weights,
and the CLI's report against the JAX CLI's."""

import json

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu import config as jcfg
from fullycnnspeechenhancement_tpu.cli import stream as j_stream_cli
from fullycnnspeechenhancement_tpu.streaming import StreamingDenoiser as JStreamer
from fullycnnspeechenhancement_tpu.train.checkpoint import export_params_npz as j_export

from fullycnnspeechenhancement_torch.cli import stream as stream_cli
from fullycnnspeechenhancement_torch.config import Config, ModelConfig
from fullycnnspeechenhancement_torch.data.audio_io import read_wav, write_wav
from fullycnnspeechenhancement_torch.dsp.features import SpectrogramExtractor
from fullycnnspeechenhancement_torch.dsp.rebuild import WaveformRebuilder
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.streaming import StreamingDenoiser
from fullycnnspeechenhancement_torch.train.checkpoint import params_from_numpy
from test_torch_cuda import numpy_params, one_cpu_thread_per_worker  # noqa: F401

SR = 8000
# The engine's tolerance against JAX (tests/test_torch_infer.py): atol
# 1e-4 of the largest JAX output.
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    config = Config(model=ModelConfig(net_work="FullyCNNV2"))
    np_params, np_bn = numpy_params("FullyCNNV2", seed=5, centred_bn=True)
    params, bn = params_from_numpy(np_params, np_bn)
    rng = np.random.default_rng(0)
    t = np.arange(int(2.0 * SR)) / SR
    wav = (0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(len(t))).astype(np.float32)
    return config, params, bn, (np_params, np_bn), wav


def _batch_denoise_ola(config, params, bn, wav):
    """The port's whole-utterance path: analysis, the model in eval mode,
    then the overlap-add rebuild."""
    ext = SpectrogramExtractor(config.dsp)
    reb = WaveformRebuilder(config.dsp, mode="overlap_add")
    with torch.no_grad():
        mag, pre, pim = ext.magnitude_and_phase(
            torch.as_tensor(wav[None]), torch.tensor([len(wav)], dtype=torch.int32)
        )
        pred, _ = get_model(config.model.net_work).apply(params, bn, mag[..., None])
        return reb(pred[..., 0], pre, pim)[0].numpy()


def _stream(streamer, pieces):
    outs = [streamer.push(p) for p in pieces]
    outs.append(streamer.flush())
    return outs


def test_streaming_matches_batch(setup):
    config, params, bn, _, wav = setup
    batch_out = _batch_denoise_ola(config, params, bn, wav)
    stream_out = np.concatenate(
        _stream(StreamingDenoiser(config, params, bn, chunk_frames=8, device="cpu"), [wav])
    )
    n = min(len(stream_out), len(batch_out))
    assert n >= len(wav) - config.dsp.frame_length
    assert np.abs(batch_out).max() > 1e-2  # a live model
    np.testing.assert_allclose(stream_out[:n], batch_out[:n], rtol=1e-3, atol=2e-3)


def test_streaming_chunking_invariance(setup):
    """The output does not depend on how the input is sliced."""
    config, params, bn, _, wav = setup

    def run(pieces):
        return np.concatenate(
            _stream(StreamingDenoiser(config, params, bn, chunk_frames=4, device="cpu"), pieces)
        )

    a = run([wav])
    cuts = np.sort(np.random.default_rng(1).choice(len(wav) - 2, size=7, replace=False) + 1)
    b = run(np.split(wav, cuts))
    assert len(a) == len(b)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_streaming_latency_contract(setup):
    """Exactly chunk + lookahead frames of audio give the first chunk of
    output; one sample less gives nothing."""
    config, params, bn, _, wav = setup
    s = StreamingDenoiser(config, params, bn, chunk_frames=4, device="cpu")
    step, flen = config.dsp.frame_step, config.dsp.frame_length
    need_samples = (4 + 4 - 1) * step + flen
    assert len(s.push(wav[: need_samples - 1])) == 0
    assert len(s.push(wav[need_samples - 1 : need_samples])) == 4 * step
    assert s.latency_samples == 4 * step


@pytest.mark.parametrize("chunk_frames", [4, 8])
def test_streaming_matches_jax(setup, chunk_frames):
    """The same pushes through both streamers on the same weights: every
    push returns as many samples, within the engine's tolerance."""
    config, params, bn, (np_params, np_bn), wav = setup
    cuts = np.sort(np.random.default_rng(2).choice(len(wav) - 2, size=9, replace=False) + 1)
    pieces = np.split(wav, cuts)
    j_params = {n: {k: np.asarray(v) for k, v in p.items()} for n, p in np_params.items()}
    ref = _stream(JStreamer(jcfg.Config(model=jcfg.ModelConfig(net_work="FullyCNNV2")),
                            j_params, np_bn, chunk_frames=chunk_frames), pieces)
    got = _stream(StreamingDenoiser(config, params, bn, chunk_frames=chunk_frames, device="cpu"),
                  pieces)
    assert [len(g) for g in got] == [len(r) for r in ref]
    ref, got = np.concatenate(ref), np.concatenate(got)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    print(f"streamer chunk {chunk_frames}: port vs JAX max abs err {err:.3e} of max|JAX|")
    np.testing.assert_allclose(got, ref, rtol=0, atol=JAX_TOL * np.abs(ref).max())


def test_stream_cli_report_matches_jax_cli(setup, tmp_path, capsys):
    """Both CLIs on one short wav and one npz: the same report keys, the
    same latency and budget, the same denoised file within the engine's
    tolerance."""
    _, _, _, (np_params, np_bn), wav = setup
    npz = str(tmp_path / "w.npz")
    j_export(npz, np_params, np_bn)
    cfg = tmp_path / "infer.cfg"
    cfg.write_text(f"[model]\nnet_work=FullyCNNV2\n[testing]\ncheckpoint_filepath={npz}\n")
    reports, outs = {}, {}
    for tag, main, extra in (("jax", j_stream_cli.main, []),
                             ("torch", stream_cli.main, ["--device", "cpu"])):
        audio = str(tmp_path / f"{tag}.wav")
        write_wav(audio, wav[: SR], SR)
        reports[tag] = main(["--cfg", str(cfg), "--audio-file", audio, "--chunk-frames", "4"] + extra)
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == reports[tag]
        outs[tag], _ = read_wav(reports[tag]["out"])
    j, t = reports["jax"], reports["torch"]
    assert sorted(t) == sorted(j) == ["budget_ms", "latency_ms", "out", "push_p50_ms",
                                      "push_p95_ms", "rtf"]
    assert t["latency_ms"] == j["latency_ms"] == 128.0 and t["budget_ms"] == j["budget_ms"] == 64.0
    assert t["out"].endswith("torch_de.wav") and t["rtf"] > 0
    assert len(outs["torch"]) == len(outs["jax"]) == SR
    # both files are rounded to 16-bit PCM: one step on top
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=0,
                               atol=JAX_TOL * np.abs(outs["jax"]).max() + 1.0 / 32767)


def test_streamer_defaults_to_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    config, params, bn, _, _ = setup
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingDenoiser(config, params, bn)
