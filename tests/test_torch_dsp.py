"""The port's DSP, config and audio I/O against the JAX package and the
float64 numpy oracle, on the CPU, from the same numpy inputs."""

import dataclasses
import glob
import logging
import os

import jax
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

import fullycnnspeechenhancement_tpu.config as jcfg
from fullycnnspeechenhancement_tpu.data import audio_io as j_audio
from fullycnnspeechenhancement_tpu.dsp import features as j_features
from fullycnnspeechenhancement_tpu.dsp import rebuild as j_rebuild
from fullycnnspeechenhancement_tpu.dsp import windows as j_windows

import fullycnnspeechenhancement_torch.config as tcfg
from fullycnnspeechenhancement_torch.data import audio_io as t_audio
from fullycnnspeechenhancement_torch.dsp import features as t_features
from fullycnnspeechenhancement_torch.dsp import rebuild as t_rebuild
from fullycnnspeechenhancement_torch.dsp import reference_dsp, windows as t_windows
from test_torch_cuda import one_cpu_thread_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_CFG = jcfg.DSPConfig()
T_CFG = tcfg.DSPConfig()


def _ragged_batch(seed=0, lengths=(8000, 6100, 3333)):
    rng = np.random.default_rng(seed)
    wav = np.zeros((len(lengths), max(lengths)), np.float32)
    for i, n in enumerate(lengths):
        wav[i, :n] = 0.3 * rng.standard_normal(n)
    return wav, np.asarray(lengths, np.int32)


def _spectra(seed, B=2, T=24, F=129):
    rng = np.random.default_rng(seed)
    mag = (rng.random((B, T, F)) + 0.1).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (B, T, F))
    return mag, np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def test_extractor_matches_jax_on_ragged_batch():
    wav, lengths = _ragged_batch()
    j_ext = j_features.SpectrogramExtractor(J_CFG)
    t_ext = t_features.SpectrogramExtractor(T_CFG)
    jm, jre, jim = (np.asarray(a) for a in j_ext.magnitude_and_phase(wav, lengths))
    tm, tre, tim = (
        a.numpy()
        for a in t_ext.magnitude_and_phase(torch.as_tensor(wav), torch.as_tensor(lengths))
    )
    assert tm.shape == jm.shape == (3, T_CFG.num_frames(8000), 129)
    np.testing.assert_allclose(tm, jm, rtol=1e-4, atol=1e-4)
    # unit phase: the tolerance of the JAX package's own phase test
    np.testing.assert_allclose(tre, jre, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(tim, jim, rtol=1e-3, atol=2e-3)
    T = tm.shape[1]
    tl = torch.as_tensor(lengths)
    np.testing.assert_array_equal(t_ext.frame_counts(tl).numpy(), np.asarray(j_ext.frame_counts(lengths)))
    np.testing.assert_array_equal(t_ext.frame_mask(tl, T).numpy(), np.asarray(j_ext.frame_mask(lengths, T)))
    bm = t_ext.batch_max_frame_mask(tl, T).numpy()
    assert bm.shape == (1, T)
    np.testing.assert_array_equal(bm, np.asarray(j_ext.batch_max_frame_mask(lengths, T)))


def test_extractor_matches_reference_dsp():
    wav, lengths = _ragged_batch(seed=1)
    mags = t_features.SpectrogramExtractor(T_CFG)(
        torch.as_tensor(wav), torch.as_tensor(lengths)
    ).numpy()
    for i, n in enumerate(lengths):
        golden = reference_dsp.analyze(wav[i, :n], 8000, 0.032, 0.016, 256).T
        t = golden.shape[0]
        np.testing.assert_allclose(mags[i, :t], golden, rtol=1e-4, atol=2e-4)
        np.testing.assert_array_equal(mags[i, t:], 0.0)


@pytest.mark.parametrize("mode", ["reference", "overlap_add"])
def test_rebuild_matches_jax(mode):
    mag, pre, pim = _spectra(seed=2)
    ref = np.asarray(jax.jit(j_rebuild.WaveformRebuilder(J_CFG, mode=mode))(mag, pre, pim))
    got = t_rebuild.WaveformRebuilder(T_CFG, mode=mode)(
        torch.as_tensor(mag), torch.as_tensor(pre), torch.as_tensor(pim)
    ).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_rebuild_reference_mode_matches_numpy_oracle():
    mag, pre, pim = _spectra(seed=3)
    golden = reference_dsp.rebuild_batch(mag, pre + 1j * pim, 8000, 32, 16)
    got = t_rebuild.WaveformRebuilder(T_CFG)(
        torch.as_tensor(mag), torch.as_tensor(pre), torch.as_tensor(pim)
    ).numpy()
    assert got.shape == golden.shape
    np.testing.assert_allclose(got, golden, rtol=1e-3, atol=2e-3)


def test_rebuild_audio_numpy_matches_jax():
    mag, pre, pim = _spectra(seed=5)
    args = ([3000, 2222], mag, pre + 1j * pim, 8000, 32, 16)
    got = t_rebuild.rebuild_audio_numpy(*args)
    ref = j_rebuild.rebuild_audio_numpy(*args)
    assert [len(g) for g in got] == [3000, 2222]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_de_emphasis_matches_lfilter_at_32s():
    x = np.random.default_rng(4).standard_normal(32 * 8000).astype(np.float32)
    ref = lfilter([1.0], [1.0, -0.97], x.astype(np.float64))
    got = t_rebuild.de_emphasis(torch.as_tensor(x[None]), 0.97)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_dft_bases_match_jax():
    np.testing.assert_array_equal(t_features.dft_basis(256, 256), j_features.dft_basis(256, 256))
    w = j_windows.make_window("hamming", 256)
    np.testing.assert_array_equal(
        t_rebuild.inverse_dft_basis(512, 129, 256, w), j_rebuild.inverse_dft_basis(512, 129, 256, w)
    )


@pytest.mark.parametrize("name", ["hamming", "hanning", "blackman", "bartlett", "unknown"])
def test_windows_match_jax(name):
    np.testing.assert_array_equal(t_windows.make_window(name, 256), j_windows.make_window(name, 256))


CFG_FILES = sorted(glob.glob(os.path.join(REPO, "work", "*", "cfg", "*.cfg")))


@pytest.mark.parametrize("path", CFG_FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_load_ini_config_matches_jax(path):
    assert dataclasses.asdict(tcfg.load_ini_config(path)) == dataclasses.asdict(
        jcfg.load_ini_config(path)
    )


def test_ini_quirk_warnings(tmp_path, caplog):
    ini = tmp_path / "q.cfg"
    ini.write_text("[data]\nwindows=hanning\nnfft=512\n[model]\nnet_work=FullyCNNV3\n")
    with caplog.at_level(logging.WARNING):
        cfg = tcfg.load_ini_config(str(ini))
    text = caplog.text
    assert "windows=hanning" in text and "nfft=512" in text
    assert cfg.dsp.window_name == "hamming" and cfg.dsp.analysis_nfft == 256
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg.load_ini_config(str(ini)))


def test_audio_io_matches_jax(tmp_path):
    sig = (0.5 * np.sin(np.arange(4410) / 7.0)).astype(np.float32)
    path = str(tmp_path / "a.wav")
    t_audio.write_wav(path, sig, 44100)
    got, sr = t_audio.read_wav(path, 8000)
    ref, jsr = j_audio.read_wav(path, 8000)
    assert sr == jsr == 8000
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(t_audio.resample(sig, 16000, 8000), j_audio.resample(sig, 16000, 8000))
