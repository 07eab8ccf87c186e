"""The port's speech-quality metrics against the JAX package's on identical
arrays (the same numpy code, so equal to 1e-12 or exactly), against the
committed STOI fixture, and PESQ's resolution order.  PESQ through the
native runtime skips only where g++ is missing (test_torch_native.py)."""

import os
import shutil
import sys
import types

import numpy as np
import pytest

from fullycnnspeechenhancement_tpu.eval import metrics as jmetrics

from fullycnnspeechenhancement_torch.data import native
from fullycnnspeechenhancement_torch.eval import metrics
from fullycnnspeechenhancement_torch.eval import (
    PESQ,
    SDR,
    STOI,
    AverageMeter,
    mos_lqo,
    mos_lqo_inverse,
    sdr,
    stoi,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 8000


def _speechlike(seconds=3.0, sr=SR, seed=0):
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    carrier = lfilter([1.0], [1.0, -0.9], rng.standard_normal(n))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 4.0 * t)
    return (env * carrier).astype(np.float32)


def _noisy(y, scale, seed):
    return (y + scale * np.random.default_rng(seed).standard_normal(len(y))).astype(np.float32)


@pytest.fixture(scope="module")
def golden():
    blob = np.load(os.path.join(REPO, "tests", "fixtures", "stoi_golden.npz"))
    return dict(zip(blob["names"].tolist(), blob["scores"].tolist()))


@pytest.fixture(scope="module")
def pairs():
    from gen_stoi_fixtures import make_pairs

    return list(make_pairs())


@pytest.mark.parametrize("i", range(10))
def test_stoi_matches_the_golden_fixture_and_jax(golden, pairs, i):
    """Each of the fixture's 10 conditions: atol 1e-6 to the committed
    oracle score (the JAX test's tolerance) and 1e-12 to JAX's `stoi`."""
    assert len(pairs) == len(golden) == 10
    name, clean, degraded = pairs[i]
    got = stoi(clean, degraded, SR)
    np.testing.assert_allclose(got, golden[name], atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got, jmetrics.stoi(clean, degraded, SR), rtol=0, atol=1e-12)


@pytest.mark.parametrize("sr", [8000, 16000])
def test_stoi_matches_jax_at_each_rate(sr):
    """16 kHz goes through the port's own resample to 10 kHz."""
    y = _speechlike(2.0, sr=sr, seed=1)
    for scale in (0.0, 0.1, 1.0):
        got = STOI(sr)(y, _noisy(y, scale, 2))
        np.testing.assert_allclose(got, jmetrics.stoi(y, _noisy(y, scale, 2), sr), rtol=0, atol=1e-12)
    assert STOI(sr)(y, y) == pytest.approx(1.0, abs=1e-6)


def test_stoi_short_signal_returns_the_sentinel():
    quiet = np.zeros(int(0.4 * SR), np.float32)
    quiet[: int(0.05 * SR)] = 0.3
    with pytest.warns(UserWarning, match="too short"):
        assert stoi(quiet, quiet, SR) == 1e-5


def test_stoi_helpers_match_jax():
    np.testing.assert_array_equal(metrics._third_octave_bands(), jmetrics._third_octave_bands())
    np.testing.assert_array_equal(metrics._stoi_window(), jmetrics._stoi_window())
    x = _speechlike(1.0, seed=3).astype(np.float64)
    y = _noisy(x, 0.2, 4).astype(np.float64)
    np.testing.assert_array_equal(metrics._stft_frames(x), jmetrics._stft_frames(x))
    for g, r in zip(metrics._remove_silent_frames(x, y), jmetrics._remove_silent_frames(x, y)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("scale", [0.0, 0.01, 0.3, 3.0])
def test_sdr_matches_jax(scale):
    y = _speechlike(1.0, seed=5)
    est = _noisy(y, scale, 6)
    assert sdr(y, est) == jmetrics.sdr(y, est) == SDR()(y, est)
    num = np.sum(y.astype(np.float32) ** 2)
    den = np.sum((est - y) ** 2) + np.finfo(np.float32).eps
    np.testing.assert_allclose(sdr(y, est), 10 * np.log10(num / den), rtol=1e-6)


def test_mos_lqo_and_its_inverse_match_jax():
    xs = np.linspace(-0.5, 4.5, 51)
    ys = [mos_lqo(x) for x in xs]
    assert ys == [jmetrics.mos_lqo(x) for x in xs]
    assert all(a < b for a, b in zip(ys, ys[1:]))
    assert all(0.999 < y < 4.999 for y in ys)
    np.testing.assert_allclose(mos_lqo(4.6607 / 1.4945), 2.999, atol=1e-12)
    for x, y in zip(xs, ys):
        assert mos_lqo_inverse(y) == jmetrics.mos_lqo_inverse(y)
        np.testing.assert_allclose(mos_lqo_inverse(y), x, atol=1e-9)


def test_proxy_is_monotone_and_matches_jax():
    y = _speechlike()
    scores = []
    for scale in (0.001, 0.1, 1.0):
        d = _noisy(y, scale, 2)
        s = metrics._fwseg_snr_mos_proxy(y, d, SR)
        assert s == jmetrics._fwseg_snr_mos_proxy(y, d, SR)
        scores.append(s)
    assert scores[0] > scores[1] > scores[2]
    assert 1.0 <= scores[2] <= scores[0] <= 4.5


def _fake_module(name, fn):
    mod = types.ModuleType(name)
    mod.pesq = fn
    return mod


def _no_module(monkeypatch, name):
    """Make `import name` raise ImportError."""
    monkeypatch.setitem(sys.modules, name, None)


@pytest.mark.parametrize("sr", [8000, 16000])
def test_pesq_resolution_order_matches_jax(monkeypatch, sr):
    """pypesq first, then pesq (nb at 8 kHz, wb otherwise), then the native
    P.862 code, then the proxy only with allow_proxy=True; the same
    `implementation` strings and calls as the JAX package's PESQ."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: the native runtime is built from source")
    a, b = _speechlike(1.0, seed=7), _speechlike(1.0, seed=8)
    calls = []
    monkeypatch.setitem(sys.modules, "pypesq", _fake_module("pypesq", lambda x, y, fs: calls.append(fs) or 1.5))
    monkeypatch.setitem(sys.modules, "pesq", _fake_module("pesq", lambda fs, x, y, mode: calls.append(mode) or 2.5))
    for cls in (PESQ, jmetrics.PESQ):
        p = cls(sr=sr)
        assert (p.implementation, p.available, p(a, b)) == ("pypesq", True, 1.5)
    assert calls == [sr, sr]
    # a stubbed, non-callable pypesq is skipped
    monkeypatch.setitem(sys.modules, "pypesq", _fake_module("pypesq", None))
    mode = "nb" if sr == 8000 else "wb"
    for cls in (PESQ, jmetrics.PESQ):
        p = cls(sr=sr)
        assert (p.implementation, p(a, b)) == ("pesq", 2.5)
    assert calls[-2:] == [mode, mode]
    _no_module(monkeypatch, "pypesq")
    _no_module(monkeypatch, "pesq")
    got, ref = PESQ(sr=sr), jmetrics.PESQ(sr=sr)
    assert got.implementation == ref.implementation == "p862-native"
    assert got.available and not got.is_proxy
    assert got(a, b) == ref(a, b)
    # no native runtime either: nothing, or the labelled proxy
    monkeypatch.setattr(native, "native_available", lambda: False)
    none = PESQ(sr=sr)
    assert (none.implementation, none.available) == ("none", False)
    with pytest.raises(RuntimeError, match="allow_proxy"):
        none(a, b)
    proxy = PESQ(sr=sr, allow_proxy=True)
    assert (proxy.implementation, proxy.is_proxy, proxy.available) == ("fwsegsnr-proxy", True, False)
    assert proxy(a, b) == metrics._fwseg_snr_mos_proxy(a, b, sr)


def test_average_meter():
    m = AverageMeter()
    for v in [1.0, 2.0, 3.0]:
        m.update(v)
    assert (m.avg, m.sum, m.count, m.val) == (2.0, 6.0, 3, 3.0)
    m.reset()
    assert m.avg == 0.0 and m.count == 0
