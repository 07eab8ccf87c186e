"""The port's native host runtime against the JAX package's binding, on the
same inputs: its sources, where its library is built, decode, resample,
SNR mixing, the fused item preparation, PESQ with its indicators (and the
committed regression fixture), and `SpeechDataset(use_native=True)`.

The port builds its library from its own copies of the sources with g++ on
first use; the tests skip only where g++ is missing, and a failed build
where g++ exists fails them."""

import os
import shutil
import threading

import numpy as np
import pytest

from conftest import make_corpus
from fullycnnspeechenhancement_tpu.data import native as jnative
from fullycnnspeechenhancement_tpu.data.dataset import SpeechDataset as JDataset

from fullycnnspeechenhancement_torch import config as tcfg
from fullycnnspeechenhancement_torch.data import native
from fullycnnspeechenhancement_torch.data.audio_io import read_wav, write_wav
from fullycnnspeechenhancement_torch.data.dataset import SpeechDataset
from fullycnnspeechenhancement_torch.eval.metrics import PESQ

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "fullycnnspeechenhancement_torch")
SR = 8000


@pytest.fixture(scope="module")
def runtime():
    """The port's library, built here if need be.  Skips where g++ is
    missing (nothing can build it); where g++ exists the build must work."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: the native runtime is built from source")
    assert native.native_available(), "the native runtime failed to build with g++"
    assert jnative.native_available(), "the JAX package's committed library did not load"
    return native


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("native_corpus")))


def _speechlike(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 4.0 * t)
    return (env * (0.3 * np.sin(2 * np.pi * 230 * t) + 0.1 * rng.standard_normal(n))).astype(np.float32)


def _code(line):
    return line.split("//", 1)[0].rstrip()


@pytest.mark.parametrize("name", ["fcse_runtime.cc", "pesq862.cc"])
def test_runtime_sources_are_the_jax_packages(name):
    """Line for line the JAX package's source: every line's code is equal,
    and only comment text may differ (pesq862.cc's header names the
    reference's checkout by the reference's own path, which the port's
    copy does not repeat)."""
    with open(os.path.join(PORT, "runtime", name)) as f:
        ours = f.read().splitlines()
    with open(os.path.join(REPO, "fullycnnspeechenhancement_tpu", "runtime", name)) as f:
        theirs = f.read().splitlines()
    assert len(ours) == len(theirs)
    assert [_code(x) for x in ours] == [_code(x) for x in theirs]
    assert sum(x != y for x, y in zip(ours, theirs)) <= 1


def test_library_is_built_under_the_port(runtime):
    path = os.path.realpath(runtime.library_path())
    assert path.startswith(os.path.realpath(PORT) + os.sep)
    assert os.path.exists(path)
    assert runtime._lib._name == str(runtime.library_path())
    assert not any(os.path.realpath(runtime.RUNTIME_DIR / n).startswith(
        os.path.join(REPO, "fullycnnspeechenhancement_tpu")) for n in runtime.SOURCES)


def test_library_name_follows_flags_and_host_target(runtime, monkeypatch):
    """The library's name changes with the target `-march=native` resolves
    to and with the flags, so a build directory carried to another host is
    rebuilt there rather than loaded."""
    here = runtime.library_path()
    real_run = native.subprocess.run

    def other_host(cmd, **kw):
        out = real_run(cmd, **kw)
        return native.subprocess.CompletedProcess(cmd, 0, out.stdout + "  -mavx512f [enabled]\n", "")

    monkeypatch.setattr(native, "_key", None)
    monkeypatch.setattr(native.subprocess, "run", other_host)
    assert native.library_path() != here
    monkeypatch.setattr(native, "_key", None)
    monkeypatch.setattr(native.subprocess, "run", real_run)
    assert native.library_path() == here
    monkeypatch.setattr(native, "_key", None)
    monkeypatch.setattr(native, "CXXFLAGS", (*native.CXXFLAGS, "-g"))
    assert native.library_path() != here


def test_concurrent_builds_leave_one_library(runtime, tmp_path, monkeypatch):
    """Builders racing on an empty build directory each get the whole
    library, and no temporary file is left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def go():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=go) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path
    assert os.listdir(tmp_path) == [paths[0].name]


@pytest.mark.parametrize("rate", [8000, 16000])
def test_decode_matches_jax(runtime, tmp_path, rate):
    sig = (0.8 * np.random.default_rng(0).standard_normal(12345)).clip(-1, 1).astype(np.float32)
    p = str(tmp_path / "x.wav")
    write_wav(p, sig, rate)
    got, sr = runtime.decode_wav(p)
    ref, sr_ref = jnative.decode_wav(p)
    assert sr == sr_ref == rate
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, read_wav(p)[0])
    with pytest.raises(IOError):
        runtime.decode_wav(str(tmp_path / "missing.wav"))


@pytest.mark.parametrize("rates", [(16000, 8000), (16000, 11025), (8000, 10000)])
def test_resample_matches_jax(runtime, rates):
    sig = np.random.default_rng(1).standard_normal(16000).astype(np.float32)
    got = runtime.resample(sig, *rates)
    np.testing.assert_array_equal(got, jnative.resample(sig, *rates))


@pytest.mark.parametrize("noise_len", [3000, 12000], ids=["tiled", "cropped"])
def test_mix_at_snr_matches_jax(runtime, noise_len):
    sig = _speechlike(8000, 2)
    noise = np.random.default_rng(3).standard_normal(noise_len).astype(np.float32)
    got = runtime.mix_at_snr(sig, noise, 3.0, seed=7)
    np.testing.assert_array_equal(got, jnative.mix_at_snr(sig, noise, 3.0, seed=7))
    snr = 10 * np.log10((sig**2).sum() / ((got - sig) ** 2).sum())
    np.testing.assert_allclose(snr, 3.0, atol=0.05)


@pytest.mark.parametrize("case", ["noise", "clean_only", "resampled"])
def test_prepare_item_matches_jax(runtime, corpus, tmp_path, case):
    clean = os.path.join(os.path.dirname(corpus["clean"]), "clean_3.wav")
    noise = os.path.join(os.path.dirname(corpus["clean"]), "noise_1.wav")
    if case == "resampled":
        clean = str(tmp_path / "c16.wav")
        write_wav(clean, _speechlike(16000, 4), 16000)
    noise_path = None if case == "clean_only" else noise
    got = runtime.prepare_item(clean, noise_path, SR, 5.0, 12345)
    ref = jnative.prepare_item(clean, noise_path, SR, 5.0, 12345)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    with pytest.raises(IOError):
        runtime.prepare_item(str(tmp_path / "missing.wav"), None, SR, 0.0, 1)


@pytest.mark.parametrize("snr_db", [None, 20.0, 5.0])
def test_pesq_nb_matches_jax_with_indicators(runtime, snr_db):
    ref_sig = _speechlike(3 * SR, 5)
    deg = ref_sig.copy()
    if snr_db is not None:
        noise = np.random.default_rng(6).standard_normal(len(ref_sig)).astype(np.float32)
        deg = deg + np.sqrt((ref_sig**2).sum() / (10 ** (snr_db / 10) * (noise**2).sum())) * noise
    got = runtime.pesq_nb(ref_sig, deg, return_indicators=True)
    assert got == jnative.pesq_nb(ref_sig, deg, return_indicators=True)
    assert runtime.pesq_nb(ref_sig, deg) == got[0]
    assert -0.5 <= got[0] <= 4.5


def test_pesq_nb_rejects_too_short(runtime):
    with pytest.raises(ValueError):
        runtime.pesq_nb(np.zeros(100, np.float32), np.zeros(100, np.float32))


def test_pesq_reproduces_the_native_regression_fixture(runtime):
    """The port's PESQ (p862-native, the active implementation here) on the
    anchor conditions of tests/fixtures/pesq_native_regression.npz, at the
    JAX test's atol 1e-9."""
    from gen_pesq_anchor_fixtures import conditions

    data = np.load(os.path.join(REPO, "tests", "fixtures", "pesq_native_regression.npz"))
    frozen = dict(zip([str(n) for n in data["names"]], data["scores"]))
    p = PESQ(sr=SR)
    assert p.implementation == "p862-native" == str(data["implementation"])
    seen = 0
    for name, clean, degraded in conditions():
        np.testing.assert_allclose(p(clean, degraded), frozen[name], rtol=0, atol=1e-9, err_msg=name)
        seen += 1
    assert seen == len(frozen)


@pytest.mark.parametrize("mode", ["noise", "premixed", "clean_only"])
def test_dataset_native_items_match_jax(runtime, corpus, mode):
    manifest = corpus["premixed"] if mode == "premixed" else corpus["clean"]
    noise = corpus["noise"] if mode == "noise" else None
    ours = SpeechDataset(manifest, noise, SR, snr_db=2.0, seed=1, use_native=True)
    ref = JDataset(manifest, noise, SR, snr_db=2.0, seed=1, use_native=True)
    assert ours.use_native and len(ours) == len(ref)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ours)):
            for g, r in zip(ours[i], ref[i]):
                np.testing.assert_array_equal(g, r)


def test_use_native_wired_from_config(runtime, corpus, tmp_path):
    """[data] use_native flows INI -> DataConfig -> SpeechDataset, and the
    premixed items (no randomness) equal the Python path's."""
    ini = tmp_path / "native.cfg"
    ini.write_text(
        "[training]\nepochs = 1\n\n[model]\nnet_work = FullyCNN\n\n"
        f"[data]\ntrain_manifest_path = {corpus['premixed']}\n"
        "use_native = True\nsample_rate = 8000\n"
    )
    cfg = tcfg.load_ini_config(str(ini))
    assert cfg.data.use_native is True
    ds = SpeechDataset.from_config(cfg.data, cfg.dsp, "train")
    assert ds.use_native
    plain = SpeechDataset(corpus["premixed"], None, SR)
    for g, r in zip(ds[0], plain[0]):
        np.testing.assert_array_equal(g, r)


def test_use_native_raises_without_the_runtime(corpus, monkeypatch):
    monkeypatch.setattr(native, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="native runtime"):
        SpeechDataset(corpus["clean"], None, SR, use_native=True)
