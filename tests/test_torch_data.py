"""The port's host data pipeline against the JAX package's, on the same
manifests and seeds: manifests, SNR mixing, dataset items, the bucket
sampler and the loader's batches (float32 and int16 transport)."""

import numpy as np
import pytest

from conftest import make_corpus
from fullycnnspeechenhancement_tpu import config as jcfg
from fullycnnspeechenhancement_tpu import data as jdata

from fullycnnspeechenhancement_torch import config as tcfg
from fullycnnspeechenhancement_torch import data as tdata

SR = 8000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(str(tmp_path_factory.mktemp("corpus")))


def test_manifest_matches_jax(corpus):
    for kwargs in ({}, {"min_duration": 1.0}, {"max_duration": 1.5}):
        got = tdata.read_manifest(corpus["clean"], **kwargs)
        ref = jdata.read_manifest(corpus["clean"], **kwargs)
        assert [e.to_json() for e in got] == [e.to_json() for e in ref]
    entries = tdata.read_manifest(corpus["premixed"])
    assert all(e.is_premixed for e in entries)
    assert [e.clean_path for e in tdata.shard_for_host(entries, 1, 3)] == [
        e.clean_path for e in jdata.shard_for_host(jdata.read_manifest(corpus["premixed"]), 1, 3)
    ]
    with pytest.raises(ValueError):
        tdata.shard_for_host(entries, 3, 3)


@pytest.mark.parametrize("noise_len", [3000, 12000], ids=["tiled", "cropped"])
def test_mix_at_snr_matches_jax(noise_len):
    rng = np.random.default_rng(1)
    speech = (0.4 * np.sin(np.arange(8000) * 0.1)).astype(np.float32)
    noise = rng.standard_normal(noise_len).astype(np.float32)
    got = tdata.mix_at_snr(speech, noise, 5.0, np.random.default_rng(7))
    ref = jdata.mix_at_snr(speech, noise, 5.0, np.random.default_rng(7))
    np.testing.assert_array_equal(got, ref)
    added = got - speech
    np.testing.assert_allclose(10 * np.log10(np.sum(speech**2) / np.sum(added**2)), 5.0, atol=0.01)


@pytest.mark.parametrize("mode", ["noise", "premixed", "clean_only"])
def test_dataset_items_match_jax(corpus, mode):
    manifest = corpus["premixed"] if mode == "premixed" else corpus["clean"]
    noise = corpus["noise"] if mode == "noise" else None
    got = tdata.SpeechDataset(manifest, noise, SR, snr_db=0.0, seed=3)
    ref = jdata.SpeechDataset(manifest, noise, SR, snr_db=0.0, seed=3)
    assert len(got) == len(ref)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(got)):
            for a, b in zip(got[i], ref[i]):
                np.testing.assert_array_equal(a, b)
            assert got.num_frames(tcfg.DSPConfig(), i) == ref.num_frames(jcfg.DSPConfig(), i)


def test_bucket_sampler_plan_matches_jax(corpus):
    buckets = (64, 128, 256)
    got = tdata.BucketSampler(tdata.SpeechDataset(corpus["clean"], None, SR), tcfg.DSPConfig(),
                              batch_size=4, bucket_frames=buckets, seed=5)
    ref = jdata.BucketSampler(jdata.SpeechDataset(corpus["clean"], None, SR), jcfg.DSPConfig(),
                              batch_size=4, bucket_frames=buckets, seed=5)
    for epoch in range(3):
        plan = got.batches(epoch)
        assert plan == ref.batches(epoch)
        # static batch: a partial bucket repeats its tail items
        assert all(len(idxs) == 4 for _, idxs in plan)
    assert got.bucket_for(2000) == ref.bucket_for(2000) == 2048


@pytest.mark.parametrize("int16", [False, True], ids=["float32", "int16"])
def test_loader_batches_match_jax(corpus, int16):
    """Same manifests and seed, two epochs: every batch equal, in order."""

    def run(pkg, cfg):
        ds = pkg.SpeechDataset(corpus["clean"], corpus["noise"], SR, seed=4)
        loader = pkg.DataLoader(ds, cfg.DSPConfig(), batch_size=2, bucket_frames=(64, 128, 256),
                                num_workers=2, seed=4, int16_transport=int16)
        out = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            out.append(list(loader))
        return out, len(loader)

    got, n_got = run(tdata, tcfg)
    ref, n_ref = run(jdata, jcfg)
    assert n_got == n_ref == len(got[0]) > 1
    for eg, er in zip(got, ref):
        assert len(eg) == len(er)
        for bg, br in zip(eg, er):
            assert bg.bucket_frames == br.bucket_frames
            for field in ("mix_wav", "clean_wav", "lengths", "indices", "wav_scale"):
                a, b = getattr(bg, field), getattr(br, field)
                if b is None:
                    assert a is None
                else:
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b, err_msg=field)
    if int16:
        assert got[0][0].mix_wav.dtype == np.int16 and got[0][0].wav_scale.shape == (2,)


def test_loader_stops_its_producer_when_abandoned(corpus):
    ds = tdata.SpeechDataset(corpus["clean"], corpus["noise"], SR, seed=1)
    loader = tdata.DataLoader(ds, tcfg.DSPConfig(), batch_size=1, bucket_frames=(256,),
                              num_workers=1, prefetch=1, seed=1)
    it = iter(loader)
    first = next(it)
    assert first.mix_wav.shape == (1, tcfg.DSPConfig().padded_samples(256))
    it.close()  # runs the generator's finally: stop and drain
