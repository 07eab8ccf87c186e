"""The traffic generator: repeatable for a seed, the same lengths for
every seed, and the stated length laws."""

import numpy as np
import pytest

from portbench import gen, spec
from portbench.run import ROOT


def _mix(name):
    return spec.load(ROOT, {"aishell1-utterances": "rced16-train-cached",
                            "recordings-long": "rced16-denoise-long"}[name]).traffic


def test_training_corpus_repeats_for_a_seed_and_keeps_its_lengths():
    mix = _mix("aishell1-utterances") | {"noise_s": 20.0, "utterance_s": {
        "law": "lognormal", "mean": 4.5, "sigma_log": 0.35, "min": 1.5, "max": 14.5}}
    a_clean, a_noise = gen.training_corpus(mix, 256, 2**31 + 11)
    b_clean, b_noise = gen.training_corpus(mix, 256, 2**31 + 11)
    c_clean, _ = gen.training_corpus(mix, 256, 7)
    assert all(np.array_equal(x, y) for x, y in zip(a_clean + a_noise, b_clean + b_noise))
    assert sorted(map(len, a_clean)) == sorted(map(len, c_clean))
    assert [len(x) for x in a_clean] != [len(x) for x in c_clean]
    assert not np.array_equal(a_clean[0][:1000], c_clean[0][:1000])
    assert all(x.dtype == np.int16 for x in a_clean + a_noise)
    assert len(a_noise) == mix["noise_recordings"] and all(len(x) == 20 * gen.SR for x in a_noise)


def test_aishell_lengths_follow_the_stated_law():
    c = spec.load(ROOT, "rced16-train-cached")
    s = gen.lengths_s(c.traffic["utterance_s"], c.config["train_utterances"])
    assert len(s) == 4096 and np.all(s == 4.5)  # AISHELL-1's published mean, and no spread


@pytest.mark.parametrize("law,mean,sigma", [
    ({"law": "lognormal", "mean": 4.5, "sigma_log": 0.35, "min": 1.5, "max": 14.5}, 4.5, 0.35),
    ({"law": "lognormal", "median": 4.0, "sigma_log": 0.6, "min": 0.1, "max": 100.0}, 4.0 * np.exp(0.18), 0.6),
])
def test_lognormal_lengths_keep_their_mean_and_spread(law, mean, sigma):
    s = gen.lengths_s(law, 4096)
    assert s.min() >= law["min"] and s.max() <= law["max"]
    assert abs(s.mean() - mean) / mean < 0.01
    assert abs(np.std(np.log(s)) - sigma) < 0.01


@pytest.mark.parametrize("law,lo,hi,median", [
    ({"law": "lognormal", "median": 4.0, "sigma_log": 0.6, "min": 1.0, "max": 30.0}, 1.0, 30.0, 4.0),
    ({"law": "uniform", "min": 60.0, "max": 300.0}, 60.0, 300.0, 180.0),
])
def test_request_lengths_follow_the_stated_law(law, lo, hi, median):
    s = gen.lengths_s(law, 256)
    assert s.min() >= lo and s.max() <= hi
    assert abs(np.median(s) - median) / median < 0.02


def test_the_long_recordings_are_switchboards_mean_call():
    mix = _mix("recordings-long")
    s = gen.lengths_s(mix["request_s"], mix["pool"])
    assert np.all(s == 390.0)  # about 260 h over about 2,400 calls
    assert {int(np.ceil(x / 32.0)) * 32 for x in s} == {416}  # the engine pads past 32 s to multiples of 32 s


def test_request_pool_repeats_for_a_seed_and_orders_every_recording():
    mix = _mix("recordings-long") | {"pool": 16, "request_s": {"law": "uniform", "min": 1.0, "max": 3.0}}
    a, b, c = gen.request_pool(mix, 2**31 + 3), gen.request_pool(mix, 2**31 + 3), gen.request_pool(mix, 5)
    assert all(np.array_equal(x, y) for x, y in zip(a.pool, b.pool))
    assert np.array_equal(a.order, b.order)
    assert sorted(a.order) == list(range(16))
    assert sorted(map(len, a.pool)) == sorted(map(len, c.pool))
    # speech plus noise at the mix's SNR: not the speech alone
    assert all(x.dtype == np.float32 and np.isfinite(x).all() for x in a.pool)
