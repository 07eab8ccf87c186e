"""The one traffic generator: reads a mix's parameters (`traffic/<mix>.json`)
and makes its audio from the run's seed.

Lengths are the same for every seed: the quantiles (i + 0.5) / N of the
mix's length law, clipped to its range; the seed draws their order and
the audio.  So every seed brings the same amount of work, in another
order, and two runs of one seed bring the same inputs.

The audio is synthetic and cheap to make in bulk: "speech" is a bank of
harmonics of a wandering pitch under a syllable-rate envelope plus a
little white noise, and each utterance a crop of the bank at a seeded
offset, gain and polarity; "noise" is white noise through a one-pole
filter of seeded colour under a slow level wander.  Values are 16-bit
PCM (int16), which is what a training corpus holds on disk.
"""

from __future__ import annotations

import json
import os
from statistics import NormalDist
from typing import List, NamedTuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import lfilter

SR = 8000
BANK_S = 120.0


def lengths_s(law: dict, n: int) -> np.ndarray:
    """The n quantiles (i + 0.5) / n of a length law, clipped to [min, max]:
    {"law": "lognormal", "mean" or "median", "sigma_log"} or {"law":
    "uniform"}."""
    q = (np.arange(n) + 0.5) / n
    if law["law"] == "uniform":
        x = law["min"] + q * (law["max"] - law["min"])
    elif law["law"] == "lognormal":
        s = law["sigma_log"]
        mu = np.log(law["median"]) if "median" in law else np.log(law["mean"]) - s * s / 2
        z = np.array([NormalDist().inv_cdf(v) for v in q])
        x = np.exp(mu + s * z)
    else:
        raise ValueError(f"unknown length law {law['law']}")
    return np.clip(x, law["min"], law["max"])


def _to_i16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * np.float32(32767.0)), -32768, 32767).astype(np.int16)


def speech_bank(rng: np.random.Generator, seconds: float = BANK_S) -> np.ndarray:
    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(110, 170) + 30 * np.sin(2 * np.pi * rng.uniform(0.4, 0.9) * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(k * phase) / k for k in range(1, 12))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3.0, 4.5) * t) ** 2
    return 0.15 * env * voiced + 0.05 * rng.standard_normal(len(t))


def noise_recording(rng: np.random.Generator, seconds: float) -> np.ndarray:
    n = int(seconds * SR)
    colored = lfilter([1.0], [1.0, -rng.uniform(-0.9, 0.95)], rng.standard_normal(n))
    colored *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.05, 0.3) * np.arange(n) / SR)
    return 0.1 * colored / np.abs(colored).max()


def crops(rng: np.random.Generator, bank: np.ndarray, samples: np.ndarray) -> List[np.ndarray]:
    """One seeded crop of `bank` per length (the bank tiled where a crop
    is longer), each at a seeded gain in [0.5, 1] and polarity, float32."""
    longest = int(max(samples))
    if longest > len(bank):
        bank = np.tile(bank, -(-longest // len(bank)))
    bank = bank.astype(np.float32)
    starts = rng.integers(0, len(bank) - samples + 1)
    gains = (rng.uniform(0.5, 1.0, len(samples)) * rng.choice((-1.0, 1.0), len(samples))).astype(np.float32)
    return [bank[s : s + int(n)] * g for s, n, g in zip(starts, samples, gains)]


class Corpus(NamedTuple):
    clean: List[np.ndarray]  # int16 utterances, in manifest order
    noise: List[np.ndarray]  # int16 noise recordings, in manifest order
    clean_manifest: str
    noise_manifest: str


def training_corpus(mix: dict, utterances: int, seed: int) -> List[List[np.ndarray]]:
    """(clean utterances, noise recordings) as int16 arrays: `utterances`
    of them (the configuration's training split, as far as it is run)."""
    rng = np.random.default_rng((seed, 1))
    samples = np.round(lengths_s(mix["utterance_s"], utterances) * SR).astype(np.int64)
    samples = samples[rng.permutation(len(samples))]
    clean = [_to_i16(x) for x in crops(rng, speech_bank(rng), samples)]
    noise = [_to_i16(noise_recording(rng, mix["noise_s"])) for _ in range(mix["noise_recordings"])]
    return clean, noise


def write_corpus(root: str, clean, noise) -> Corpus:
    """Write 16-bit wav files and the two JSONL manifests under `root`."""
    os.makedirs(root, exist_ok=True)

    def write(kind, arrays):
        path = os.path.join(root, f"{kind}.jsonl")
        with open(path, "w") as f:
            for i, a in enumerate(arrays):
                wav = os.path.join(root, f"{kind}_{i}.wav")
                wavfile.write(wav, SR, a)
                f.write(json.dumps({"audio_filepath": wav, "duration": len(a) / SR}) + "\n")
        return path

    return Corpus(clean, noise, write("clean", clean), write("noise", noise))


class Requests(NamedTuple):
    pool: List[np.ndarray]  # float32 recordings: speech plus noise at the mix's SNR
    order: np.ndarray  # the pool index of request k is order[k % len(order)]


def request_pool(mix: dict, seed: int) -> Requests:
    rng = np.random.default_rng((seed, 2))
    samples = np.round(lengths_s(mix["request_s"], mix["pool"]) * SR).astype(np.int64)
    speech = crops(rng, speech_bank(rng), samples)
    noise = crops(rng, noise_recording(rng, BANK_S), samples)
    pool = []
    for s, n in zip(speech, noise):
        s64, n64 = s.astype(np.float64), n.astype(np.float64)
        scale = np.sqrt(np.dot(s64, s64) / 10.0 ** (mix["snr_db"] / 10.0) / np.dot(n64, n64))
        pool.append((s64 + scale * n64).astype(np.float32))
    return Requests(pool, rng.permutation(len(pool)))
