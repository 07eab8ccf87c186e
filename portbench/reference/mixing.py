"""The training mixes: clean speech plus a crop of a noise recording at a
target SNR (the reference's `AudioParser.add_noise`, noise longer than
the speech).

Which noise recording and which crop an utterance gets in an epoch are
seeded draws, documented as the loaders' contract and shared by the
host loader and the device cache: the recording is
`default_rng((seed, epoch)).integers(0, n_noise, size=n_items)[index]`,
the crop's start `default_rng((seed, epoch, index)).integers(0,
len(noise) - len(speech))` (0 when the lengths are equal).  The noise is
scaled so that sum(speech^2) / sum(noise^2) = 10^(snr / 10); every sum
and the mix are float64 here.
"""

from __future__ import annotations

import numpy as np


def noise_choice(seed: int, epoch: int, n_items: int, n_noise: int) -> np.ndarray:
    return np.random.default_rng((seed, epoch)).integers(0, n_noise, size=n_items)


def crop_start(seed: int, epoch: int, index: int, noise_len: int, speech_len: int) -> int:
    if noise_len == speech_len:
        return 0
    return int(np.random.default_rng((seed, epoch, index)).integers(0, noise_len - speech_len))


def mix(speech: np.ndarray, noise_crop: np.ndarray, snr_db: float) -> np.ndarray:
    s = np.asarray(speech, np.float64)
    n = np.asarray(noise_crop, np.float64)
    p_noise = float(np.dot(n, n))
    if p_noise <= 0.0:
        return s.copy()
    scale = np.sqrt(float(np.dot(s, s)) / 10.0 ** (snr_db / 10.0) / p_noise)
    return s + scale * n


def training_pairs(clean, noise, indices, seed: int, epoch: int, snr_db: float):
    """[(mix, clean)] float64 waveforms of dataset items `indices` in
    `epoch`; `clean` and `noise` are the corpora's float waveforms."""
    choice = noise_choice(seed, epoch, len(clean), len(noise))
    out = []
    for i in indices:
        s = clean[i]
        nz = noise[choice[i]]
        start = crop_start(seed, epoch, int(i), len(nz), len(s))
        out.append((mix(s, nz[start : start + len(s)], snr_db), np.asarray(s, np.float64)))
    return out
