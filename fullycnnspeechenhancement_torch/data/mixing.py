"""On-the-fly clean+noise mixing at a target SNR.

The port's own copy of `fullycnnspeechenhancement_tpu/data/mixing.py`.
Randomness stays a numpy Generator, as in the JAX package, so the same
seed gives the same mixes in both packages.

Behavioural contract from the reference's `AudioParser.add_noise`
(`data_utils/data_loader.py:35-52`):
  * noise shorter than speech: grow it by repeated self-doubling, each
    doubling appending the accumulated buffer scaled by an i.i.d.
    uniform(0, 2) gain (the reference concatenates the *accumulated*
    noise with a scaled copy of itself, so coverage doubles per
    iteration), iterating ceil((len(speech)-len(noise))/len(noise))
    times, then truncate;
  * noise longer: take a random crop;
  * scale noise so that sum(speech^2) / sum(noise_scaled^2) == 10^(snr/10),
    then add.

Departure (documented): randomness flows through an explicit
numpy Generator so epochs are reproducible under a seed -- the reference
uses the global unseeded RNG (SURVEY.md Appendix A.16).
"""

from __future__ import annotations

import numpy as np


def mix_at_snr(
    speech: np.ndarray,
    noise: np.ndarray,
    snr_db: float,
    rng: np.random.Generator,
) -> np.ndarray:
    speech = np.asarray(speech, dtype=np.float32)
    noise = np.asarray(noise, dtype=np.float32)
    if len(speech) >= len(noise):
        diff = len(speech) - len(noise)
        for _ in range(int(np.ceil(diff / len(noise)))):
            noise = np.concatenate([noise, noise * rng.uniform(0.0, 2.0)])
        noise = noise[: len(speech)]
    else:
        start = rng.integers(0, len(noise) - len(speech))
        noise = noise[start : start + len(speech)]

    p_sig = np.sum(np.square(speech, dtype=np.float64))
    p_noise = np.sum(np.square(noise, dtype=np.float64))
    if p_noise <= 0.0:
        return speech.copy()
    target_noise_power = p_sig / (10.0 ** (snr_db / 10.0))
    scale = np.sqrt(target_noise_power / p_noise)
    return (speech + scale * noise).astype(np.float32)
