"""The reference's analysis and rebuild chains in numpy.

Analysis (the reference's `data_utils/audio_feature.py`): pre-emphasis
y[0] = x[0], y[n] = x[n] - 0.97 x[n-1]; frames of 256 samples every 128
(count ceil(|L - 256| / 128 + 1), zero tail); a Hamming window; the
256-point rDFT; magnitude and unit phase.  Rebuild (its
`model_utils/utils.py`): the 512-point inverse rDFT of the 129-bin
spectrum cropped to 256 samples, divided by the window, concatenative
de-framing (frame 0's first 128 samples, then every frame's last 128),
de-emphasis y[n] = x[n] + 0.97 y[n-1], cut to the input's length.  The
settings are the configurations' (8 kHz, 32 ms window, 16 ms hop).

Both DFTs are products with explicit bases computed in float64, so the
controls of the correctness check can round their operands (`bits`, as
in `model.round_mantissa`) where a matrix unit would; without `bits`
everything is float64.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from scipy.signal import lfilter

from .model import round_mantissa

FRAME, STEP, NFFT, SYNTH_NFFT, BINS, PREEMPH = 256, 128, 256, 512, 129, 0.97


def num_frames(n: int) -> int:
    return int(np.ceil(abs(n - FRAME) / STEP + 1))


def _window() -> np.ndarray:
    return np.hamming(FRAME)


def _analysis_basis() -> np.ndarray:
    n = np.arange(FRAME)[:, None]
    k = np.arange(BINS)[None, :]
    ang = -2.0 * np.pi * n * k / NFFT
    return _window()[:, None] * np.concatenate([np.cos(ang), np.sin(ang)], axis=1)


def _synthesis_basis() -> np.ndarray:
    k = np.arange(BINS)[:, None]
    n = np.arange(FRAME)[None, :]
    ang = 2.0 * np.pi * k * n / SYNTH_NFFT
    weight = np.full((BINS, 1), 2.0)
    weight[0, 0] = 1.0  # DC; bin 128 is not the Nyquist bin of 512 points
    basis = np.concatenate([weight * np.cos(ang), -weight * np.sin(ang)], axis=0) / SYNTH_NFFT
    return basis / _window()[None, :]


def _matmul(a: np.ndarray, b: np.ndarray, bits: Optional[int]) -> np.ndarray:
    if bits is None:
        return a @ b
    ra = round_mantissa(torch.from_numpy(np.ascontiguousarray(a, np.float32)), bits)
    rb = round_mantissa(torch.from_numpy(np.ascontiguousarray(b, np.float32)), bits)
    return (ra @ rb).numpy()


def frames_of(signal: np.ndarray) -> np.ndarray:
    """[T, 256] pre-emphasized frames of one utterance, T = num_frames."""
    x = np.asarray(signal, np.float64)
    y = np.empty_like(x)
    y[0] = x[0]
    y[1:] = x[1:] - PREEMPH * x[:-1]
    t = num_frames(len(x))
    padded = np.zeros(t * STEP + FRAME)
    padded[: len(x)] = y
    idx = np.arange(t)[:, None] * STEP + np.arange(FRAME)[None, :]
    return padded[idx]


def analyze(signals: Sequence[np.ndarray], frames: Optional[int] = None, bits=None):
    """(magnitude, phase_re, phase_im), each [B, T, 129], of the rows of
    `signals`, zero past each row's own frame count; T is `frames`, or
    the longest row's count."""
    counts = [num_frames(len(s)) for s in signals]
    t_max = frames or max(counts)
    dt = np.float64 if bits is None else np.float32
    mag = np.zeros((len(signals), t_max, BINS), dt)
    pre, pim = np.zeros_like(mag), np.zeros_like(mag)
    basis = _analysis_basis()
    for i, s in enumerate(signals):
        both = _matmul(frames_of(s).astype(dt), basis.astype(dt), bits)
        re, im = both[:, :BINS], both[:, BINS:]
        m = np.sqrt(re * re + im * im)
        safe = np.where(m > 0, m, 1.0)
        n = counts[i]
        mag[i, :n], pre[i, :n], pim[i, :n] = m, re / safe, im / safe
    return mag, pre, pim


def rebuild(mag: np.ndarray, pre: np.ndarray, pim: np.ndarray, length: int, bits=None) -> np.ndarray:
    """One row's [T, 129] spectrum -> its waveform of `length` samples."""
    dt = np.float64 if bits is None else np.float32
    spec = np.concatenate([mag * pre, mag * pim], axis=-1).astype(dt)
    frames = _matmul(spec, _synthesis_basis().astype(dt), bits)
    overlap = FRAME - STEP
    signal = np.concatenate([frames[0, :overlap], frames[:, overlap:].reshape(-1)])
    return lfilter([1.0], [1.0, -PREEMPH], signal)[:length]
