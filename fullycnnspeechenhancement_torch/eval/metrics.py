"""Speech-quality metrics: SDR, STOI, PESQ, and running averages.

The port's copy of `fullycnnspeechenhancement_tpu/eval/metrics.py`, numpy
code throughout.  The reference wraps pypesq (ITU-T P.862 C code) and
pystoi (reference model_utils/utils.py:32-90); neither package is
installed, so:

  * SDR -- exactly the reference's 10*log10(sum(y^2) / (sum((y_hat-y)^2)
    + float32 eps)) (utils.py:64-90);
  * STOI -- a from-scratch short-time objective intelligibility measure
    (Taal et al., ICASSP 2010/TASL 2011): 10 kHz resample, energy-based
    silent-frame removal, 512-point STFT of 256-sample frames, 15
    one-third-octave bands from 150 Hz, 384 ms segments, per-segment
    normalisation and (-15 dB) clipping, averaged envelope correlation.
    Its choices (window = hann(N+2)[1:-1], OLA without renormalisation,
    nearest-bin band edges) follow the published pystoi package, so
    scores are comparable with the reference's wrapper;
  * PESQ -- `pypesq`/`pesq` when importable (ITU scores); otherwise the
    native P.862-structured implementation (runtime/pesq862.cc through
    data/native.py: the published algorithm, calibrated on anchors, not
    ITU-conformance-tested -- see its header).  The fwSegSNR proxy is
    only a last resort (allow_proxy=True), labelled, and never reported
    as PESQ.
"""

from __future__ import annotations

import math

import numpy as np

from fullycnnspeechenhancement_torch.data.audio_io import resample


class AverageMeter:
    """Running average: the last value, the sum, the count and the mean
    (reference utils.py:13-29).  The reference never resets its PESQ, STOI
    and SDR meters between validations (Appendix A.11); meters passed to
    `Evaluator.evaluate` persist across calls the same way."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val
        self.count += n
        self.avg = self.sum / self.count


def sdr(reference: np.ndarray, estimate: np.ndarray) -> float:
    """10*log10(sum(ref^2) / (sum((est-ref)^2) + eps_f32))."""
    reference = np.asarray(reference)
    estimate = np.asarray(estimate)
    assert reference.ndim == 1 and reference.shape == estimate.shape
    num = np.power(reference, 2).sum()
    den = np.power(estimate - reference, 2).sum() + np.finfo(np.float32).eps
    return float(10.0 * np.log10(num / den))


class SDR:
    def __call__(self, reference, estimate):
        return sdr(reference, estimate)


# ---------------------------------------------------------------------------
# STOI
# ---------------------------------------------------------------------------

_STOI_SR = 10000
_STOI_FRAME = 256
_STOI_HOP = 128
_STOI_NFFT = 512
_STOI_NBANDS = 15
_STOI_MINFREQ = 150.0
_STOI_SEG = 30  # frames per segment (384 ms)
_STOI_BETA = -15.0  # clipping, dB
_STOI_DYN_RANGE = 40.0  # silent-frame threshold, dB


def _third_octave_bands(sr=_STOI_SR, nfft=_STOI_NFFT, n_bands=_STOI_NBANDS,
                        min_freq=_STOI_MINFREQ):
    """[n_bands, nfft//2+1] 0/1 matrix selecting bins per 1/3-octave band."""
    f = np.linspace(0, sr / 2, nfft // 2 + 1)
    k = np.arange(n_bands)
    cf = min_freq * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    bands = np.zeros((n_bands, len(f)))
    for j in range(n_bands):
        # each bin assigned to the band whose edges bracket it (nearest-bin
        # edges, as in the published implementation)
        lo_bin = np.argmin((f - lo[j]) ** 2)
        hi_bin = np.argmin((f - hi[j]) ** 2)
        bands[j, lo_bin:hi_bin] = 1.0
    return bands


def _stoi_window(frame=_STOI_FRAME):
    """pystoi's analysis window: hann(frame+2) without the zero endpoints
    (scipy.signal.windows.hann(N+2)[1:-1]); computed directly to avoid the
    scipy import."""
    n = np.arange(1, frame + 1)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (frame + 1))


def _stft_frames(x, frame=_STOI_FRAME, hop=_STOI_HOP, nfft=_STOI_NFFT):
    n = (len(x) - frame) // hop + 1
    if n <= 0:
        return np.zeros((0, nfft // 2 + 1))
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    frames = x[idx] * _stoi_window(frame)[None, :]
    return np.fft.rfft(frames, nfft)


def _remove_silent_frames(clean, proc, dyn_range=_STOI_DYN_RANGE,
                          frame=_STOI_FRAME, hop=_STOI_HOP):
    """Drop frames more than `dyn_range` dB below the loudest clean frame,
    then overlap-add the surviving windowed frames (pystoi semantics: the
    window is applied once and the 50%-overlap hann sums to ~unity, no
    renormalization)."""
    n = (len(clean) - frame) // hop + 1
    if n <= 0:
        return clean, proc
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    w = _stoi_window(frame)
    energies = 20 * np.log10(np.linalg.norm(clean[idx] * w, axis=1) + 1e-12)
    mask = energies > energies.max() - dyn_range
    if not mask.any():
        return clean, proc

    def rebuild(x):
        out = np.zeros((mask.sum() - 1) * hop + frame)
        pos = 0
        for i in np.where(mask)[0]:
            out[pos : pos + frame] += x[idx[i]] * w
            pos += hop
        return out

    return rebuild(clean), rebuild(proc)


def stoi(clean: np.ndarray, processed: np.ndarray, sample_rate: int) -> float:
    """Short-time objective intelligibility in [~0, 1]."""
    clean = np.asarray(clean, dtype=np.float64)
    processed = np.asarray(processed, dtype=np.float64)
    assert clean.ndim == 1 and clean.shape == processed.shape
    if sample_rate != _STOI_SR:
        clean = resample(clean, sample_rate, _STOI_SR).astype(np.float64)
        processed = resample(processed, sample_rate, _STOI_SR).astype(np.float64)

    clean, processed = _remove_silent_frames(clean, processed)
    X = _stft_frames(clean)
    Y = _stft_frames(processed)
    if X.shape[0] < _STOI_SEG:
        # pystoi behaviour: warn and return the 1e-5 sentinel instead of
        # raising -- a quiet-tailed utterance near the 0.4 s duration
        # floor can drop under one segment after silent-frame removal,
        # and a metric must not kill the evaluation pass (pystoi.stoi's
        # "not enough STFT frames" path).
        import warnings

        warnings.warn(
            f"signal too short for STOI after silent-frame removal "
            f"({X.shape[0]} frames < {_STOI_SEG}); returning sentinel 1e-5"
        )
        return 1e-5
    bands = _third_octave_bands()
    # [T, J] band envelopes
    Xb = np.sqrt((np.abs(X) ** 2) @ bands.T)
    Yb = np.sqrt((np.abs(Y) ** 2) @ bands.T)

    clip = 10.0 ** (-_STOI_BETA / 20.0)
    scores = []
    for m in range(_STOI_SEG, Xb.shape[0] + 1):
        x = Xb[m - _STOI_SEG : m]  # [N, J]
        y = Yb[m - _STOI_SEG : m]
        alpha = np.linalg.norm(x, axis=0) / (np.linalg.norm(y, axis=0) + 1e-12)
        y_n = y * alpha[None, :]
        y_c = np.minimum(y_n, x * (1.0 + clip))
        xm = x - x.mean(0)
        ym = y_c - y_c.mean(0)
        denom = np.linalg.norm(xm, axis=0) * np.linalg.norm(ym, axis=0) + 1e-12
        scores.append(np.sum(xm * ym, axis=0) / denom)
    return float(np.mean(scores))


class STOI:
    def __init__(self, sr: int = 16000):
        self.sr = sr

    def __call__(self, clean, processed):
        return stoi(clean, processed, self.sr)


# ---------------------------------------------------------------------------
# PESQ
# ---------------------------------------------------------------------------


def _fwseg_snr_mos_proxy(clean, degraded, sample_rate) -> float:
    """Frequency-weighted segmental SNR mapped to a MOS-like 1..4.5 range.

    NOT a PESQ score -- a monotone quality proxy for environments without
    the ITU implementation.  Correlates with distortion level; use only
    for relative comparisons and never report as P.862 PESQ.
    """
    X = _stft_frames(np.asarray(clean, np.float64))
    Y = _stft_frames(np.asarray(degraded, np.float64))
    n = min(len(X), len(Y))
    if n == 0:
        return 1.0
    Xp, Yp = np.abs(X[:n]) ** 2, np.abs(Y[:n]) ** 2
    w = Xp ** 0.2  # mild spectral weighting toward speech-active bins
    snr = 10.0 * np.log10((Xp + 1e-12) / (np.abs(Xp - Yp) + 1e-12))
    seg = np.sum(w * np.clip(snr, -10.0, 35.0), axis=1) / (np.sum(w, axis=1) + 1e-12)
    mean_snr = float(np.mean(seg))
    return float(np.clip(1.0 + 3.5 * (mean_snr + 10.0) / 45.0, 1.0, 4.5))


def mos_lqo(raw_mos: float) -> float:
    """ITU-T P.862.1 mapping from raw P.862 MOS to MOS-LQO.

    Published mapping (Rec. P.862.1, eq. 1; also applied by the `pesq`
    PyPI package for narrowband mode):

        y = 0.999 + (4.999 - 0.999) / (1 + exp(-1.4945 * x + 4.6607))

    The reference's pypesq returns RAW P.862 MOS (model_utils/
    utils.py:44 reports that scale, e.g. the published 2.27 at
    readme.md:69-73), so the framework scores raw MOS everywhere and
    exposes this mapping for users comparing against MOS-LQO numbers.
    """
    x = float(raw_mos)
    return 0.999 + 4.0 / (1.0 + math.exp(-1.4945 * x + 4.6607))


def mos_lqo_inverse(lqo: float) -> float:
    """Inverse of `mos_lqo` (P.862.1 eq. 2 domain): MOS-LQO -> raw MOS."""
    y = min(max(float(lqo), 0.999 + 1e-9), 4.999 - 1e-9)
    return (4.6607 - math.log(4.0 / (y - 0.999) - 1.0)) / 1.4945


class PESQ:
    """P.862 PESQ scoring.

    Resolution order:
      1. `pypesq` (the reference's dependency, model_utils/utils.py:9,44)
         -- bit-exact ITU scores when installed;
      2. `pesq` package -- same;
      3. the framework's native P.862-structured implementation
         (runtime/pesq862.cc via data.native.pesq_nb): the full published
         algorithm (IRS-style filtering, level + time alignment, Bark
         pitch power densities, freq/gain compensation, Zwicker loudness,
         masked asymmetric disturbance, L6/L2 aggregation), calibrated on
         anchor conditions but NOT conformance-tested against the ITU
         code -- `implementation` reports "p862-native";
      4. with allow_proxy=True only: the fwSegSNR proxy above
         (`is_proxy` is True; never reported as PESQ).
    """

    def __init__(self, sr: int = 16000, allow_proxy: bool = False):
        self.sr = sr
        self.allow_proxy = allow_proxy
        self._impl = None
        self.is_proxy = False
        self.implementation = "none"
        try:
            from pypesq import pesq as _pesq  # type: ignore

            if not callable(_pesq):  # stubbed module, not a real install
                raise ImportError("pypesq.pesq is not callable")
            self._impl = lambda a, b: _pesq(a, b, self.sr)
            self.implementation = "pypesq"
        except ImportError:
            try:
                from pesq import pesq as _pesq  # type: ignore

                if not callable(_pesq):
                    raise ImportError("pesq.pesq is not callable")
                mode = "nb" if self.sr == 8000 else "wb"
                self._impl = lambda a, b: _pesq(self.sr, a, b, mode)
                self.implementation = "pesq"
            except ImportError:
                from fullycnnspeechenhancement_torch.data import native

                if native.native_available():
                    self._impl = self._native_nb
                    self.implementation = "p862-native"
                elif allow_proxy:
                    self._impl = lambda a, b: _fwseg_snr_mos_proxy(a, b, self.sr)
                    self.is_proxy = True
                    self.implementation = "fwsegsnr-proxy"

    def _native_nb(self, reference, degraded):
        from fullycnnspeechenhancement_torch.data import native

        if self.sr != 8000:  # narrowband model: score at 8 kHz
            reference = resample(np.asarray(reference, np.float64), self.sr, 8000)
            degraded = resample(np.asarray(degraded, np.float64), self.sr, 8000)
        return native.pesq_nb(reference, degraded)

    @property
    def available(self) -> bool:
        return self._impl is not None and not self.is_proxy

    def __call__(self, reference, degraded) -> float:
        reference = np.asarray(reference)
        degraded = np.asarray(degraded)
        assert reference.ndim == 1 and len(reference) == len(degraded)
        if self._impl is None:
            raise RuntimeError(
                "No ITU P.862 implementation available (pypesq/pesq not "
                "installed). Construct PESQ(allow_proxy=True) for a "
                "non-PESQ quality proxy, or install pypesq for real scores."
            )
        return float(self._impl(reference, degraded))
