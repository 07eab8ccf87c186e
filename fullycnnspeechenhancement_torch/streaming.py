"""Streaming (real-time) denoiser: frame by frame with overlap-add ISTFT.

Counterpart of `fullycnnspeechenhancement_tpu/streaming.py`.  The model
family's only conv with a time extent is the first layer (kernel height
8, TF SAME pads 3 before and 4 after), so an output frame t depends
exactly on input frames [t-3, t+4].  The streamer therefore:

  * buffers raw samples, carrying one sample of pre-emphasis state across
    pushes;
  * analyses every completed 256-sample frame (hop 128) in one batched
    matmul on the host;
  * runs the model (plain torch, BN in inference mode, on the streamer's
    device) on a window of [3 history + chunk + 4 lookahead] frames and
    keeps the chunk's outputs, which equal what whole-utterance inference
    gives those frames (the stream starts with 3 zero frames, as SAME
    padding does);
  * synthesizes by true ISTFT overlap-add (synthesis window = the
    analysis Hamming, normalized by window power) with a streaming tail,
    then streams the de-emphasis IIR.

Every chunk ends in one device-to-host copy of its prediction, so a push
that emits output waits for the device once.

Algorithmic latency: 4 lookahead frames x 16 ms = 64 ms, plus one chunk
of buffering (chunk_frames=8 -> 128 ms).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.signal import lfilter, lfiltic

from fullycnnspeechenhancement_torch.config import Config
from fullycnnspeechenhancement_torch.device import disable_tf32, resolve_device
from fullycnnspeechenhancement_torch.dsp.rebuild import inverse_dft_basis
from fullycnnspeechenhancement_torch.dsp.windows import make_window
from fullycnnspeechenhancement_torch.models import get_model

_HISTORY = 3  # (kh-1)//2 for the first conv's time kernel 8
_LOOKAHEAD = 4  # kh//2


class StreamingDenoiser:
    """Chunked denoiser on one device (the card unless the caller asks for
    the CPU); `params` and `bn_state` are the port's dicts of tensors."""

    def __init__(self, config: Config, params, bn_state, chunk_frames: int = 8, device="cuda"):
        self.device = resolve_device(device)
        disable_tf32()
        self.cfg = config.dsp
        assert self.cfg.frame_length == 2 * self.cfg.frame_step, "streaming assumes 50% overlap"
        self.model = get_model(config.model.net_work)
        self.params = {n: {k: v.detach().to(self.device) for k, v in p.items()} for n, p in params.items()}
        self.bn_state = {n: {k: v.to(self.device) for k, v in s.items()} for n, s in bn_state.items()}
        self.chunk = chunk_frames

        flen = self.cfg.frame_length
        window = make_window(self.cfg.window_name, flen)
        self._window = window.astype(np.float32)
        n = np.arange(flen)[:, None]
        k = np.arange(self.cfg.num_bins)[None, :]
        ang = -2.0 * np.pi * n * k / self.cfg.analysis_nfft
        self._fwd_re = (window[:, None] * np.cos(ang)).astype(np.float32)
        self._fwd_im = (window[:, None] * np.sin(ang)).astype(np.float32)
        self._inv = (
            inverse_dft_basis(self.cfg.analysis_nfft, self.cfg.num_bins, flen, np.ones(flen))
            * window[None, :]
        ).astype(np.float32)
        self._total = _HISTORY + self.chunk + _LOOKAHEAD
        self.reset()

    @torch.inference_mode()
    def _model_chunk(self, mags: np.ndarray) -> np.ndarray:
        """[total, F] magnitudes -> the chunk's [chunk, F] prediction."""
        x = torch.as_tensor(mags, device=self.device)[None, :, :, None]
        pred, _ = self.model.apply(self.params, self.bn_state, x, is_training=False)
        return pred[0, _HISTORY : _HISTORY + self.chunk, :, 0].cpu().numpy()

    def reset(self):
        flen, step = self.cfg.frame_length, self.cfg.frame_step
        self._sample_buf = np.zeros(0, np.float32)
        self._last_raw = 0.0  # pre-emphasis carry
        self._deemph_carry = 0.0
        F = self.cfg.num_bins
        # magnitude/phase ring primed with zeros == SAME zero padding
        self._mags = np.zeros((_HISTORY, F), np.float32)
        self._phases = np.zeros((_HISTORY, F), np.complex64)
        self._pending = 0  # frames in the ring beyond history not yet emitted
        # overlap-add tails: one frame of accumulated signal and window power
        self._ola_tail = np.zeros(flen - step, np.float32)
        self._ola_wtail = np.zeros(flen - step, np.float32)

    @property
    def latency_samples(self) -> int:
        return _LOOKAHEAD * self.cfg.frame_step

    def _analyze_new_frames(self):
        """Move every complete frame of the sample buffer into the
        magnitude/phase ring (leaving frame_length - step samples of
        overlap behind), in one [n, flen] @ [flen, F] matmul."""
        flen, step = self.cfg.frame_length, self.cfg.frame_step
        n = (len(self._sample_buf) - flen) // step + 1 if len(self._sample_buf) >= flen else 0
        if n <= 0:
            return 0
        idx = np.arange(flen)[None, :] + step * np.arange(n)[:, None]
        frames_raw = self._sample_buf[idx]  # [n, flen]
        # pre-emphasis with the carry: the sample before each frame's first
        # is the last raw sample of the previous hop
        prev = np.empty_like(frames_raw)
        prev[:, 1:] = frames_raw[:, :-1]
        prev[0, 0] = self._last_raw
        if n > 1:
            prev[1:, 0] = self._sample_buf[step * np.arange(1, n) - 1]
        emphasized = frames_raw - self.cfg.preemphasis * prev
        re = emphasized @ self._fwd_re  # [n, F]
        im = emphasized @ self._fwd_im
        mag = np.sqrt(re * re + im * im).astype(np.float32)
        spec = re + 1j * im
        phase = np.where(mag > 0, spec / np.maximum(mag, 1e-20), 1.0)
        self._mags = np.concatenate([self._mags, mag], 0)
        self._phases = np.concatenate([self._phases, phase.astype(np.complex64)], 0)
        self._last_raw = self._sample_buf[step * n - 1]
        self._sample_buf = self._sample_buf[step * n :]
        self._pending += n
        return n

    def _deemphasis(self, x: np.ndarray) -> np.ndarray:
        """Streaming de-emphasis y[n] = x[n] + c*y[n-1] from the carry."""
        c = self.cfg.preemphasis
        zi = lfiltic([1.0], [1.0, -c], [self._deemph_carry])
        out, _ = lfilter([1.0], [1.0, -c], x, zi=zi)
        return out

    def _synthesize(self, frames: np.ndarray) -> np.ndarray:
        """Overlap-add `frames` [n, frame_length] (synthesis-windowed);
        emits n*step normalized samples and updates the tails."""
        flen, step = self.cfg.frame_length, self.cfg.frame_step
        n = len(frames)
        if n == 0:
            return np.zeros(0, np.float32)
        acc = np.zeros(n * step + (flen - step), np.float32)
        wacc = np.zeros_like(acc)
        acc[: flen - step] = self._ola_tail
        wacc[: flen - step] = self._ola_wtail
        w2 = self._window**2
        for i, fr in enumerate(frames):
            acc[i * step : i * step + flen] += fr
            wacc[i * step : i * step + flen] += w2
        emit = acc[: n * step] / np.maximum(wacc[: n * step], 1e-6)
        self._ola_tail = acc[n * step :].copy()
        self._ola_wtail = wacc[n * step :].copy()
        out = self._deemphasis(emit)
        self._deemph_carry = out[-1] if len(out) else self._deemph_carry
        return out.astype(np.float32)

    def _process_ready_chunks(self, flush: bool = False) -> np.ndarray:
        chunks = []
        ready_at = 1 if flush else self.chunk + _LOOKAHEAD
        while self._pending >= ready_at:
            take = min(self.chunk, self._pending)
            mags = self._mags[: self._total]
            if len(mags) < self._total:  # flush: pad the future with zeros
                mags = np.concatenate(
                    [mags, np.zeros((self._total - len(mags), mags.shape[1]), np.float32)]
                )
            pred = self._model_chunk(mags)[:take]
            spec = pred * self._phases[_HISTORY : _HISTORY + take]
            both = np.concatenate([spec.real, spec.imag], axis=1).astype(np.float32)
            chunks.append(self._synthesize(both @ self._inv))  # [take, frame_length]
            # slide the ring: drop `take` frames, keep the history
            self._mags = self._mags[take:]
            self._phases = self._phases[take:]
            self._pending -= take
            if flush and self._pending <= 0:
                break
        if chunks:
            return np.concatenate(chunks)
        return np.zeros(0, np.float32)

    def push(self, samples: np.ndarray) -> np.ndarray:
        """Feed raw samples; returns whatever denoised samples are ready."""
        self._sample_buf = np.concatenate([self._sample_buf, np.asarray(samples, np.float32)])
        self._analyze_new_frames()
        return self._process_ready_chunks()

    def flush(self) -> np.ndarray:
        """Drain: zero-pad the tail frame and emit everything remaining.

        A tail frame exists only when the leftover exceeds flen - step: the
        streaming form of the reference's frame count ceil(|L - flen|/step
        + 1) (audio_feature.py:70), which keeps the stream equal to the
        whole-utterance output."""
        flen, step = self.cfg.frame_length, self.cfg.frame_step
        if len(self._sample_buf) > flen - step:
            pad = flen - len(self._sample_buf)
            if pad > 0:
                self._sample_buf = np.concatenate([self._sample_buf, np.zeros(pad, np.float32)])
            self._analyze_new_frames()
        out = self._process_ready_chunks(flush=True)
        # the final tail (samples only partly covered)
        tail = self._ola_tail / np.maximum(self._ola_wtail, 1e-6)
        if len(tail):
            tail = self._deemphasis(tail)
        return np.concatenate([out, tail.astype(np.float32)])
