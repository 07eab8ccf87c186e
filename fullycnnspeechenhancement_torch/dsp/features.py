"""Batched STFT analysis on tensors: waveform [B, L] -> magnitude [B, T, F].

Counterpart of `fullycnnspeechenhancement_tpu/dsp/features.py`.  The host
loader only decodes waveforms; pre-emphasis, framing, windowing and the DFT
run on the tensors' device.  The rFFT is one real matmul against a
precomputed [frame_length, 2*num_bins] DFT basis with the analysis window
folded into it (256 x 258 at the reference's settings).

Waveforms arrive as [B, L_pad] with per-utterance sample counts [B]; the
extractor emits [B, T, F] where T = num_frames(L_pad).  Frames at or beyond
an utterance's own frame count are exact zeros, matching the reference's
zero-padded collate (data_loader.py:198-209).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from fullycnnspeechenhancement_torch.config import DSPConfig
from fullycnnspeechenhancement_torch.dsp.windows import make_window


def dft_basis(frame_length: int, nfft: int) -> np.ndarray:
    """Real rFFT basis: [frame_length, 2*(nfft//2+1)] (cos block | sin block).

    frames @ basis == concat(Re rfft(frames, nfft), Im rfft(frames, nfft))
    for frame_length <= nfft.  Computed in float64, cast to float32 at use.
    """
    bins = nfft // 2 + 1
    n = np.arange(frame_length)[:, None]
    k = np.arange(bins)[None, :]
    ang = -2.0 * np.pi * n * k / nfft
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1)


@functools.lru_cache(maxsize=None)
def _windowed_basis(cfg: DSPConfig, device: torch.device) -> torch.Tensor:
    # (frames * w) @ B == frames @ (diag(w) B): one matmul does window + DFT.
    window = make_window(cfg.window_name, cfg.frame_length)
    basis = dft_basis(cfg.frame_length, cfg.analysis_nfft)
    return torch.as_tensor(
        (window[:, None] * basis).astype(np.float32), device=device
    )


@dataclasses.dataclass(frozen=True)
class SpectrogramExtractor:
    """Batched analysis: waveform [B, L] -> magnitude [B, T, F] (float32).

    Works on the device of the tensors it is given.  In float32 the DFT
    matmul must not run in TF32 on the card: the synthesis de-emphasis IIR
    amplifies spectral error by up to 1/(1-0.97) ~= 33x.  The inference
    engine turns TF32 off (`device.disable_tf32`).
    """

    cfg: DSPConfig

    def num_frames(self, num_samples: int) -> int:
        return self.cfg.num_frames(num_samples)

    def _frames(self, signals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Pre-emphasize, zero out beyond per-utterance length, frame.

        signals: [B, L] float32, zero beyond each utterance's length.
        Returns [B, T, frame_length] with T = num_frames(L).
        """
        cfg = self.cfg
        B, L = signals.shape
        # Pre-emphasis y[n] = x[n] - c*x[n-1]; y[0] = x[0]
        # (audio_feature.py:46-55).
        shifted = torch.nn.functional.pad(signals[:, :-1], (1, 0))
        emphasized = signals - cfg.preemphasis * shifted
        # The reference pre-emphasizes each utterance *before* zero padding,
        # so position `len` (first pad sample) is 0, not -c*x[len-1].
        sample_idx = torch.arange(L, device=signals.device)[None, :]
        emphasized = torch.where(
            sample_idx < lengths[:, None], emphasized, torch.zeros_like(emphasized)
        )

        T = cfg.num_frames(L)
        need = (T - 1) * cfg.frame_step + cfg.frame_length
        if need > L:
            emphasized = torch.nn.functional.pad(emphasized, (0, need - L))
        if cfg.frame_length == 2 * cfg.frame_step:
            # Fast path (the reference's 32ms/16ms default): frame t is the
            # concatenation of stride-chunks t and t+1 -> two reshapes, no
            # gather.
            n_chunks = need // cfg.frame_step
            chunks = emphasized[:, : n_chunks * cfg.frame_step].reshape(
                B, n_chunks, cfg.frame_step
            )
            frames = torch.cat([chunks[:, :T], chunks[:, 1 : T + 1]], dim=-1)
        else:
            frames = emphasized.unfold(1, cfg.frame_length, cfg.frame_step)[:, :T]
        # Zero frames at/after each utterance's own frame count: the
        # reference frames each utterance separately and zero-pads the
        # *spectrogram* at collate.
        return frames * self.frame_mask(lengths, T)[:, :, None]

    def __call__(self, signals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Magnitude spectrogram [B, T, F] (float32)."""
        re, im = self.complex_parts(signals, lengths)
        return torch.sqrt(re * re + im * im)

    def complex_parts(self, signals: torch.Tensor, lengths: torch.Tensor):
        """(Re, Im) of the windowed rFFT, each [B, T, F]."""
        frames = self._frames(signals, lengths)
        both = torch.matmul(frames, _windowed_basis(self.cfg, signals.device))
        F = self.cfg.num_bins
        return both[..., :F], both[..., F:]

    def magnitude_and_phase(self, signals: torch.Tensor, lengths: torch.Tensor):
        """(magnitude [B,T,F], phase_re [B,T,F], phase_im [B,T,F]).

        Phase is the unit complex e^{j*angle} of the noisy spectrum
        (audio_feature.py:112-115), kept as separate real planes.
        """
        re, im = self.complex_parts(signals, lengths)
        mag = torch.sqrt(re * re + im * im)
        safe = torch.where(mag > 0, mag, torch.ones_like(mag))
        return mag, re / safe, im / safe

    def frame_counts(self, lengths: torch.Tensor) -> torch.Tensor:
        """[B] int32 per-utterance frame counts, the reference's formula
        ceil(|L - flen| / step + 1) (audio_feature.py:70)."""
        cfg = self.cfg
        return torch.ceil(
            torch.abs(lengths.to(torch.float32) - cfg.frame_length) / cfg.frame_step
            + 1
        ).to(torch.int32)

    def frame_mask(self, lengths: torch.Tensor, total_frames: int) -> torch.Tensor:
        """[B, T] 1.0 where the frame index is < the utterance's own frame
        count, else 0.0."""
        counts = self.frame_counts(lengths)
        t = torch.arange(total_frames, device=lengths.device)[None, :]
        return (t < counts[:, None]).to(torch.float32)

    def batch_max_frame_mask(
        self, lengths: torch.Tensor, total_frames: int
    ) -> torch.Tensor:
        """[1, T] 1.0 where the frame index is < the BATCH-MAX frame count.

        The region the reference's padded collate materializes; it is the
        same for every row, so it stays [1, T] and broadcasts.
        """
        bm = torch.max(self.frame_counts(lengths))
        t = torch.arange(total_frames, device=lengths.device)[None, :]
        return (t < bm).to(torch.float32)
