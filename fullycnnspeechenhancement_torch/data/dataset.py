"""Dataset: manifest entries -> (mix, clean) waveform pairs.

The port's copy of `fullycnnspeechenhancement_tpu/data/dataset.py`, on the
Python path.  It covers both reference modes (data_loader.py:109-125):
a clean manifest plus a noise manifest with on-the-fly SNR mixing
(aishell + noise corpus), and pre-mixed clean/mix pairs (VoiceBank-DEMAND).
Items are raw waveforms (spectrogram extraction happens on the device),
and the clean <-> noise pairing is re-drawn per epoch from a numpy
generator seeded with (seed, epoch), exactly as in the JAX package, so the
same seed gives the same items.

`use_native=True` decodes, resamples and mixes through the native runtime
(`data/native.py`), which releases the GIL for the whole item.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from fullycnnspeechenhancement_torch.config import DataConfig, DSPConfig
from fullycnnspeechenhancement_torch.data.audio_io import read_wav
from fullycnnspeechenhancement_torch.data.manifest import (
    ManifestEntry,
    read_manifest,
    shard_for_host,
)
from fullycnnspeechenhancement_torch.data.mixing import mix_at_snr


class SpeechDataset:
    def __init__(
        self,
        manifest_path: str,
        noise_manifest: Optional[str],
        sample_rate: int,
        snr_db: float = 0.0,
        min_duration: float = 0.4,
        max_duration: float = float("inf"),
        seed: int = 0,
        host_index: int = 0,
        host_count: int = 1,
        use_native: bool = False,
    ):
        self.sample_rate = sample_rate
        self.snr_db = snr_db
        self.seed = seed
        if use_native:
            from fullycnnspeechenhancement_torch.data import native

            if not native.native_available():
                raise RuntimeError(
                    "use_native=True but the native runtime could not be built "
                    "(g++ and the sources under fullycnnspeechenhancement_torch/runtime)"
                )
        self.use_native = use_native
        self.items: List[ManifestEntry] = shard_for_host(
            read_manifest(manifest_path, min_duration, max_duration),
            host_index,
            host_count,
        )
        self.noise_items: Optional[List[ManifestEntry]] = (
            read_manifest(noise_manifest) if noise_manifest else None
        )
        if self.noise_items is not None and not self.noise_items:
            raise ValueError(f"noise manifest {noise_manifest} is empty")
        self._epoch = 0
        self._noise_assignment = None
        self.set_epoch(0)

    def __len__(self) -> int:
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        """Re-draw the clean <-> noise pairing for this epoch."""
        self._epoch = epoch
        if self.noise_items is not None:
            rng = np.random.default_rng((self.seed, epoch))
            self._noise_assignment = rng.integers(
                0, len(self.noise_items), size=len(self.items)
            )

    def num_frames(self, dsp: DSPConfig, index: int) -> int:
        """Frame count from the manifest duration (for bucketing without
        decoding)."""
        return dsp.num_frames(int(round(self.items[index].duration * self.sample_rate)))

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (mix_waveform, clean_waveform), float32 at self.sample_rate."""
        entry = self.items[index]
        if self.use_native:
            return self._getitem_native(index, entry)
        if entry.is_premixed:
            clean, _ = read_wav(entry.clean_audio_filepath, self.sample_rate)
            mix, _ = read_wav(entry.mix_audio_filepath, self.sample_rate)
            n = min(len(clean), len(mix))
            return mix[:n], clean[:n]
        clean, _ = read_wav(entry.audio_filepath, self.sample_rate)
        if self.noise_items is None:
            return clean.copy(), clean
        noise_entry = self.noise_items[self._noise_assignment[index]]
        noise, _ = read_wav(noise_entry.audio_filepath, self.sample_rate)
        rng = np.random.default_rng((self.seed, self._epoch, index))
        mix = mix_at_snr(clean, noise, self.snr_db, rng)
        return mix, clean

    def _getitem_native(self, index, entry):
        """GIL-free decode + resample + mix through the native runtime.  The
        mixing draws come from the C++ mt19937_64 stream seeded from (seed,
        epoch, index): the same semantics as the Python path, other draws."""
        from fullycnnspeechenhancement_torch.data import native

        if entry.is_premixed:
            clean, sr_c = native.decode_wav(entry.clean_audio_filepath)
            mix, sr_m = native.decode_wav(entry.mix_audio_filepath)
            if sr_c != self.sample_rate:
                clean = native.resample(clean, sr_c, self.sample_rate)
            if sr_m != self.sample_rate:
                mix = native.resample(mix, sr_m, self.sample_rate)
            n = min(len(clean), len(mix))
            return mix[:n], clean[:n]
        noise_path = None
        if self.noise_items is not None:
            noise_path = self.noise_items[self._noise_assignment[index]].audio_filepath
        item_seed = (self.seed * 1000003 + self._epoch) * 1000003 + index
        return native.prepare_item(
            entry.audio_filepath,
            noise_path,
            self.sample_rate,
            self.snr_db,
            item_seed & 0xFFFFFFFFFFFFFFFF,
        )

    @classmethod
    def from_config(
        cls,
        data: DataConfig,
        dsp: DSPConfig,
        split: str,
        host_index: int = 0,
        host_count: int = 1,
    ) -> "SpeechDataset":
        manifest = getattr(data, f"{split}_manifest_path")
        noise = getattr(data, f"{split}_noise_manifest")
        return cls(
            manifest,
            noise,
            dsp.sample_rate,
            snr_db=data.snr,
            min_duration=data.min_duration,
            max_duration=data.max_duration,
            seed=data.seed,
            host_index=host_index,
            host_count=host_count,
            use_native=data.use_native,
        )
