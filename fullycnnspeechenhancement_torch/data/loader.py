"""Length-bucketed, prefetching batch loader.

The port's copy of `fullycnnspeechenhancement_tpu/data/loader.py` (numpy
code; the port imports nothing of the JAX package).  Design, against the
reference's Sampler/DataLoader (data_utils/data_loader.py:137-262):

  * STATIC SHAPES: utterances are grouped by frame count into a fixed set
    of buckets and every batch is padded to its bucket's sample length, so
    the device sees a few shapes (the reference feeds dynamic shapes);
  * PIPELINED HOST WORK: a thread pool decodes and mixes items and a
    producer thread keeps `prefetch` collated batches queued while the
    device steps;
  * DETERMINISM: batch order and noise pairing derive from (seed, epoch)
    through numpy generators, exactly as in the JAX package, so the same
    manifests and seed give the same batches in both packages.

The reference's partial-batch quirk (its Sampler repeats tail items to
fill the last batch) is reproduced intentionally, so the batch size stays
static.  With `int16_transport` the waveforms ship as int16 with a [B]
per-utterance scale (`LoaderBatch.wav_scale`); the train step rebuilds
them on the device, halving host-to-device bytes.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from fullycnnspeechenhancement_torch.config import DSPConfig
from fullycnnspeechenhancement_torch.data.dataset import SpeechDataset


class LoaderBatch(NamedTuple):
    mix_wav: np.ndarray  # [B, L_bucket] float32 (int16 when the
    clean_wav: np.ndarray  # [B, L_bucket]  loader's int16_transport is on)
    lengths: np.ndarray  # [B] int32 true sample counts
    indices: np.ndarray  # [B] int32 dataset indices (for eval bookkeeping)
    bucket_frames: int
    wav_scale: Optional[np.ndarray] = None  # [B] f32, int16 transport only


class BucketSampler:
    """Assign items to frame-count buckets and yield fixed-size batches."""

    def __init__(
        self,
        dataset: SpeechDataset,
        dsp: DSPConfig,
        batch_size: int,
        bucket_frames: Sequence[int] = (64, 128, 192, 256, 384, 512, 768, 1024),
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.dsp = dsp
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.boundaries = sorted(bucket_frames)
        self._frames = [
            dataset.num_frames(dsp, i) for i in range(len(dataset))
        ]

    def bucket_for(self, frames: int) -> int:
        for b in self.boundaries:
            if frames <= b:
                return b
        top = self.boundaries[-1]
        return ((frames + top - 1) // top) * top

    def batches(self, epoch: int) -> List[tuple]:
        """-> list of (bucket_frames, [indices]) with static batch size."""
        rng = np.random.default_rng((self.seed, epoch))
        by_bucket: dict = {}
        order = np.arange(len(self._frames))
        if self.shuffle:
            rng.shuffle(order)
        for i in order:
            by_bucket.setdefault(self.bucket_for(self._frames[i]), []).append(int(i))
        out = []
        for bucket, idxs in sorted(by_bucket.items()):
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start : start + self.batch_size]
                while len(chunk) < self.batch_size:  # static batch: repeat tail
                    chunk = chunk + chunk[: self.batch_size - len(chunk)]
                out.append((bucket, chunk))
        if self.shuffle:
            rng.shuffle(out)
        return out

    def num_batches(self) -> int:
        return len(self.batches(0))


class DataLoader:
    """Threaded, prefetching loader yielding static-shape LoaderBatches."""

    def __init__(
        self,
        dataset: SpeechDataset,
        dsp: DSPConfig,
        batch_size: int,
        bucket_frames: Sequence[int] = (64, 128, 192, 256, 384, 512, 768, 1024),
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        int16_transport: bool = False,
    ):
        self.dataset = dataset
        self.dsp = dsp
        self.batch_size = batch_size
        self.sampler = BucketSampler(
            dataset, dsp, batch_size, bucket_frames, shuffle, seed
        )
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        # Ship waveforms as int16 PCM and cast on the device (train.step
        # handles integer batches): halves host-to-device bytes.  Costs
        # ONE quantization at ~-96 dBFS relative to the utterance peak.
        self.int16_transport = int16_transport
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return self.sampler.num_batches()

    def _pad_len(self, bucket_frames: int) -> int:
        return self.dsp.padded_samples(bucket_frames)

    def _collate(self, bucket: int, idxs: List[int], pool) -> LoaderBatch:
        pairs = list(pool.map(self.dataset.__getitem__, idxs))
        L = self._pad_len(bucket)
        B = len(idxs)
        mix = np.zeros((B, L), np.float32)
        clean = np.zeros((B, L), np.float32)
        lengths = np.zeros((B,), np.int32)
        for j, (m, c) in enumerate(pairs):
            n = min(len(m), L)
            mix[j, :n] = m[:n]
            clean[j, :n] = c[:n]
            lengths[j] = n
        if self.int16_transport:
            # Per-utterance peak normalization: 0 dB mixes exceed +/-1.0,
            # so full-scale int16 would clip; the step reconstructs
            # wav = i16 * scale / 32768 on device (quantization is 2^-15
            # of each utterance's own peak).
            peak = np.maximum(
                np.abs(mix).max(axis=1), np.abs(clean).max(axis=1)
            )
            # 32768/32767 headroom so the peak sample lands on 32767
            # exactly instead of clipping by one LSB
            scale = (
                np.maximum(peak, 1e-12) * (32768.0 / 32767.0)
            ).astype(np.float32)
            q = 32768.0 / scale[:, None]
            mix = np.clip(np.round(mix * q), -32768, 32767).astype(np.int16)
            clean = np.clip(np.round(clean * q), -32768, 32767).astype(np.int16)
            return LoaderBatch(
                mix, clean, lengths, np.asarray(idxs, np.int32), bucket, scale
            )
        return LoaderBatch(mix, clean, lengths, np.asarray(idxs, np.int32), bucket)

    def __iter__(self) -> Iterator[LoaderBatch]:
        plan = self.sampler.batches(self._epoch)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _SENTINEL = object()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                try:
                    for bucket, idxs in plan:
                        if stop.is_set():
                            break
                        q.put(self._collate(bucket, idxs, pool))
                except BaseException as e:  # surfaced to the consumer
                    q.put(e)
                finally:
                    q.put(_SENTINEL)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
        return
