"""Train steps over the GPU-resident corpus cache.

Counterpart of `fullycnnspeechenhancement_tpu/train/cached_step.py`.  Each
step first rebuilds its batch on the device from the resident int16 flats
(`data.device_cache.materialize_batch`), then runs the port's train step
(the one `make_train_step` makes, passed in), so the host-to-device
traffic per optimizer step is the [B] metadata vectors instead of the
[B, L] waveforms (about 34 MB at 64 x 8 s).

The rebuilt waveforms are float32, so the STFT analysis stays float32 and
`make_train_step` casts the model's input to `compute_dtype` (float32 or
bfloat16) as it does for host batches.  One step function serves one
bucket: its `arange(bucket_samples)` is built once, on the first call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fullycnnspeechenhancement_torch.data.device_cache import CachedBatch, materialize_batch
from fullycnnspeechenhancement_torch.device import host_to_device, resolve_device
from fullycnnspeechenhancement_torch.telemetry import span
from fullycnnspeechenhancement_torch.train.step import Batch, make_multi_step


class Meta(NamedTuple):
    """Device view of CachedBatch: only its [B] (or [K, B]) arrays."""

    clean_chunk: torch.Tensor  # int32
    clean_off: torch.Tensor  # int32
    other_chunk: torch.Tensor  # int32
    other_off: torch.Tensor  # int32
    scale: torch.Tensor  # float32
    lengths: torch.Tensor  # int32

    @classmethod
    def from_batch(cls, b: CachedBatch, device="cuda") -> "Meta":
        dev = resolve_device(device)
        return cls(*(host_to_device(getattr(b, f), dev) for f in cls._fields))

    @classmethod
    def stack(cls, batches, device="cuda") -> "Meta":
        """[CachedBatch] x K (one bucket) -> Meta with [K, B] leaves."""
        dev = resolve_device(device)
        return cls(
            *(host_to_device(np.stack([getattr(b, f) for b in batches]), dev) for f in cls._fields)
        )


def _materializer(bucket_samples: int, premixed: bool):
    """(clean_flat, other_flat, Meta[B]) -> Batch, with the bucket's
    positions built on the flats' device on the first call."""
    positions = {}

    def materialize(clean_flat, other_flat, meta: Meta) -> Batch:
        pos = positions.get(clean_flat.device)
        if pos is None:
            pos = positions[clean_flat.device] = torch.arange(
                bucket_samples, device=clean_flat.device
            )
        mix, clean = materialize_batch(
            clean_flat, other_flat, meta, bucket_samples, premixed, positions=pos
        )
        return Batch(mix, clean, meta.lengths)

    return materialize


def make_cached_train_step(step, bucket_samples: int, premixed: bool):
    """`step` ((state, Batch) -> (state, metrics), as `make_train_step`
    makes it) -> (state, clean_flat, other_flat, Meta[B]) -> (state,
    metrics)."""
    materialize = _materializer(bucket_samples, premixed)

    def cached_step(state, clean_flat, other_flat, meta: Meta):
        with span("train.materialize"):
            batch = materialize(clean_flat, other_flat, meta)
        return step(state, batch)

    return cached_step


def make_cached_multi_step(step, bucket_samples: int, premixed: bool):
    """-> (state, clean_flat, other_flat, Meta[K, B]) -> (state, packed
    [K, 2]): K optimizer steps in one dispatch through `make_multi_step`'s
    loop, each rebuilding its batch from the resident flats just before
    it runs."""
    cached = make_cached_train_step(step, bucket_samples, premixed)

    def cached_multi(state, clean_flat, other_flat, meta: Meta):
        return make_multi_step(lambda s, m: cached(s, clean_flat, other_flat, m))(state, meta)

    return cached_multi
