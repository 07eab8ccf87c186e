"""GPU-resident corpus cache and on-device SNR mixing.

Counterpart of `fullycnnspeechenhancement_tpu/data/device_cache.py`.  Under
data parallelism every rank commits the whole corpus to its own device
(the JAX package's replicated flats) and materializes only its rows of
each batch's metadata (`parallel.dp.shard_meta`).  A host-fed
training loop ships 32 kB of waveform per audio-second (mix and clean,
float32) to the device every step.  This module instead commits the int16
PCM corpora to the card ONCE and rebuilds every training batch there from
[B] metadata:

    mix[b, n] = clean[chunk_c[b], off_c[b] + n] / 32768
              + scale[b] * noise[chunk_n[b], off_n[b] + n] / 32768

Addressing is CHUNKED, as in the JAX package: a corpus is a 2-D int16
array ``[n_chunks, chunk_len]`` and every item carries an ``(chunk,
offset)`` int32 pair, each offset below ``chunk_limit`` (default 2^30).
Torch indexes in int64, so the chunking is not needed for range here; it
is kept so that the metadata is identical to the JAX package's, item for
item, and the tests shrink ``chunk_limit`` to cover multi-row packing.

Device cost: 16 kB per corpus audio-second (int16).  `DeviceCorpus.nbytes`
reports it before committing.

Contract (tests/test_torch_device_cache.py): batches equal the host
loader's (data/loader.py) up to one float32 rounding of the mix -- the
host mixes ``speech + scale * noise`` through a float64 scale and casts,
the device computes it in float32 -- for the random-crop branch (noise
recording at least as long as the utterance) and for pre-mixed pair
manifests; int16 PCM sources round-trip bit for bit.  The
tile-short-noise branch is not a slice of the noise corpus: building
such a corpus raises, and the host loader stays the path for short-noise
corpora.  The SNR scale is computed on the host from the cached samples
with the same float64 power sums and the same seeded draws as the host
path.

Commits copy each flat row by row from the host array itself (a spilled
memmap included) into a fresh zero-padded device tensor, with blocking
copies: each returns once its source has been read and the device rows
written.  No host buffer is staged, pinned or refilled while a copy is
in flight, and the flats are whole before any batch that indexes them
is yielded, whatever thread commits them (the trainer's feeder thread
for the rotating loader) and whatever stream the train step runs on.
"""

from __future__ import annotations

import functools
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fullycnnspeechenhancement_torch.config import DataConfig, DSPConfig
from fullycnnspeechenhancement_torch.data.audio_io import read_wav
from fullycnnspeechenhancement_torch.data.manifest import ManifestEntry, read_manifest
from fullycnnspeechenhancement_torch.device import resolve_device

logger = logging.getLogger(__name__)

# Per-chunk sample budget: 2^30 int16 samples = 2 GiB per row.  Tests
# shrink it to cover multi-row packing cheaply.
CHUNK_LIMIT_DEFAULT = 1 << 30


def _to_i16(wav: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> int16.  Bit-exact inverse of read_wav's int16
    scaling; resampled or float sources quantize at -96 dBFS."""
    return np.clip(
        np.round(np.asarray(wav, np.float64) * 32768.0), -32768, 32767
    ).astype(np.int16)


class FlatCorpus(NamedTuple):
    """One corpus as chunked int16 rows (each row zero-tail-padded).

    ``flat[chunks[i], offsets[i] : offsets[i] + lengths[i]]`` is entry i.
    Every row ends with at least ``pad`` zeros, so a slice of up to
    ``lengths[i] + pad`` samples from any entry's start stays in its row.
    """

    flat: np.ndarray  # [n_chunks, chunk_len] int16
    chunks: np.ndarray  # [N] int32 row of each entry
    offsets: np.ndarray  # [N] int32 start within its row
    lengths: np.ndarray  # [N] int64 sample count of each entry
    pad: int  # guaranteed zero tail per row, in samples

    @classmethod
    def build(
        cls,
        paths: Sequence[str],
        sample_rate: int,
        pad_samples: int,
        chunk_limit: int = CHUNK_LIMIT_DEFAULT,
        num_workers: int = 1,
        use_native: bool = False,
    ) -> "FlatCorpus":
        pad = max(int(pad_samples), 1)
        if chunk_limit <= pad:
            raise ValueError(
                f"chunk_limit ({chunk_limit}) must exceed the tail pad ({pad})"
            )

        def decode(p: str) -> np.ndarray:
            if use_native:
                # GIL-free decode and resample (runtime/fcse_runtime.cc):
                # worker threads scale over a one-time pass of the corpus
                from fullycnnspeechenhancement_torch.data import native

                wav, sr = native.decode_wav(p)
                if sr != sample_rate:
                    wav = native.resample(wav, sr, sample_rate)
            else:
                wav, _ = read_wav(p, sample_rate)
            return _to_i16(wav)

        if num_workers > 1:
            with ThreadPoolExecutor(num_workers) as pool:
                bufs = list(pool.map(decode, paths))
        else:
            bufs = [decode(p) for p in paths]
        for p, i16 in zip(paths, bufs):
            if len(i16) + pad > chunk_limit:
                raise ValueError(
                    f"single recording {p} ({len(i16)} samples) exceeds the "
                    f"chunk budget ({chunk_limit - pad}); raise chunk_limit"
                )
        # Greedy row packing under the chunk budget (entries never split).
        chunks = np.zeros(len(bufs), np.int32)
        offsets = np.zeros(len(bufs), np.int32)
        lengths = np.asarray([len(b) for b in bufs], np.int64)
        row, pos, fills = 0, 0, []
        for i, b in enumerate(bufs):
            if pos + len(b) + pad > chunk_limit:
                fills.append(pos)
                row, pos = row + 1, 0
            chunks[i], offsets[i] = row, pos
            pos += len(b)
        fills.append(pos)
        chunk_len = max(f + pad for f in fills)
        flat = np.zeros((len(fills), chunk_len), np.int16)
        for i, b in enumerate(bufs):
            flat[chunks[i], offsets[i] : offsets[i] + len(b)] = b
        return cls(flat, chunks, offsets, lengths, pad)

    def segment(self, i: int) -> np.ndarray:
        c, o, n = int(self.chunks[i]), int(self.offsets[i]), int(self.lengths[i])
        return self.flat[c, o : o + n]


class CachedBatch(NamedTuple):
    """Per-batch metadata: the only steady-state host-to-device traffic.
    Index fields are int32, as in the JAX package."""

    clean_chunk: np.ndarray  # [B] int32 row into the clean flat
    clean_off: np.ndarray  # [B] int32 offset within that row
    other_chunk: np.ndarray  # [B] int32 row into the noise (or mix) flat
    other_off: np.ndarray  # [B] int32 offset within that row
    scale: np.ndarray  # [B] float32 SNR noise scale (premixed: unused)
    lengths: np.ndarray  # [B] int32 true sample counts
    indices: np.ndarray  # [B] int32 dataset indices
    bucket_frames: int


def commit_flats(flats, device: torch.device, shapes=None):
    """Copy host int16 flats to `device` as fresh torch.int16 tensors,
    zero-padded to `shapes`.  Blocking copies, one row at a time from the
    source: when this returns, every source has been read and every flat
    is whole on the device."""
    out = []
    for i, src in enumerate(flats):
        shape = tuple(src.shape) if shapes is None else shapes[i]
        dst = torch.zeros(shape, dtype=torch.int16, device=device)
        for r in range(src.shape[0]):
            dst[r, : src.shape[1]].copy_(torch.from_numpy(np.asarray(src[r])))
        out.append(dst)
    return tuple(out)


class DeviceCorpus:
    """Clean (+ noise | + premixed mix) corpora, committed to a device.

    `clean` and `other` are host numpy arrays until `commit()`, then
    torch.int16 tensors on the device."""

    def __init__(
        self,
        entries: List[ManifestEntry],
        noise_entries: Optional[List[ManifestEntry]],
        sample_rate: int,
        pad_samples: int,
        snr_db: float,
        seed: int,
        chunk_limit: int = CHUNK_LIMIT_DEFAULT,
        num_workers: int = 1,
        use_native: bool = False,
        shared_noise: Optional[FlatCorpus] = None,
    ):
        self.entries = entries
        self.sample_rate = sample_rate
        self.snr_db = snr_db
        self.seed = seed
        self.pad_samples = max(int(pad_samples), 1)
        self.premixed = bool(entries and entries[0].is_premixed)
        build = functools.partial(
            FlatCorpus.build,
            sample_rate=sample_rate,
            pad_samples=self.pad_samples,
            chunk_limit=chunk_limit,
            num_workers=num_workers,
            use_native=use_native,
        )
        if self.premixed:
            self.clean_host = build([e.clean_audio_filepath for e in entries])
            self.other_host = build([e.mix_audio_filepath for e in entries])
            # premixed pairs truncate to the shorter of (clean, mix), as
            # SpeechDataset.__getitem__ does
            self.item_lengths = np.minimum(
                self.clean_host.lengths, self.other_host.lengths
            )
            self.noise_host = None
        else:
            self.clean_host = build([e.audio_filepath for e in entries])
            self.item_lengths = self.clean_host.lengths.copy()
            if noise_entries:
                # `shared_noise`: rotating-cache shards reuse ONE decoded
                # noise corpus
                self.noise_host = (
                    shared_noise
                    if shared_noise is not None
                    else build([e.audio_filepath for e in noise_entries])
                )
                short = self.noise_host.lengths.min()
                need = self.item_lengths.max()
                if short < need:
                    raise ValueError(
                        f"device_cache supports the random-crop mixing branch "
                        f"only: shortest noise recording ({short} samples) is "
                        f"shorter than the longest utterance ({need}).  Use "
                        f"the host DataLoader for short-noise corpora, or "
                        f"concatenate noise clips into longer tracks."
                    )
            else:
                self.noise_host = None
            self.other_host = self.noise_host
        self.clean = self.clean_host.flat
        # The no-noise placeholder is as wide as the clean rows, so every
        # slice the loader can issue against clean also fits here.
        self.other = (
            self.other_host.flat
            if self.other_host is not None
            else np.zeros((1, self.clean_host.flat.shape[1]), np.int16)
        )
        # Lazy SNR power caches (_ensure_power_caches) make item_meta O(1).
        self._p_sig: Optional[np.ndarray] = None
        self._noise_cumsq: Optional[list] = None

    def _ensure_power_caches(self) -> None:
        if self.premixed or self.noise_host is None:
            return
        if self._p_sig is None:
            n = len(self.item_lengths)
            p = np.zeros(n, np.float64)
            for i in range(n):
                seg = self.clean_host.segment(i).astype(np.float32) / 32768.0
                p[i] = np.dot(seg.astype(np.float64), seg.astype(np.float64))
            self._p_sig = p
        if self._noise_cumsq is not None:
            return  # injected (shared across rotating-cache shards)
        # One float64 cumulative-square table per noise recording, with
        # entry-local indices: a crop [start, start + L) has power
        # cum[start + L] - cum[start].  Per-recording tables keep the sums
        # bounded by one recording's power and avoid the collision of a
        # row-wide table at entry boundaries.
        nh = self.noise_host
        self._noise_cumsq = []
        for c, o, ln in zip(nh.chunks, nh.offsets, nh.lengths):
            seg = nh.flat[c, o : o + ln].astype(np.float32) / 32768.0
            self._noise_cumsq.append(
                np.concatenate(
                    [np.zeros(1, np.float64), np.cumsum(np.square(seg, dtype=np.float64))]
                )
            )

    def nbytes(self) -> int:
        return self.clean.nbytes + self.other.nbytes

    def commit(self, device="cuda") -> "DeviceCorpus":
        """Put the flats on `device` (the card unless the caller asks for
        the CPU) as torch.int16 tensors; idempotent."""
        if not isinstance(self.clean, torch.Tensor):
            self.clean, self.other = commit_flats(
                (self.clean, self.other), resolve_device(device)
            )
        return self

    # -- per-item metadata (host side, the host loader's seeded draws) ----

    def noise_assignment(self, epoch: int) -> Optional[np.ndarray]:
        """The same per-epoch pairing draw as SpeechDataset.set_epoch."""
        if self.noise_host is None:
            return None
        rng = np.random.default_rng((self.seed, epoch))
        return rng.integers(0, len(self.noise_host.lengths), size=len(self.entries))

    def item_meta(
        self, index: int, epoch: int, assignment: Optional[np.ndarray]
    ) -> Tuple[int, int, int, int, float]:
        """-> (clean_chunk, clean_off, other_chunk, other_off, scale) for
        one item, drawing the same seeded sequence as
        SpeechDataset.__getitem__ and mix_at_snr."""
        cc = int(self.clean_host.chunks[index])
        co = int(self.clean_host.offsets[index])
        L = int(self.item_lengths[index])
        if self.premixed:
            return (
                cc,
                co,
                int(self.other_host.chunks[index]),
                int(self.other_host.offsets[index]),
                0.0,
            )
        if self.noise_host is None:
            return cc, co, 0, 0, 0.0
        self._ensure_power_caches()
        ni = int(assignment[index])
        oc = int(self.noise_host.chunks[ni])
        no_base = int(self.noise_host.offsets[ni])
        n_len = int(self.noise_host.lengths[ni])
        rng = np.random.default_rng((self.seed, epoch, index))
        if n_len == L:
            start = 0  # mix_at_snr's >= branch with zero doublings: no draw
        else:
            start = int(rng.integers(0, n_len - L))
        p_sig = float(self._p_sig[index])
        cum = self._noise_cumsq[ni]  # entry-local indices
        p_noise = float(cum[start + L] - cum[start])
        if p_noise <= 0.0:
            return cc, co, oc, no_base + start, 0.0
        scale = np.sqrt((p_sig / (10.0 ** (self.snr_db / 10.0))) / p_noise)
        return cc, co, oc, no_base + start, float(scale)


def _window(flat: torch.Tensor, chunk, off, positions: torch.Tensor) -> torch.Tensor:
    """[B, L] int16 slices flat[chunk[b], off[b] : off[b] + L] by one
    gather over the flattened rows."""
    start = chunk.to(torch.int64) * flat.shape[1] + off.to(torch.int64)
    return flat.reshape(-1)[start[:, None] + positions[None, :]]


def materialize_batch(
    clean_flat: torch.Tensor,
    other_flat: torch.Tensor,
    meta,
    bucket_samples: int,
    premixed: bool,
    positions: Optional[torch.Tensor] = None,
):
    """Device-side batch reconstruction: [B] metadata -> (mix, clean)
    float32 [B, bucket_samples] on the flats' device.

    `meta` has the CachedBatch fields `clean_chunk`, `clean_off`,
    `other_chunk`, `other_off`, `scale` and `lengths` (numpy arrays or
    tensors).  Samples past each utterance's length are zero, as the host
    collate pads.  Callers guarantee ``bucket_samples - length <=
    corpus.pad_samples`` per item (DeviceCacheLoader checks it), so no
    slice leaves its row.  `positions` is ``arange(bucket_samples)`` on
    the flats' device; a caller that materializes one bucket many times
    builds it once."""
    dev = clean_flat.device

    def on_dev(a):
        return torch.as_tensor(a).to(dev, non_blocking=True)

    if positions is None:
        positions = torch.arange(bucket_samples, device=dev)
    lengths = on_dev(meta.lengths)
    valid = positions[None, :] < lengths[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cl = _window(clean_flat, on_dev(meta.clean_chunk), on_dev(meta.clean_off), positions)
    ot = _window(other_flat, on_dev(meta.other_chunk), on_dev(meta.other_off), positions)
    cl = torch.where(valid, cl.to(torch.float32) / 32768.0, zero)
    ot = torch.where(valid, ot.to(torch.float32) / 32768.0, zero)
    if premixed:
        return ot, cl
    return cl + on_dev(meta.scale).to(torch.float32)[:, None] * ot, cl


class DeviceCacheLoader:
    """Bucketed metadata loader over a DeviceCorpus.

    Has the loader surface the Trainer uses (set_epoch, __len__, __iter__)
    but yields CachedBatch metadata instead of waveforms.  Buckets come
    from the exact decoded lengths (the host loader buckets on manifest
    durations); batches are static-size with the host sampler's
    repeat-tail padding."""

    def __init__(
        self,
        corpus: DeviceCorpus,
        dsp: DSPConfig,
        batch_size: int,
        bucket_frames: Sequence[int] = (64, 128, 192, 256, 384, 512, 768, 1024),
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.corpus = corpus
        self.dsp = dsp
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.boundaries = sorted(bucket_frames)
        self._frames = [dsp.num_frames(int(n)) for n in corpus.item_lengths]
        # Row-end guard: a slice reads bucket_samples from an item's start,
        # and each row ends with only `pad_samples` of zeros; an item whose
        # bucket slack exceeds that would read the next row.  Refuse.
        worst, max_bs = 0, 0
        for f, ln in zip(self._frames, corpus.item_lengths):
            bs = dsp.padded_samples(self.bucket_for(f))
            worst = max(worst, bs - int(ln))
            max_bs = max(max_bs, bs)
        if worst > corpus.pad_samples:
            raise ValueError(
                f"corpus tail pad ({corpus.pad_samples} samples) is smaller "
                f"than the worst-case bucket slack ({worst}); rebuild the "
                f"corpus with max_bucket_frames >= "
                f"{max(self.bucket_for(f) for f in self._frames)} "
                f"(build_device_corpus sizes the pad from it)"
            )
        for name, arr in (("clean", corpus.clean), ("other", corpus.other)):
            if self._frames and max_bs > arr.shape[1]:
                raise ValueError(
                    f"largest bucket slice ({max_bs} samples) exceeds the "
                    f"{name} corpus chunk width ({arr.shape[1]}); rebuild "
                    f"with max_bucket_frames >= "
                    f"{max(self.bucket_for(f) for f in self._frames)}"
                )
        self._epoch = 0

    def bucket_for(self, frames: int) -> int:
        for b in self.boundaries:
            if frames <= b:
                return b
        top = self.boundaries[-1]
        return ((frames + top - 1) // top) * top

    # -- the cached-loader surface (shared with the rotating loader) -------

    @property
    def premixed(self) -> bool:
        return self.corpus.premixed

    def activate(self, device="cuda") -> None:
        """Commit the corpus flats to `device` (idempotent)."""
        self.corpus.commit(device)

    def flats(self):
        """(clean_flat, other_flat) backing the current batches."""
        return self.corpus.clean, self.corpus.other

    @property
    def generation(self) -> int:
        """Id of the flats backing the current batches; this loader
        commits once, so it never changes.  The Trainer's feeder keys its
        groups on it."""
        return 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _plan(self, epoch: int):
        rng = np.random.default_rng((self.seed, epoch))
        order = np.arange(len(self._frames))
        if self.shuffle:
            rng.shuffle(order)
        by_bucket: dict = {}
        for i in order:
            by_bucket.setdefault(self.bucket_for(self._frames[i]), []).append(int(i))
        out = []
        for bucket, idxs in sorted(by_bucket.items()):
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start : start + self.batch_size]
                while len(chunk) < self.batch_size:
                    chunk = chunk + chunk[: self.batch_size - len(chunk)]
                out.append((bucket, chunk))
        if self.shuffle:
            rng.shuffle(out)
        return out

    def __len__(self) -> int:
        return len(self._plan(0))

    def pad_len(self, bucket_frames: int) -> int:
        return self.dsp.padded_samples(bucket_frames)

    def __iter__(self):
        assignment = self.corpus.noise_assignment(self._epoch)
        for bucket, idxs in self._plan(self._epoch):
            B = len(idxs)
            ccs = np.zeros(B, np.int32)
            cos = np.zeros(B, np.int32)
            ocs = np.zeros(B, np.int32)
            oos = np.zeros(B, np.int32)
            sc = np.zeros(B, np.float32)
            ln = np.zeros(B, np.int32)
            for j, i in enumerate(idxs):
                cc, co, oc, oo, s = self.corpus.item_meta(i, self._epoch, assignment)
                ccs[j], cos[j], ocs[j], oos[j], sc[j] = cc, co, oc, oo, s
                ln[j] = int(self.corpus.item_lengths[i])
            yield CachedBatch(ccs, cos, ocs, oos, sc, ln, np.asarray(idxs, np.int32), bucket)


def build_device_corpus(
    manifest_path: str,
    noise_manifest: Optional[str],
    dsp: DSPConfig,
    data: Optional[DataConfig] = None,
    max_bucket_frames: int = 1024,
    chunk_limit: int = CHUNK_LIMIT_DEFAULT,
    entries: Optional[List[ManifestEntry]] = None,
) -> DeviceCorpus:
    """Read the manifests and build the flats on the host (`commit` puts
    them on a device).  `entries` (duration-filtered) skips the manifest
    read."""
    min_d = data.min_duration if data else 0.4
    max_d = data.max_duration if data else float("inf")
    if entries is None:
        entries = read_manifest(manifest_path, min_d, max_d)
    noise_entries = read_manifest(noise_manifest) if noise_manifest else None
    return DeviceCorpus(
        entries,
        noise_entries,
        dsp.sample_rate,
        pad_samples=dsp.padded_samples(max_bucket_frames),
        snr_db=data.snr if data else 0.0,
        seed=data.seed if data else 0,
        chunk_limit=chunk_limit,
        num_workers=data.num_workers if data else 1,
        use_native=data.use_native if data else False,
    )


class RotatingDeviceCacheLoader:
    """Epoch-partitioned device cache for corpora larger than the card.

    The manifest splits into shards whose int16 flats fit
    `hbm_budget_bytes`; every shard is decoded ONCE up front (with
    `spill_dir`, spilled to disk memmaps so host RAM holds about one shard)
    and rotated through the card during the epoch: commit a shard, train
    its batches, release it, next.  Every shard commits at ONE common flat
    shape, zero-padded into fresh device tensors (`commit_flats`), so each
    (bucket, K) step sees one shape across shards and epochs.

    Each shard behaves exactly like a `DeviceCacheLoader` over its
    sub-manifest, with its RNG streams seeded per shard.  An epoch visits
    every item once (plus each shard's static-batch tail repeats), shard
    order reshuffled per epoch.  Steady-state host-to-device traffic is
    the per-batch metadata plus ONE flats transfer per shard per epoch.

    Sizing: keep `hbm_budget_bytes` at about 40% of free device memory:
    while the next shard commits, batches in flight still reference the
    previous shard's flats, so two shards are briefly resident."""

    def __init__(
        self,
        manifest_path: str,
        noise_manifest: Optional[str],
        dsp: DSPConfig,
        batch_size: int,
        data: Optional[DataConfig] = None,
        hbm_budget_bytes: int = 6 << 30,
        bucket_frames: Sequence[int] = (64, 128, 192, 256, 384, 512, 768, 1024),
        shuffle: bool = True,
        seed: Optional[int] = None,
        spill_dir: Optional[str] = None,
        chunk_limit: int = CHUNK_LIMIT_DEFAULT,
        entries: Optional[List[ManifestEntry]] = None,
    ):
        min_d = data.min_duration if data else 0.4
        max_d = data.max_duration if data else float("inf")
        self.snr = data.snr if data else 0.0
        # an explicit seed wins; None defers to data.seed
        self.seed = seed if seed is not None else (data.seed if data is not None else 0)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.dsp = dsp
        if entries is None:
            entries = read_manifest(manifest_path, min_d, max_d)
        if not entries:
            raise ValueError(f"empty manifest {manifest_path}")
        noise_entries = read_manifest(noise_manifest) if noise_manifest else None
        pad = dsp.padded_samples(max(bucket_frames))

        # Greedy split by estimated int16 bytes (manifest durations; the
        # decoded lengths differ by at most resampling rounding, covered
        # by the 5% slack).
        budget = int(hbm_budget_bytes * 0.95)
        shards: List[List[ManifestEntry]] = [[]]
        acc = total_bytes = 0
        for e in entries:
            nbytes = int(e.duration * dsp.sample_rate) * 2 * (2 if e.is_premixed else 1)
            if shards[-1] and acc + nbytes > budget:
                shards.append([])
                acc = 0
            shards[-1].append(e)
            acc += nbytes
            total_bytes += nbytes
        if spill_dir is None and total_bytes > _host_ram_soft_limit():
            logger.warning(
                "RotatingDeviceCacheLoader will hold ~%.1f GB of decoded "
                "corpus in host RAM (no spill_dir set); pass spill_dir= "
                "to keep about one shard resident through disk memmaps",
                total_bytes / 2**30,
            )

        num_workers = data.num_workers if data else 1
        use_native = data.use_native if data else False
        # decode the noise corpus ONCE; every shard shares the flat and
        # (below) the float64 cumulative-square tables
        shared_noise = (
            FlatCorpus.build(
                [e.audio_filepath for e in noise_entries],
                dsp.sample_rate,
                pad,
                chunk_limit=chunk_limit,
                num_workers=num_workers,
                use_native=use_native,
            )
            if noise_entries
            else None
        )
        if shared_noise is not None and spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
            shared_noise = shared_noise._replace(
                flat=_spill(shared_noise.flat, os.path.join(spill_dir, "noise.npy"))
            )
        self._corpora: List[DeviceCorpus] = []
        self._loaders: List[DeviceCacheLoader] = []
        for si, shard_entries in enumerate(shards):
            shard_seed = (self.seed * 1_000_003 + si) & 0x7FFFFFFF  # per-shard RNG streams
            corpus = DeviceCorpus(
                shard_entries,
                noise_entries,
                dsp.sample_rate,
                pad_samples=pad,
                snr_db=self.snr,
                seed=shard_seed,
                chunk_limit=chunk_limit,
                num_workers=num_workers,
                use_native=use_native,
                shared_noise=shared_noise,
            )
            if spill_dir is not None:
                os.makedirs(spill_dir, exist_ok=True)
                # rebind the commit views AND the host FlatCorpus (read by
                # item_meta) so the RAM copies become collectable; the
                # shared noise flat was spilled once above, so `other`
                # spills only for premixed mixes
                corpus.clean = _spill(corpus.clean, os.path.join(spill_dir, f"clean_{si}.npy"))
                corpus.clean_host = corpus.clean_host._replace(flat=corpus.clean)
                if corpus.premixed:
                    corpus.other = _spill(corpus.other, os.path.join(spill_dir, f"other_{si}.npy"))
                    corpus.other_host = corpus.other_host._replace(flat=corpus.other)
            self._corpora.append(corpus)
            self._loaders.append(
                DeviceCacheLoader(
                    corpus, dsp, batch_size, bucket_frames=bucket_frames,
                    shuffle=shuffle, seed=shard_seed,
                )
            )
        self.premixed = self._corpora[0].premixed
        if any(c.premixed != self.premixed for c in self._corpora):
            raise ValueError("mixed premixed/non-premixed shards")
        if shared_noise is not None and len(self._corpora) > 1:
            # the cumulative-square tables depend only on the shared noise
            # flat: compute once, inject everywhere
            self._corpora[0]._ensure_power_caches()
            for c in self._corpora[1:]:
                c._noise_cumsq = self._corpora[0]._noise_cumsq

        # One common commit shape per flat kind.
        self._clean_shape = (
            max(c.clean.shape[0] for c in self._corpora),
            max(c.clean.shape[1] for c in self._corpora),
        )
        self._other_shape = (
            max(c.other.shape[0] for c in self._corpora),
            max(c.other.shape[1] for c in self._corpora),
        )
        # Non-premixed shards with a shared noise corpus all reference ONE
        # host `other` flat: its device copy commits once and stays.
        self._shared_other = all(c.other is self._corpora[0].other for c in self._corpora)
        self._other_device = None
        self._device = None
        self._resident: Optional[int] = None
        self._flats = None
        self._generation = 0
        self._epoch = 0

    # -- the cached-loader surface ------------------------------------------

    def activate(self, device="cuda") -> None:
        """Record the device; flats commit lazily per rotation."""
        self._device = resolve_device(device)

    def flats(self):
        if self._flats is None:
            raise RuntimeError(
                "no shard resident; iterate the loader (flats are committed per rotation)"
            )
        return self._flats

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        return sum(len(ld) for ld in self._loaders)

    def pad_len(self, bucket_frames: int) -> int:
        return self.dsp.padded_samples(bucket_frames)

    @property
    def num_shards(self) -> int:
        return len(self._corpora)

    def nbytes_resident(self) -> int:
        return (int(np.prod(self._clean_shape)) + int(np.prod(self._other_shape))) * 2

    @property
    def generation(self) -> int:
        """Counter bumped on every shard commit: two batches share a
        generation iff their metadata indexes the same resident flats.
        The Trainer's feeder keys K-step groups and the shard-boundary
        flush on it."""
        return self._generation

    # -- rotation -------------------------------------------------------------

    def _commit_shard(self, si: int) -> None:
        if self._resident == si:
            return
        if self._device is None:
            raise RuntimeError("activate(device) the loader before iterating it")
        c = self._corpora[si]
        # Drop the previous shard's device flats first: batches in flight
        # keep them alive until dispatched.  The shared noise flat stays
        # resident across rotations.
        self._flats = None
        self._resident = None
        if self._shared_other:
            if self._other_device is None:
                (self._other_device,) = commit_flats((c.other,), self._device, (self._other_shape,))
            (clean,) = commit_flats((c.clean,), self._device, (self._clean_shape,))
            self._flats = (clean, self._other_device)
        else:
            self._flats = commit_flats(
                (c.clean, c.other), self._device, (self._clean_shape, self._other_shape)
            )
        self._resident = si
        self._generation += 1

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self._epoch, 7919))
        order = np.arange(self.num_shards)
        if self.shuffle:
            rng.shuffle(order)
        for si in order:
            self._commit_shard(int(si))
            sub = self._loaders[int(si)]
            sub.set_epoch(self._epoch)
            yield from sub


def _host_ram_soft_limit() -> int:
    """Half the host's physical RAM (16 GB where unreadable): past it, an
    un-spilled corpus held in host memory gets a warning."""
    try:
        return (os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")) // 2
    except (ValueError, OSError, AttributeError):
        return 16 << 30


def _spill(arr: np.ndarray, path: str) -> np.ndarray:
    """Write `arr` to a disk-backed numpy memmap and return the memmap, so
    the RAM copy becomes collectable."""
    mm = np.lib.format.open_memmap(path, mode="w+", dtype=arr.dtype, shape=arr.shape)
    mm[...] = arr
    mm.flush()
    return mm
