"""Training engine: epoch loop, checkpointing, validation, telemetry.

Counterpart of `fullycnnspeechenhancement_tpu/train/trainer.py` on one
device.  The reference's `FullyCNNTrainer` (trainer.py:121-338) drives a
TF Session with feed_dict; this engine runs train steps on one device
(the card unless the caller asks for the CPU) from a prefetching host
loader or from the GPU-resident corpus cache (`data/device_cache.py`,
whose batches the cached steps rebuild on the device), with a background
feeder thread that groups same-bucket batches and moves them to the
device, one checkpoint per epoch, validation every `valid_every_epochs`
epochs when the caller passes a validation loader (`eval/evaluator.py`,
BN in batch-statistics mode as in the reference), and JSONL scalar
telemetry.

Hot loop: PyTorch enqueues device work and returns, and the loop never
reads a per-step scalar.  Metrics accumulate as packed device tensors and
come to the host in ONE copy every `num_iter_print` steps
(`_flush_metrics`); the step counter has a host mirror.  With
`steps_per_call > 1` the feeder stacks K same-bucket batches and one
dispatch runs K optimizer steps (`make_multi_step`, or
`make_cached_multi_step` over the cache).  Under the rotating cache the
feeder keys its K-groups on the loader's `generation`, so a group never
mixes two shards' batches, and flushes a shard's residual batches when
the next shard commits.

With `data_parallel = N > 1` the Trainer is one rank of a process group
of N (`parallel/dp.py`; `cli.train` starts the ranks, or torchrun, or
FCSE_MULTIHOST=1): every rank's loader yields the same global batch, and
the feeder keeps the rank's rows (`shard_batch`, of the waveforms or of
the device cache's metadata: the cache commits the whole corpus on every
rank and materializes only those rows); the steps are the DP steps
(sync BN, global masks, gradients summed over the ranks), the state is broadcast from rank 0 once and then
kept equal by identical updates.  Rank 0 alone writes checkpoints, logs
and scalars, and validates while the other ranks wait at a barrier.  A
device without an index ("cuda") becomes the card of the rank's
LOCAL_RANK.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from fullycnnspeechenhancement_torch.config import Config
from fullycnnspeechenhancement_torch.data.device_cache import (
    CachedBatch,
    DeviceCacheLoader,
    RotatingDeviceCacheLoader,
)
from fullycnnspeechenhancement_torch.data.loader import DataLoader, LoaderBatch
from fullycnnspeechenhancement_torch.device import disable_tf32, host_to_device, resolve_device
from fullycnnspeechenhancement_torch.eval.evaluator import Evaluator
from fullycnnspeechenhancement_torch.eval.metrics import AverageMeter
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.parallel import multihost
from fullycnnspeechenhancement_torch.parallel.dp import (
    DataParallel,
    replicate,
    shard_batch,
    shard_stacked_batch,
)
from fullycnnspeechenhancement_torch.train.checkpoint import (
    CheckpointManager,
    find_checkpoint,
    import_reference_npz,
    load_params,
)
from fullycnnspeechenhancement_torch.train.cached_step import (
    Meta,
    make_cached_multi_step,
    make_cached_train_step,
)
from fullycnnspeechenhancement_torch.train.profiling import StepProfiler
from fullycnnspeechenhancement_torch.train.step import (
    Batch,
    create_train_state,
    make_multi_step,
    make_train_step,
    pack_step_metrics,
)

logger = logging.getLogger(__name__)


class Trainer:
    def __init__(self, config: Config, device="cuda"):
        n_dp = config.train.data_parallel
        self.dp = DataParallel.current(n_dp) if n_dp > 1 else None
        self.is_main = self.dp is None or self.dp.is_main
        self.device = resolve_device(device)
        if self.dp is not None and self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", multihost.local_rank())
        disable_tf32()
        self.config = config
        self.model = get_model(config.model.net_work)
        self.run_name = f"{config.model.net_arch}_{config.model.net_work}"
        self._step = make_train_step(config, self.model, dp=self.dp)
        self._steps_per_call = max(1, config.train.steps_per_call)
        self._multi_step = make_multi_step(self._step) if self._steps_per_call > 1 else None
        self._cached_fns: dict = {}
        self._cached_premixed = False
        self._cached_loader = None

        self.state = create_train_state(config, self.model, device=self.device)
        self.ckpt = CheckpointManager(
            config.train.checkpoints_path,
            self.run_name,
            max_to_keep=config.train.max_checkpoints_to_keep,
        )
        self.start_epoch = 0
        if config.train.base_checkpoint_file:
            # Warm start from an EXPLICIT checkpoint, taking priority over
            # resume-from-latest (reference trainer.py:52-53 semantics).
            self._warm_start(config.train.base_checkpoint_file)
        elif config.train.continue_train:
            restored, epoch = self.ckpt.restore(self.state)
            if restored is not None:
                self.state = restored
                self.start_epoch = epoch + 1
                logger.info("resumed from epoch %d checkpoint", epoch)
        if self.dp is not None:
            # Every rank starts from rank 0's state and epoch.
            replicate(self.state, self.dp)
            self.start_epoch = self.dp.broadcast_object(self.start_epoch)

        # Host mirror of the device step counter: read once here, then
        # advanced on the host so the hot loop never waits on it.
        self._host_step = int(self.state.step)

        # In-training validation runs BN in batch-statistics mode, like the
        # reference reusing its training graph (Appendix A.8), and never
        # resets its meters across epochs (Appendix A.11).
        self.evaluator = Evaluator(config, self.model, bn_training_mode=True, device=self.device)
        self._valid_meters = {}

        self.train_loss = AverageMeter()
        self.data_time = AverageMeter()
        self.step_time = AverageMeter()
        self.profiler = StepProfiler()

        os.makedirs(config.train.log_dir, exist_ok=True)
        self._scalars_path = os.path.join(
            config.train.log_dir, f"scalars_{self.run_name}.jsonl"
        )
        logger.info("model %s: %d parameters", self.run_name, self.model.param_count())

    def _warm_start(self, path: str) -> None:
        """Initialise params (+BN stats) from an explicit checkpoint: a
        `.npz` in the TF-name bridge layout, or a checkpoint file or run
        directory of this package (its latest epoch).  Training restarts
        at epoch 0 with fresh optimizer state and step counter."""
        if path.endswith(".npz"):
            params, bn_state = import_reference_npz(path, self.model, self.device)
        elif find_checkpoint(path) is not None:
            params, bn_state = load_params(path, self.device)
        else:
            raise FileNotFoundError(
                f"base_checkpoint_file {path} is neither an .npz bridge file "
                "nor a checkpoint (file or run directory) of this package"
            )
        # npz may omit BN stats (freeze exports fold them); keep the fresh
        # init for anything missing.
        merged_bn = dict(self.state.bn_state)
        merged_bn.update(bn_state)
        with torch.no_grad():
            for name, p in params.items():
                for k, v in p.items():
                    self.state.params[name][k].copy_(v)
        self.state = self.state._replace(bn_state=merged_bn)
        logger.info("warm-started params from %s", path)

    def _log_scalars(self, **kv):
        with open(self._scalars_path, "a") as f:
            f.write(json.dumps(kv) + "\n")

    def _to_device(self, batch: Batch) -> Batch:
        return Batch(*(None if x is None else host_to_device(x, self.device) for x in batch))

    # `flats` is the cached preps' (below); a host batch carries its
    # waveforms.  Under DP only the rank's rows go to the device.
    def _prep_single(self, b: LoaderBatch, flats=None) -> Batch:
        batch = Batch(b.mix_wav, b.clean_wav, b.lengths, b.wav_scale)
        return self._to_device(batch if self.dp is None else shard_batch(self.dp, batch))

    def _prep_multi(self, bufs: list, flats=None) -> Batch:
        batch = Batch(
            np.stack([x.mix_wav for x in bufs]),
            np.stack([x.clean_wav for x in bufs]),
            np.stack([x.lengths for x in bufs]),
            None if bufs[0].wav_scale is None else np.stack([x.wav_scale for x in bufs]),
        )
        return self._to_device(batch if self.dp is None else shard_stacked_batch(self.dp, batch))

    def _dispatch(self, payload: Batch, k: int, epoch: int) -> None:
        if k == 1:
            self.state, metrics = self._step(self.state, payload)
            packed = pack_step_metrics(metrics)[None]
        else:
            self.state, packed = self._multi_step(self.state, payload)
        self._note_steps(packed, k, epoch)

    # -- the device cache (data/device_cache.py) ---------------------------

    def _cached_fn(self, bucket_frames: int, k: int):
        """The cached step for (bucket, K), made on first use: the
        bucket's sample length is known only from the loader."""
        key = (bucket_frames, k)
        fn = self._cached_fns.get(key)
        if fn is None:
            # under DP `_step` is the rank's DP step
            maker = make_cached_train_step if k == 1 else make_cached_multi_step
            fn = maker(self._step, self.config.dsp.padded_samples(bucket_frames), self._cached_premixed)
            self._cached_fns[key] = fn
        return fn

    def _prepare_cached(self, loader) -> None:
        if loader.batch_size != self.config.train.batch_size:
            raise ValueError(
                f"cached loader batch size ({loader.batch_size}) must match "
                f"config.train.batch_size ({self.config.train.batch_size}): the "
                "loss normalization assumes the configured batch"
            )
        self._cached_premixed = loader.premixed
        self._cached_loader = loader
        # The resident loader commits now; the rotating one per rotation.
        loader.activate(self.device)

    def _prep_cached_single(self, b: CachedBatch, flats):
        # `flats` is captured by the feeder when the loader yields the
        # batch: under the rotating loader a batch rides with its shard
        meta = Meta.from_batch(b, self.device)
        return b.bucket_frames, meta if self.dp is None else shard_batch(self.dp, meta), flats

    def _prep_cached_multi(self, bufs: list, flats):
        meta = Meta.stack(bufs, self.device)
        return bufs[0].bucket_frames, meta if self.dp is None else shard_stacked_batch(self.dp, meta), flats

    def _dispatch_cached(self, payload, k: int, epoch: int) -> None:
        bucket_frames, meta, (clean_flat, other_flat) = payload
        self.state, out = self._cached_fn(bucket_frames, k)(self.state, clean_flat, other_flat, meta)
        if k == 1:
            out = pack_step_metrics(out)[None]
        self._note_steps(out, k, epoch)

    def _feed(self, train_loader, K: int, cached: bool = False):
        """Background feeder: consumes the loader, groups same-bucket
        batches for the multi-step path, and moves payloads to the device
        OFF the dispatch thread.  Yields (payload, k, audio_seconds); the
        queue depth bounds device-side buffering to a couple of payloads.

        Over the cache, groups are keyed by (bucket, generation) and each
        batch carries the flats captured when it was received; when the
        rotating loader commits its next shard, the previous shard's
        residual batches go out at once, so its flats are not held to the
        epoch's end."""
        prep_one = self._prep_cached_single if cached else self._prep_single
        prep_multi = self._prep_cached_multi if cached else self._prep_multi
        sr = self.config.dsp.sample_rate
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        _SENTINEL = object()

        def put_one(b, fl, audio):
            q.put((prep_one(b, fl), 1, audio))

        def produce():
            try:
                buffers: dict = {}
                last_gen = None
                for b in train_loader:
                    if stop.is_set():
                        return
                    # the loader rotates only when advanced again, so these
                    # are b's flats
                    fl = self._cached_loader.flats() if cached else None
                    gen = self._cached_loader.generation if cached else 0
                    if last_gen is not None and gen != last_gen:
                        for key in [key for key in buffers if key[1] != gen]:
                            for b2, audio2, fl2 in buffers.pop(key):
                                if stop.is_set():
                                    return
                                put_one(b2, fl2, audio2)
                    last_gen = gen
                    audio = float(b.lengths.sum()) / sr
                    if K > 1:
                        key = (b.bucket_frames, gen)
                        buf = buffers.setdefault(key, [])
                        buf.append((b, audio, fl))
                        if len(buf) == K:
                            group = [x for x, _, _ in buf]
                            q.put((prep_multi(group, fl), K, sum(a for _, a, _ in buf)))
                            buffers[key] = []
                    else:
                        put_one(b, fl, audio)
                # residual same-bucket groups smaller than K run one at a
                # time, each with the flats captured when it was received
                for buf in buffers.values():
                    for b, audio, fl in buf:
                        if stop.is_set():
                            return
                        put_one(b, fl, audio)
            except BaseException as e:  # surfaced to the consumer
                q.put(e)
            finally:
                q.put(_SENTINEL)

        t = threading.Thread(target=produce, daemon=True)
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
            # On a dispatch error or interruption: tell the producer to
            # abandon the epoch, then drain so its blocked put() sees it.
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)

    def _note_steps(self, packed: torch.Tensor, n: int, epoch: int) -> None:
        """Record n dispatched steps' packed [n, 2] device metrics; the
        values come to the host later in one copy (`_flush_metrics`)."""
        rows = [{"step": self._host_step + j, "epoch": epoch} for j in range(n)]
        self._host_step += n
        self._pending.append((packed, rows))
        self._steps_since_flush += n
        self.profiler.step(self._host_step)

    def _flush_metrics(self, log, epoch: int, batch_i: int, n_batches: int):
        """Fetch all pending step metrics in ONE device-to-host copy: the
        loop's only wait for the device."""
        if not self._pending:
            return
        vals = torch.cat([p for p, _ in self._pending]).cpu().numpy()
        rows = [r for _, rs in self._pending for r in rs]
        wall = time.perf_counter() - self._flush_t0
        # Wall time per step across the flush window, data wait included.
        self.step_time.update(wall / max(len(rows), 1))
        for row, v in zip(rows, vals):
            row["loss"] = float(v[0])
            row["lr"] = float(v[1])
            self.train_loss.update(row["loss"])
        self._pending = []
        self._steps_since_flush = 0
        self._flush_t0 = time.perf_counter()
        if not self.is_main:
            return
        with open(self._scalars_path, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        log.info(
            "epoch %d batch %d/%d loss %.4f(%.4f) data %.3fs(%.3fs) step-wall %.3fs(%.3fs)",
            epoch, batch_i, n_batches, self.train_loss.val, self.train_loss.avg,
            self.data_time.val, self.data_time.avg, self.step_time.val, self.step_time.avg,
        )

    def train(
        self,
        train_loader: DataLoader,
        valid_loader: Optional[DataLoader] = None,
        epochs: Optional[int] = None,
        log: Optional[logging.Logger] = None,
    ):
        log = log or logger
        epochs = epochs if epochs is not None else self.config.train.epochs
        cached = isinstance(train_loader, (DeviceCacheLoader, RotatingDeviceCacheLoader))
        try:
            if cached:
                self._prepare_cached(train_loader)
            self._run_epochs(train_loader, valid_loader, epochs, log, cached)
        finally:
            # Teardown even when an epoch raises: wait for the checkpoint
            # writes, stop a running trace and release the scoring workers
            # (the pool is made again if validate() runs later).
            try:
                self.ckpt.wait()
            finally:
                try:
                    self.profiler.close()
                finally:
                    self.evaluator.close()

    def _run_epochs(self, train_loader, valid_loader, epochs, log, cached):
        K = self._steps_per_call
        dispatch = self._dispatch_cached if cached else self._dispatch
        flush_every = max(1, self.config.train.num_iter_print)
        n_batches = len(train_loader)
        for epoch in range(self.start_epoch, epochs):
            train_loader.set_epoch(epoch)
            epoch_audio_s = 0.0
            epoch_t0 = time.perf_counter()
            self._pending = []
            self._steps_since_flush = 0
            self._flush_t0 = time.perf_counter()
            t_data = time.perf_counter()
            steps_done = 0
            for payload, k, audio_s in self._feed(train_loader, K, cached):
                self.data_time.update(time.perf_counter() - t_data)
                epoch_audio_s += audio_s
                dispatch(payload, k, epoch)
                steps_done += k
                if self._steps_since_flush >= flush_every:
                    self._flush_metrics(log, epoch, steps_done, n_batches)
                t_data = time.perf_counter()
            self._flush_metrics(log, epoch, n_batches, n_batches)
            wall = time.perf_counter() - epoch_t0
            if self.is_main:
                log.info(
                    "epoch %d done: %.1f audio-s in %.1f s (%.1f audio-s/s)",
                    epoch, epoch_audio_s, wall, epoch_audio_s / max(wall, 1e-9),
                )
                self.ckpt.save(epoch, self.state)
            if valid_loader is not None and (epoch + 1) % self.config.train.valid_every_epochs == 0:
                self.validate(valid_loader, epoch, log)

    def validate(self, valid_loader: DataLoader, epoch: int, log=None):
        """Score the validation set with the current params and BN state
        (batch statistics; `bn_state` is left as it was), dump its wav
        triplets under `audio_save_path/<epoch>` and log `valid_*`
        scalars.  Under data parallelism rank 0 validates (the state is
        the same on every rank) while the others wait at a barrier and
        return None."""
        log = log or logger
        if not self.is_main:
            self.dp.barrier()
            return None
        try:
            return self._validate(valid_loader, epoch, log)
        finally:
            if self.dp is not None:
                self.dp.barrier()

    def _validate(self, valid_loader: DataLoader, epoch: int, log):
        # The checkpoint write first: the scoring pool forks on first use,
        # and must not fork while the writer thread is busy.
        self.ckpt.wait()
        valid_loader.set_epoch(0)  # the same mixing every validation
        save_dir = os.path.join(self.config.data.audio_save_path, str(epoch))
        results = self.evaluator.evaluate(
            valid_loader,
            self.state.params,
            self.state.bn_state,
            save_dir=save_dir,
            meters=self._valid_meters,
        )
        msg = ", ".join(f"{k}={v:.4f}" for k, v in sorted(results.items()))
        log.info("epoch %d validation: %s", epoch, msg)
        self._log_scalars(epoch=epoch, **{f"valid_{k}": v for k, v in results.items()})
        return results
