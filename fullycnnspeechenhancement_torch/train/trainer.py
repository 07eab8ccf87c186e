"""Training engine: epoch loop, checkpointing, validation, telemetry.

Counterpart of `fullycnnspeechenhancement_tpu/train/trainer.py` on its
host-loader, single-device path.  The reference's `FullyCNNTrainer`
(trainer.py:121-338) drives a TF Session with feed_dict; this engine runs
train steps on one device (the card unless the caller asks for the CPU)
with a prefetching loader, a background feeder thread that groups
same-bucket batches and moves them to the device, one checkpoint per
epoch, validation every `valid_every_epochs` epochs when the caller
passes a validation loader (`eval/evaluator.py`, BN in batch-statistics
mode as in the reference), and JSONL scalar telemetry.

Hot loop: PyTorch enqueues device work and returns, and the loop never
reads a per-step scalar.  Metrics accumulate as packed device tensors and
come to the host in ONE copy every `num_iter_print` steps
(`_flush_metrics`); the step counter has a host mirror.  With
`steps_per_call > 1` the feeder stacks K same-bucket batches and one
dispatch runs K optimizer steps (`make_multi_step`).

Not ported yet, and each raises `NotImplementedError` naming its
ROADMAP.md item: the GPU-resident corpus cache (`use_device_cache`, Queue
1 item 8) and data parallelism (`data_parallel > 1`, item 10).
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
from fullycnnspeechenhancement_torch.data.loader import DataLoader, LoaderBatch
from fullycnnspeechenhancement_torch.device import disable_tf32, resolve_device
from fullycnnspeechenhancement_torch.eval.evaluator import Evaluator
from fullycnnspeechenhancement_torch.eval.metrics import AverageMeter
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.train.checkpoint import (
    CheckpointManager,
    find_checkpoint,
    import_reference_npz,
    load_params,
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
        if config.data.use_device_cache:
            raise NotImplementedError(
                "use_device_cache: the GPU-resident corpus cache is not ported "
                "yet (ROADMAP.md Queue 1 item 8)"
            )
        if config.train.data_parallel > 1:
            raise NotImplementedError(
                f"data_parallel={config.train.data_parallel}: data parallelism "
                "is not ported yet (ROADMAP.md Queue 1 item 10)"
            )
        self.device = resolve_device(device)
        disable_tf32()
        self.config = config
        self.model = get_model(config.model.net_work)
        self.run_name = f"{config.model.net_arch}_{config.model.net_work}"
        self._step = make_train_step(config, self.model)
        self._steps_per_call = max(1, config.train.steps_per_call)
        self._multi_step = make_multi_step(self._step) if self._steps_per_call > 1 else None

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

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            # pinned, so the copy is queued on the stream and the feeder
            # thread does not wait for the device
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _prep_single(self, b: LoaderBatch) -> Batch:
        return Batch(
            self._to_device(b.mix_wav),
            self._to_device(b.clean_wav),
            self._to_device(b.lengths),
            None if b.wav_scale is None else self._to_device(b.wav_scale),
        )

    def _prep_multi(self, bufs: list) -> Batch:
        return Batch(
            self._to_device(np.stack([x.mix_wav for x in bufs])),
            self._to_device(np.stack([x.clean_wav for x in bufs])),
            self._to_device(np.stack([x.lengths for x in bufs])),
            None
            if bufs[0].wav_scale is None
            else self._to_device(np.stack([x.wav_scale for x in bufs])),
        )

    def _dispatch(self, payload: Batch, k: int, epoch: int) -> None:
        if k == 1:
            self.state, metrics = self._step(self.state, payload)
            packed = pack_step_metrics(metrics)[None]
        else:
            self.state, packed = self._multi_step(self.state, payload)
        self._note_steps(packed, k, epoch)

    def _feed(self, train_loader, K: int):
        """Background feeder: consumes the loader, groups same-bucket
        batches for the multi-step path, and moves payloads to the device
        OFF the dispatch thread.  Yields (payload, k, audio_seconds); the
        queue depth bounds device-side buffering to a couple of payloads."""
        sr = self.config.dsp.sample_rate
        q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()
        _SENTINEL = object()

        def produce():
            try:
                buffers: dict = {}
                for b in train_loader:
                    if stop.is_set():
                        return
                    audio = float(b.lengths.sum()) / sr
                    if K > 1:
                        buf = buffers.setdefault(b.bucket_frames, [])
                        buf.append((b, audio))
                        if len(buf) == K:
                            q.put((self._prep_multi([x for x, _ in buf]), K,
                                   sum(a for _, a in buf)))
                            buffers[b.bucket_frames] = []
                    else:
                        q.put((self._prep_single(b), 1, audio))
                # residual same-bucket groups smaller than K run one at a time
                for buf in buffers.values():
                    for b, audio in buf:
                        if stop.is_set():
                            return
                        q.put((self._prep_single(b), 1, audio))
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
        with open(self._scalars_path, "a") as f:
            for row, v in zip(rows, vals):
                row["loss"] = float(v[0])
                row["lr"] = float(v[1])
                self.train_loss.update(row["loss"])
                f.write(json.dumps(row) + "\n")
        log.info(
            "epoch %d batch %d/%d loss %.4f(%.4f) data %.3fs(%.3fs) step-wall %.3fs(%.3fs)",
            epoch, batch_i, n_batches, self.train_loss.val, self.train_loss.avg,
            self.data_time.val, self.data_time.avg, self.step_time.val, self.step_time.avg,
        )
        self._pending = []
        self._steps_since_flush = 0
        self._flush_t0 = time.perf_counter()

    def train(
        self,
        train_loader: DataLoader,
        valid_loader: Optional[DataLoader] = None,
        epochs: Optional[int] = None,
        log: Optional[logging.Logger] = None,
    ):
        log = log or logger
        epochs = epochs if epochs is not None else self.config.train.epochs
        try:
            self._run_epochs(train_loader, valid_loader, epochs, log)
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

    def _run_epochs(self, train_loader, valid_loader, epochs, log):
        K = self._steps_per_call
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
            for payload, k, audio_s in self._feed(train_loader, K):
                self.data_time.update(time.perf_counter() - t_data)
                epoch_audio_s += audio_s
                self._dispatch(payload, k, epoch)
                steps_done += k
                if self._steps_since_flush >= flush_every:
                    self._flush_metrics(log, epoch, steps_done, n_batches)
                t_data = time.perf_counter()
            self._flush_metrics(log, epoch, n_batches, n_batches)
            wall = time.perf_counter() - epoch_t0
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
        scalars."""
        log = log or logger
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
