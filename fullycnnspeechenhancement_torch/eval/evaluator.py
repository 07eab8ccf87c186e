"""Batch evaluator: model prediction -> waveform rebuild -> host metrics.

The port's copy of `fullycnnspeechenhancement_tpu/eval/evaluator.py`.  It
serves both reference eval paths (SURVEY.md SS3.2/SS3.3): in-training
validation, which runs the training graph, so BN uses batch statistics
(Appendix A.8), and the standalone tester (BN in inference mode).  The
magnitude/phase split, prediction and rebuild run on the evaluator's device
(the card unless the caller asks for the CPU) under `torch.no_grad()` with
TF32 off; with `model.fused_inference` and BN in inference mode the inner
layers run in the fused stack kernel, one launch a batch.  The rebuilt
waveforms come to the host in one copy a batch; the host truncates each
utterance, scores it (STOI and SDR always, PESQ or its labelled proxy) and
writes the clean/mix/denoised wav triplets.

Scoring runs in a fork-based process pool.  The parent may hold a CUDA
context when it forks; that is safe because a scorer touches only numpy,
`eval/metrics.py` and `data/native.py`, never CUDA (torch makes any CUDA
call in a forked child raise, which would surface as `score_failures`).

The last batch of each bucket is padded to the batch size with tail
repeats; they run through the device forward but are scored once (the
`seen` filter below).
"""

from __future__ import annotations

import logging
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import Dict, Optional

import numpy as np
import torch

from fullycnnspeechenhancement_torch.config import Config
from fullycnnspeechenhancement_torch.data.audio_io import write_wav
from fullycnnspeechenhancement_torch.data.loader import DataLoader
from fullycnnspeechenhancement_torch.device import disable_tf32, resolve_device
from fullycnnspeechenhancement_torch.dsp.rebuild import WaveformRebuilder
from fullycnnspeechenhancement_torch.eval.metrics import PESQ, AverageMeter, sdr, stoi
from fullycnnspeechenhancement_torch.models.rced import ModelDef
from fullycnnspeechenhancement_torch.train.step import make_eval_step

logger = logging.getLogger(__name__)

# Per-process scorer cache for the fork-pool workers (each worker builds
# its own PESQ state on first use; the ctypes library handle is inherited
# from the parent, which loaded it when the Evaluator was built).
_worker_scorers: dict = {}


def _get_scorers(sr: int):
    got = _worker_scorers.get(sr)
    if got is None:
        got = (PESQ(sr=sr), PESQ(sr=sr, allow_proxy=True))
        _worker_scorers[sr] = got
    return got


def _warm_worker(sr):
    """Pool warm-up task: forces the worker to exist now (the sleep keeps
    the task resident long enough that the executor fans out to all
    workers instead of reusing one) and resolves the scorers inside it, so
    no import machinery runs during real scoring."""
    import time as _time

    _time.sleep(0.05)
    _get_scorers(sr)
    return os.getpid()


def _score_arrays(clean, mix, den, path, save_dir, sr):
    """Score one utterance (STOI, SDR, and PESQ or the labelled proxy) and
    write its wav triplet.  Module-level and numpy-only, so it runs in
    fork-pool workers: STOI is GIL-bound numpy, which a thread pool would
    serialise.  It reads module globals, not frozen closures, so a test's
    monkeypatch reaches the children, which fork after the patch."""
    pesq, proxy = _get_scorers(sr)
    out = {"stoi": stoi(clean, den, sr), "sdr": sdr(clean, den)}
    if pesq.available:
        out["pesq"] = pesq(clean, den)
    else:
        out["pesq_proxy"] = proxy(clean, den)
    if save_dir is not None and path is not None:
        base = os.path.basename(path)
        write_wav(os.path.join(save_dir, base), clean, sr)
        write_wav(os.path.join(save_dir, base.replace(".wav", "_mix.wav")), mix, sr)
        write_wav(os.path.join(save_dir, base.replace(".wav", "_de.wav")), den, sr)
    return out


class Evaluator:
    def __init__(
        self,
        config: Config,
        model: ModelDef,
        bn_training_mode: bool = False,
        num_workers: int = 8,
        scoring: str = "process",
        device="cuda",
    ):
        """`scoring`: "process" (the default) scores in a fork-based process
        pool, so GIL-bound STOI runs on many cores; fork, not spawn, so
        workers inherit the parent's imports.  "thread" scores in a thread
        pool, and is also the fallback where fork is unavailable."""
        self.device = resolve_device(device)
        disable_tf32()
        self.config = config
        self.rebuilder = WaveformRebuilder(config.dsp)
        self._eval_step = make_eval_step(config, model, is_training=bn_training_mode)
        # Built (and the native runtime loaded) here, before any fork.
        self.pesq = PESQ(sr=config.dsp.sample_rate)
        self.num_workers = num_workers
        if scoring == "process":
            try:
                multiprocessing.get_context("fork")
            except ValueError:
                scoring = "thread"
        self.scoring = scoring
        self._pool = None
        self._pool_breaks = 0
        self._pool_marked_broken = False
        self._warned_pesq = False

    @torch.no_grad()
    def _predict_and_rebuild(self, params, bn_state, mix_wav: np.ndarray, lengths: np.ndarray):
        """[B, L] waveforms -> rebuilt [B, L] float32 on the host, in one copy."""
        mix = torch.from_numpy(np.asarray(mix_wav, np.float32)).to(self.device)
        lens = torch.from_numpy(np.asarray(lengths, np.int32)).to(self.device)
        pred_mag, phase_re, phase_im = self._eval_step(params, bn_state, mix, lens)
        return self.rebuilder(pred_mag, phase_re, phase_im).cpu().numpy()

    def _get_pool(self):
        """Lazily created and reused across evaluate() calls, so the pool
        forks once per Evaluator.  A pool whose worker died is replaced
        here rather than reused; after three breaks scoring degrades to
        threads."""
        broken = self._pool_marked_broken or (
            self._pool is not None and getattr(self._pool, "_broken", False)
        )
        if self._pool is not None and broken:
            self._pool.shutdown(wait=False)
            self._pool = None
            self._pool_marked_broken = False
            self._pool_breaks += 1
            if self._pool_breaks >= 3 and self.scoring == "process":
                # something keeps killing scorer processes (a native crash,
                # the OOM killer): thread scoring for this Evaluator's life
                # rather than forking forever
                logger.warning(
                    "scoring pool broke %d times; degrading to threads", self._pool_breaks
                )
                self.scoring = "thread"
        if self._pool is None:
            if self.scoring == "process":
                self._pool = ProcessPoolExecutor(
                    self.num_workers, mp_context=multiprocessing.get_context("fork")
                )
                # Fork every worker now, while the caller controls which
                # threads are live: forking lazily mid-pass, with the
                # loader's prefetch threads running, could copy a lock
                # another thread holds into the child.
                for f in [
                    self._pool.submit(_warm_worker, self.config.dsp.sample_rate)
                    for _ in range(self.num_workers)
                ]:
                    try:
                        f.result(timeout=60)
                    except Exception:  # noqa: BLE001
                        self._pool_marked_broken = True
                        break
            else:
                self._pool = ThreadPoolExecutor(self.num_workers)
        return self._pool

    def _submit(self, args):
        """Submit one scoring job -> (pool, future), always through
        `_get_pool()`: it replaces a broken pool (a stale handle would tear
        down the healthy replacement) and degrades to threads after
        repeated breaks."""
        while True:
            pool = self._get_pool()
            try:
                return pool, pool.submit(_score_arrays, *args)
            except BrokenProcessPool:
                # an explicit flag, not only the executor's private
                # attribute, so the next _get_pool() replaces it
                self._pool_marked_broken = True

    def _mark_broken(self, pool) -> None:
        """A future of `pool` found it broken.  Only the pool in use is
        marked: a late future of a pool already replaced must not tear
        down its healthy successor (each needless replacement counts as
        a break toward the fallback to threads)."""
        if pool is self._pool:
            self._pool_marked_broken = True

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):  # best effort; close() is the API
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    def evaluate(
        self,
        loader: DataLoader,
        params,
        bn_state,
        save_dir: Optional[str] = None,
        meters: Optional[Dict[str, AverageMeter]] = None,
    ) -> Dict[str, float]:
        """Run the whole loader; returns the metric averages (and the count
        of skipped utterances as `score_failures`).  Pass `meters` to
        accumulate across calls (the reference's never-reset meters,
        Appendix A.11)."""
        if meters is None:
            meters = {}
        if not self.pesq.available and not self._warned_pesq:
            logger.warning(
                "No ITU P.862 implementation installed; reporting "
                "'pesq_proxy' (fwSegSNR-based, NOT a PESQ score) instead."
            )
            self._warned_pesq = True
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)

        sr = self.config.dsp.sample_rate
        # Create and warm the pool before iterating the loader: `for batch
        # in loader` starts its prefetch threads, and the pool must not
        # fork while they are live.
        self._get_pool()

        def fail():
            logger.exception("per-utterance scoring failed; skipping")
            meters.setdefault("score_failures", AverageMeter()).update(1.0)

        def resolve(item):
            # One bad utterance must not end the pass: log and skip.  A dead
            # worker breaks every future queued on its pool, so each
            # utterance gets one retry on a fresh pool; returns the
            # re-queued item in that case, else None.
            (pool, job), args, retried = item
            try:
                scores = job.result()
            except BrokenProcessPool:
                self._mark_broken(pool)
                if not retried:
                    logger.warning("scoring pool died under this utterance; retrying it on a fresh pool")
                    return (self._submit(args), args, True)
                fail()
                return None
            except Exception:  # noqa: BLE001
                fail()
                return None
            for k, v in scores.items():
                meters.setdefault(k, AverageMeter()).update(v)
            return None

        # Futures resolve lazily, not per batch, so scoring overlaps the
        # next batches' loading and device work.  Each job carries its own
        # copies (a slice would pin the whole [B, L] batch), and at most
        # max_pending jobs wait.
        max_pending = max(64, 8 * self.num_workers)
        jobs = []
        for batch in loader:
            rebuilt = self._predict_and_rebuild(params, bn_state, batch.mix_wav, batch.lengths)
            seen = set()
            for j in range(len(batch.lengths)):
                idx = int(batch.indices[j])
                if idx in seen:  # static-batch tail repeats score once
                    continue
                seen.add(idx)
                n = int(batch.lengths[j])
                entry = loader.dataset.items[idx]
                args = (
                    np.array(batch.clean_wav[j, :n], copy=True),
                    np.array(batch.mix_wav[j, :n], copy=True),
                    np.array(rebuilt[j, :n], copy=True),
                    entry.clean_path,
                    save_dir,
                    sr,
                )
                jobs.append((self._submit(args), args, False))
                while len(jobs) > max_pending:
                    requeued = resolve(jobs.pop(0))
                    if requeued is not None:
                        jobs.append(requeued)
        while jobs:
            requeued = resolve(jobs.pop(0))
            if requeued is not None:
                jobs.append(requeued)
        # score_failures is the count of skipped utterances (cumulative
        # when meters persist): an average of 1.0s would always read 1.0
        return {k: (m.sum if k == "score_failures" else m.avg) for k, m in meters.items()}
