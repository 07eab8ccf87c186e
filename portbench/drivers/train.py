"""Training window: `Trainer.train` over the cell's configuration and
corpus, on the loader the training CLI builds for it (`cli.train.
build_loaders`: the device cache's), paced by the benchmark.

The loader is paced by a subclass of its own class (`paced`), which the
Trainer drives through the loader surface it already uses:

  * epochs 0-2 each yield one batch: the first three batches of epoch 0's
    plan with no row repeated.  These are the checked steps: the state
    before, after one and after three steps is copied at the epoch
    boundaries, where the Trainer has synced;
  * epoch 3 warms every bucket the corpus fills with one single step,
    and the K-step dispatch (the configuration's `steps_per_call`, a loop
    of the same step) with one group of the first bucket that has K
    batches;
  * epoch 4 is the window: the loader's own plans for epochs 4, 5, ...
    one after another, as one long epoch of the whole training split
    would run (the benchmark's corpus is a cut of it, so one plan is a
    few seconds of work), until the deadline passes; then the loader
    stops yielding, the Trainer runs what it holds and ends the epoch
    (its metrics flush syncs the device), and the next epoch's
    `set_epoch` closes the window.

Every batch yielded in the window is a step completed in it, so the
window's audio is the real (unpadded) audio of those batches.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from portbench import check, devtrace, gen
from portbench.drivers import Outcome, Readings, memory_peak, program_config
from portbench.reference import dsp
from portbench.reference.specs import MODELS

CHECK_STEPS = 3
WARM_EPOCH = CHECK_STEPS
WINDOW_EPOCH = CHECK_STEPS + 1


class WindowClosed(Exception):
    """Raised from `set_epoch` at the first epoch boundary past the deadline."""


def _copy(tree) -> dict:
    return {n: {k: v.detach().to("cpu", copy=True) for k, v in d.items()} for n, d in tree.items()}


class Pacer:
    """What the paced loader yields in each epoch, and what the window
    saw."""

    def __init__(self, seconds: float, steps_per_call: int, sample_rate: int, trace: bool,
                 check_only: bool = False):
        self.seconds = seconds
        self.check_only = check_only
        self.k = steps_per_call
        self.sr = sample_rate
        self.window = devtrace.Window() if trace else None
        self.trainer = None
        self.epoch = None
        self.deadline = None
        self.snapshots, self.losses, self.check_batches = {}, [], []
        self.steps, self.audio_s = [], 0.0
        self.t_start = self.t_end = None
        self.marks = {}  # set-up stage -> seconds, printed to standard error
        self.wait0 = self.wait1 = None

    def _state(self) -> dict:
        st = self.trainer.state
        return {"params": _copy(st.params), "bn": _copy(st.bn_state), "mu": _copy(st.opt_state.mu)}

    def on_epoch(self, epoch: int) -> int:
        """Called at each epoch boundary; returns the plan epoch to draw."""
        now = time.perf_counter()
        self.epoch = epoch
        if 1 <= epoch <= CHECK_STEPS:
            self.losses.append(self.trainer.train_loss.val)
        self.marks[f"epoch_{epoch}_at"] = now
        if epoch in (0, 1, CHECK_STEPS):
            self.snapshots[epoch] = self._state()
        if epoch == WARM_EPOCH and self.check_only:
            raise WindowClosed
        if epoch == WINDOW_EPOCH:
            dt = self.trainer.data_time
            self.wait0 = (dt.sum, dt.count)
            if self.window is not None:
                self.window.start()
            self.t_start = time.perf_counter()
            self.deadline = self.t_start + self.seconds
        elif epoch > WINDOW_EPOCH:  # the window's epoch has ended: the deadline has passed
            self.t_end = now
            if self.window is not None:
                self.window.stop()
            dt = self.trainer.data_time
            self.wait1 = (dt.sum, dt.count)
            raise WindowClosed
        return epoch if epoch >= WINDOW_EPOCH else 0

    def program(self) -> dict:
        """The checked steps as `check.train_numbers` reads them."""
        s0, s1, s3 = (self.snapshots[e] for e in (0, 1, CHECK_STEPS))
        return {"losses": self.losses, "params0": s0["params"], "bn0": s0["bn"], "mu1": s1["mu"],
                "params3": s3["params"], "bn3": s3["bn"]}

    def select(self, plan) -> list:
        """Positions in `plan` ([(bucket, indices)] in order) to yield in a
        check or warm epoch."""
        if self.epoch < CHECK_STEPS:
            full = [i for i, (_, idx) in enumerate(plan) if len(set(map(int, idx))) == len(idx)]
            self.check_batches.append(np.asarray(plan[full[self.epoch]][1]))
            return [full[self.epoch]]
        by_bucket: dict = {}
        for i, (bucket, _) in enumerate(plan):
            by_bucket.setdefault(int(bucket), []).append(i)
        out = [pos[0] for pos in by_bucket.values()]
        grouped = [pos for pos in by_bucket.values() if self.k > 1 and len(pos) >= self.k]
        if grouped:  # the K-step dispatch loops the same step: one group warms its path
            out += grouped[0][: self.k]
        return out

    def account(self, batch) -> bool:
        """Record a window batch; False once the deadline has passed."""
        if time.perf_counter() >= self.deadline:
            return False
        lengths = np.asarray(batch.lengths)
        self.steps.append((len(lengths), max(dsp.num_frames(int(n)) for n in lengths)))
        self.audio_s += float(lengths.sum()) / self.sr
        return True


def paced(loader, pacer: Pacer):
    """`loader`, its class swapped for a subclass that the pacer drives."""
    base = type(loader)

    class Paced(base):
        def set_epoch(self, epoch: int) -> None:
            base.set_epoch(self, pacer.on_epoch(epoch))

        def __iter__(self):
            if pacer.epoch >= WINDOW_EPOCH:
                plan = pacer.epoch
                while True:
                    base.set_epoch(self, plan)
                    for b in base.__iter__(self):
                        if not pacer.account(b):
                            return
                        yield b
                    plan += 1
            else:  # metadata only
                batches = list(base.__iter__(self))
                for i in pacer.select([(b.bucket_frames, b.indices) for b in batches]):
                    yield batches[i]

    loader.__class__ = Paced
    return loader


def train_program(cell, seed: int, seconds: float, trace: bool, device, tmp: str, check_only: bool = False):
    """Make the corpus, build the loader and the Trainer from the cell's
    configuration, and drive `Trainer.train` through the checked steps,
    the warm epoch and the window (`check_only`: the checked steps
    alone).  Returns (pacer, corpus, memory peak in bytes)."""
    from fullycnnspeechenhancement_torch.cli.train import build_loaders
    from fullycnnspeechenhancement_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    clean, noise = gen.training_corpus(cell.traffic, cell.config["train_utterances"], seed)
    t1 = time.perf_counter()
    corpus = gen.write_corpus(f"{tmp}/corpus", clean, noise)
    t2 = time.perf_counter()
    config = program_config(cell, seed, tmp, {
        "training": {"epochs": 10**9, "checkpoints_path": f"{tmp}/checkpoints", "log_dir": f"{tmp}/log"},
        "data": {"train_manifest_path": corpus.clean_manifest, "train_noise_manifest": corpus.noise_manifest,
                 "audio_save_path": f"{tmp}/denoise"},
    })
    loader, _ = build_loaders(config, num_workers=4)  # the training CLI's default --num-works
    t3 = time.perf_counter()
    pacer = Pacer(seconds, config.train.steps_per_call, config.dsp.sample_rate, trace, check_only)
    trainer = Trainer(config, device=device)
    pacer.trainer = trainer
    pacer.marks = {"corpus_made": t1 - t0, "corpus_written": t2 - t1, "loader_built": t3 - t2}
    paced(loader, pacer)
    try:
        trainer.train(loader)
    except WindowClosed:
        pass
    finally:
        trainer.ckpt.close()
    peak = memory_peak(device)
    m = pacer.marks
    if f"epoch_{WINDOW_EPOCH}_at" in m:
        print("portbench: set-up " + ", ".join([
            f"corpus made {m['corpus_made']:.2f} s", f"written {m['corpus_written']:.2f} s",
            f"loader built (decode, flats) {m['loader_built']:.2f} s",
            f"trainer to first step {m['epoch_0_at'] - t3:.2f} s",
            f"checked steps {m[f'epoch_{WARM_EPOCH}_at'] - m['epoch_0_at']:.2f} s",
            f"warm epoch {m[f'epoch_{WINDOW_EPOCH}_at'] - m[f'epoch_{WARM_EPOCH}_at']:.2f} s",
        ]), file=sys.stderr)
    pacer.trainer = None
    del trainer, loader
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return pacer, corpus, peak


def run(cell, args, device, t_process: float, tmp: str) -> Outcome:
    ini = cell.config["ini"]
    layers = MODELS[ini["model"]["net_work"]]
    pacer, corpus, peak = train_program(cell, args.seed, args.seconds, args.trace, device, tmp)
    summary = pacer.window.summary() if pacer.window is not None else None
    p0, bn0, ref = check.training_reference(layers, args.seed, ini, corpus, pacer.check_batches, device)
    correct, checks = check.verdict(check.train_numbers(pacer.program(), p0, bn0, ref), cell.limits)
    window_s = pacer.t_end - pacer.t_start
    e2e = {"train_audio_s_per_s": pacer.audio_s / window_s, "setup_s": pacer.t_start - t_process}
    (a0, n0), (a1, n1) = pacer.wait0, pacer.wait1
    readings = Readings(
        layers, ini["model"].get("compute_dtype", "float32"),
        summary.window_s if summary is not None else window_s, summary, pacer.steps, [],
        (a1 - a0, n1 - n0),
    )
    return Outcome(correct and bool(pacer.steps), len(pacer.steps), 0, e2e, readings, checks, peak)
