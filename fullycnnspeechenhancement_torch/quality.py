"""Does training learn?  A quality run through the production path.

Counterpart of `benchmarks/quality_run.py`: train V2 through the
`Trainer` from the GPU-resident corpus cache (or the rotating one), then
denoise held-out utterances (unseen speech, unseen noise draws) through
the eval step and the overlap-add rebuild and score STOI, SDR and PESQ
for the noisy mix, the untrained model and the trained model.

    python -m fullycnnspeechenhancement_torch.quality [--epochs 60]
        [--rotating] [--json] [--device cuda|cpu]

The recipe is `quality_run.py`'s: 32 speech-like utterances of 2 s at
8 kHz and a 10 s white-noise file mixed at 0 dB by the cache; V2 with
blocked compute, batch 8, lr 1.5e-3, warmup 100, 4 steps a dispatch; the
resident cache, or the rotating one with a budget of half the corpus (2
shards or more); 4 held-out utterances (speech seeds 10,000+, noise
seeds 20,000+).  `compute_dtype` and `dw_pallas` default to
`quality_run.py`'s settings (bf16, the dW kernel off); the run starts
from the Trainer's own init (`config.train.seed`).

PESQ comes from the native P.862 runtime (`p862-native`) and nothing
else: the run raises if it resolves to another implementation or to the
proxy, or if scoring fails.  `quality_run.py` gates on "trained beats
the mix"; this run holds the three margins of the JAX package's
tests/test_quality.py (`MARGINS`): the last step's loss under 0.75x the
first's, held-out SDR more than 0.7 dB over the mix's and STOI more than
0.06 over it.

With `fused_inference`, scoring runs the inner layers in the float32
stack kernel (`ops/rced_stack.py`, one launch a scoring call) and holds
each held-out prediction against the unfused float32 forward: the result
carries the largest difference over max|unfused| (`fused_max_rel_err`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

SR = 8000
SECONDS = 2.0
BATCH = 8
TRAIN_SEED = 0  # speech seeds 0 .. train_utts - 1
NOISE_SEED = 999
HELD_OUT = 4
HELD_OUT_SPEECH_SEED = 10_000
HELD_OUT_NOISE_SEED = 20_000
# tests/test_quality.py's margins: loss ratio, SDR gain (dB), STOI gain
MARGINS = {"loss_ratio": 0.75, "sdr_gain_db": 0.7, "stoi_gain": 0.06}


def speechlike(seed: int, n: int, sr: int) -> np.ndarray:
    """A speech-like utterance of `n` samples: AR(1) noise under a 2.5-5 Hz
    syllabic envelope (`benchmarks/quality_run.py::speechlike`, bit for
    bit)."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    carrier = lfilter([1.0], [1.0, -0.9], rng.standard_normal(n))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2.5, 5.0) * t + rng.uniform(0, 6))
    return (env * carrier).astype(np.float32) * 0.3


def held_out_set(n: int = int(SECONDS * SR), sr: int = SR):
    """The held-out (clean, mix) pairs: unseen speech at 0 dB in unseen
    white noise."""
    pairs = []
    for k in range(HELD_OUT):
        clean = speechlike(HELD_OUT_SPEECH_SEED + k, n, sr)
        nz = np.random.default_rng(HELD_OUT_NOISE_SEED + k).standard_normal(n)
        nz = nz * np.sqrt((clean**2).sum() / (nz**2).sum())
        pairs.append((clean, (clean + nz).astype(np.float32)))
    return pairs


def write_corpus(root: str, train_utts: int, n: int = int(SECONDS * SR), sr: int = SR):
    """The training corpus under `root`: `train_utts` speech-like wavs and a
    10 s noise wav, with their manifests.  Returns (clean, noise) manifest
    paths."""
    from fullycnnspeechenhancement_torch.data import write_manifest, write_wav

    entries = []
    for i in range(train_utts):
        p = os.path.join(root, f"c{i}.wav")
        write_wav(p, speechlike(TRAIN_SEED + i, n, sr), sr)
        entries.append({"audio_filepath": p, "duration": n / sr})
    noise_p = os.path.join(root, "noise.wav")
    rng = np.random.default_rng(NOISE_SEED)
    write_wav(noise_p, (0.25 * rng.standard_normal(10 * sr)).astype(np.float32), sr)
    clean_m, noise_m = os.path.join(root, "m.clean"), os.path.join(root, "m.noise")
    write_manifest(clean_m, entries)
    write_manifest(noise_m, [{"audio_filepath": noise_p, "duration": 10.0}])
    return clean_m, noise_m


def quality_config(root: str, epochs: int, compute_dtype: str, dw_pallas: bool, fused_inference: bool,
                   init_npz: str = ""):
    from fullycnnspeechenhancement_torch.config import Config, DataConfig, ModelConfig, TrainConfig

    return Config(
        model=ModelConfig(
            net_work="FullyCNNV2",
            compute_dtype=compute_dtype,
            blocked_compute=True,
            dw_pallas=dw_pallas,
            fused_inference=fused_inference,
        ),
        train=TrainConfig(
            batch_size=BATCH,
            lr=1.5e-3,
            warmup_steps=100,
            steps_per_call=4,
            epochs=epochs,
            num_iter_print=10**9,
            checkpoints_path=os.path.join(root, "ckpts"),
            log_dir=os.path.join(root, "logs"),
            continue_train=False,
            max_checkpoints_to_keep=1,
            base_checkpoint_file=init_npz,
        ),
        data=DataConfig(audio_save_path=os.path.join(root, "denoise")),
    )


class Scorer:
    """STOI, SDR and native PESQ of the held-out set, for the mix or for a
    model's denoised output (the eval step in inference mode and the
    overlap-add rebuild)."""

    def __init__(self, config, device: torch.device):
        from fullycnnspeechenhancement_torch.dsp import WaveformRebuilder
        from fullycnnspeechenhancement_torch.eval.metrics import PESQ
        from fullycnnspeechenhancement_torch.models import get_model
        from fullycnnspeechenhancement_torch.train.step import make_eval_step

        self.pesq = PESQ(sr=SR)
        if self.pesq.implementation != "p862-native":
            raise RuntimeError(f"PESQ resolved to {self.pesq.implementation!r}, not the native p862-native runtime")
        model = get_model(config.model.net_work)
        self.fused = config.model.fused_inference
        self.eval_step = make_eval_step(config, model, is_training=False)
        self.ref_step = None
        if self.fused:
            plain = dataclasses.replace(config.model, fused_inference=False, compute_dtype="float32")
            self.ref_step = make_eval_step(dataclasses.replace(config, model=plain), model, is_training=False)
        self.reb = WaveformRebuilder(config.dsp, mode="overlap_add")
        self.device = device
        self.pairs = held_out_set()
        self.fused_max_rel_err = 0.0

    def _scores(self, outputs) -> dict:
        from fullycnnspeechenhancement_torch.eval.metrics import sdr, stoi

        st, sd, pq = [], [], []
        for (clean, _), out in zip(self.pairs, outputs):
            st.append(stoi(clean, out, SR))
            sd.append(sdr(clean, out))
            pq.append(self.pesq(clean, out))
        vals = {"stoi": st, "sdr": sd, "pesq_native": pq}
        if not all(np.isfinite(v).all() for v in vals.values()):
            raise RuntimeError(f"scoring failed: {vals}")
        return {k: float(np.mean(v)) for k, v in vals.items()}

    def mix(self) -> dict:
        return self._scores([m for _, m in self.pairs])

    def model(self, params, bn_state) -> dict:
        outs = []
        for clean, mix in self.pairs:
            n = len(mix)
            wav = torch.as_tensor(mix[None]).to(self.device)
            lengths = torch.as_tensor([n], dtype=torch.int32).to(self.device)
            pred, pre, pim = self.eval_step(params, bn_state, wav, lengths)
            if self.ref_step is not None:
                ref = self.ref_step(params, bn_state, wav, lengths)[0]
                err = float((pred - ref).abs().max() / ref.abs().max().clamp_min(1e-30))
                self.fused_max_rel_err = max(self.fused_max_rel_err, err)
            outs.append(self.reb(pred, pre, pim)[0, :n].cpu().numpy())
        return self._scores(outs)


def logged_losses(log_dir: str) -> list:
    """Every step's loss, in step order, from the Trainer's scalars."""
    rows = []
    for name in sorted(os.listdir(log_dir)):
        if name.startswith("scalars_"):
            with open(os.path.join(log_dir, name)) as f:
                rows += [json.loads(line) for line in f if line.strip()]
    return [r["loss"] for r in sorted((r for r in rows if "loss" in r), key=lambda r: r["step"])]


@contextlib.contextmanager
def _work_dir(root):
    """`root` as given, or a temp dir removed afterwards."""
    if root is not None:
        os.makedirs(root, exist_ok=True)
        yield root
        return
    with tempfile.TemporaryDirectory(prefix="fcse_quality_") as tmp:
        yield tmp


def margins_met(result: dict) -> dict:
    mix, trained = result["noisy_mix"], result["trained"]
    return {
        "loss_ratio": result["last_loss"] < MARGINS["loss_ratio"] * result["first_loss"],
        "sdr_gain_db": trained["sdr"] > mix["sdr"] + MARGINS["sdr_gain_db"],
        "stoi_gain": trained["stoi"] > mix["stoi"] + MARGINS["stoi_gain"],
    }


def run_quality(
    device="cuda",
    epochs: int = 60,
    train_utts: int = 32,
    loader: str = "resident",
    compute_dtype: str = "bfloat16",
    dw_pallas: bool = False,
    fused_inference: bool = False,
    root: Optional[str] = None,
    gate: bool = True,
    init_npz: str = "",
) -> dict:
    """Train and score as the module docstring says; returns the result
    (`quality_run.py`'s keys, `device` in place of `backend`, plus the
    losses, the compute settings and `margins`).  `loader` is "resident"
    or "rotating"; `root` (default a temp dir) holds the corpus, the
    checkpoints and the logs.  With `gate` a missed margin raises.
    `init_npz` (an npz of the bridge layout, as both packages write it)
    replaces the Trainer's own init of the params and BN statistics, so a
    run can start where another package's did."""
    from fullycnnspeechenhancement_torch.data.device_cache import (
        DeviceCacheLoader,
        RotatingDeviceCacheLoader,
        build_device_corpus,
    )
    from fullycnnspeechenhancement_torch.device import resolve_device
    from fullycnnspeechenhancement_torch.train.trainer import Trainer

    if loader not in ("resident", "rotating"):
        raise ValueError(f"loader={loader!r}: 'resident' or 'rotating'")
    dev = resolve_device(device)
    with _work_dir(root) as root:
        n = int(SECONDS * SR)
        clean_m, noise_m = write_corpus(root, train_utts, n)
        config = quality_config(root, epochs, compute_dtype, dw_pallas, fused_inference, init_npz)
        if loader == "rotating":
            # half the corpus a shard: every epoch crosses shard rotations
            data = RotatingDeviceCacheLoader(
                clean_m, noise_m, config.dsp, batch_size=BATCH,
                hbm_budget_bytes=2 * n * (train_utts // 2), shuffle=True, seed=0,
                spill_dir=os.path.join(root, "spill"),
            )
            if data.num_shards < 2:
                raise RuntimeError(f"the rotating cache has {data.num_shards} shard(s), not 2 or more")
        else:
            corpus = build_device_corpus(clean_m, noise_m, config.dsp)
            data = DeviceCacheLoader(corpus, config.dsp, BATCH, shuffle=True, seed=0)

        trainer = Trainer(config, device=dev)
        scorer = Scorer(config, dev)
        untrained = scorer.model(trainer.state.params, trainer.state.bn_state)
        noisy = scorer.mix()
        t0 = time.perf_counter()
        trainer.train(data)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        trained = scorer.model(trainer.state.params, trainer.state.bn_state)
        trainer.ckpt.close()
        losses = logged_losses(config.train.log_dir)

    steps = int(trainer.state.step)
    if len(losses) != steps or not np.isfinite(losses).all():
        raise RuntimeError(f"{len(losses)} logged losses for {steps} steps, or one not finite")
    result = {
        "metric": "quality_run",
        "loader": loader,
        "shards": getattr(data, "num_shards", 1),
        "device": str(dev),
        "compute_dtype": compute_dtype,
        "dw_pallas": dw_pallas,
        "fused_inference": fused_inference,
        "init": init_npz or f"the Trainer's own (seed {config.train.seed})",
        "epochs": epochs,
        "batches_per_epoch": len(data),
        "steps": steps,
        "train_wall_s": wall,
        "first_loss": losses[0],
        "last_loss": losses[-1],
        "pesq": scorer.pesq.implementation,
        "noisy_mix": noisy,
        "untrained": untrained,
        "trained": trained,
    }
    if fused_inference:
        result["fused_max_rel_err"] = scorer.fused_max_rel_err
    result["margins"] = margins_met(result)
    if gate and not all(result["margins"].values()):
        raise AssertionError(f"training missed a margin {MARGINS}: {json.dumps(result)}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--train-utts", type=int, default=32)
    ap.add_argument("--rotating", action="store_true", help="train from the rotating device cache (2+ shards)")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--dw-pallas", action="store_true", help="the dW kernel in the backward")
    ap.add_argument("--fused-inference", action="store_true", help="score through the fused stack kernel")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--init-npz", default="", help="start from this npz's params and BN statistics")
    ap.add_argument("--json", action="store_true", help="print only the JSON line")
    a = ap.parse_args(argv)
    result = run_quality(
        device=a.device, epochs=a.epochs, train_utts=a.train_utts,
        loader="rotating" if a.rotating else "resident", compute_dtype=a.compute_dtype,
        dw_pallas=a.dw_pallas, fused_inference=a.fused_inference, gate=False, init_npz=a.init_npz,
    )
    if not a.json:
        for row in ("noisy_mix", "untrained", "trained"):
            print(f"{row:>10}: " + "  ".join(f"{k} {v:.4f}" for k, v in result[row].items()))
        print(f"loss {result['first_loss']:.2f} -> {result['last_loss']:.2f} over {result['steps']} steps; "
              f"margins {result['margins']}")
    print(json.dumps(result))
    return 0 if all(result["margins"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
