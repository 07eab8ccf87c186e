"""The recipe of tests/test_quality.py (the JAX package's quality test) in
both packages, on the CPU: V2 with blocked compute, batch 8, lr 1.5e-3,
warmup 100, 200 steps on speech-like utterances of 1.6 s at 8 kHz mixed
with white noise at 0 dB (64 distinct training utterances, 8 batches
cycled), then 4 held-out utterances denoised through the eval step in
inference mode and the overlap-add rebuild and scored by STOI and SDR.

`jax_run` is the JAX test's own loop (its generator, step and scoring);
`port_run` is the same recipe on the port's `make_train_step`,
`make_eval_step`, `WaveformRebuilder(mode="overlap_add")` and
`eval/metrics.{sdr,stoi}`.  `tests/test_torch_quality.py` runs both
from JAX's `PRNGKey(0)` state.

Run as a script, it prints the seed spread of the recipe: the port from
its own init (`torch.Generator` seeds) and the JAX test's code from
`PRNGKey` seeds, each a JSON line, then a table:

    JAX_PLATFORMS=cpu python tests/torch_quality_recipe.py --seeds 0 1 2 3

With `production` it runs `benchmarks/quality_run.py`'s recipe (the
Trainer and the device cache) from one start in both packages on the
CPU: the port's `quality.run_quality` and the JAX package's Trainer, from
one package's Trainer init (seed 0) carried to the other by the npz
bridge:

    JAX_PLATFORMS=cpu python tests/torch_quality_recipe.py production --init port

With `init-npz` it writes that start, by default the JAX Trainer's own
init (PRNGKey(0)) to tests/fixtures/quality_v2_init_jax_prngkey0.npz.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if p not in sys.path:
        sys.path.insert(0, p)

STEPS = 200
BATCH = 8
# The JAX Trainer's own init of quality_run.py's V2 (PRNGKey(0)), the
# start of the v5e's quality runs, as chip_smoke.py's phase 23 reads it.
QUALITY_INIT_FIXTURE = "quality_v2_init_jax_prngkey0.npz"


def _configs():
    from fullycnnspeechenhancement_tpu import config as jcfg

    from fullycnnspeechenhancement_torch import config as tcfg

    kw = dict(batch_size=BATCH, lr=1.5e-3, warmup_steps=100)
    return (
        jcfg.Config(model=jcfg.ModelConfig(net_work="FullyCNNV2", blocked_compute=True), train=jcfg.TrainConfig(**kw)),
        tcfg.Config(model=tcfg.ModelConfig(net_work="FullyCNNV2", blocked_compute=True), train=tcfg.TrainConfig(**kw)),
    )


def train_batch(it):
    """Step `it`'s (mix, clean) [8, N] float32: the JAX test's seeds."""
    import test_quality as jq

    seeds = np.arange(BATCH) + BATCH * (it % 8)
    clean = np.stack([jq._speechlike(1000 + s) for s in seeds])
    mix = np.stack([jq._mix0db(c, 2000 + s) for c, s in zip(clean, seeds)])
    return mix, clean


def held_out():
    """The 4 held-out (clean, mix) pairs: seeds never seen in training."""
    import test_quality as jq

    return [(c, jq._mix0db(c, 9500 + s)) for s, c in ((s, jq._speechlike(9000 + s)) for s in range(4))]


def _summary(losses, sdr_mix, sdr_den, stoi_mix, stoi_den, wall):
    return {
        "first_loss": float(losses[0]),
        "last_loss": float(losses[-1]),
        "sdr_mix": float(np.mean(sdr_mix)),
        "sdr": float(np.mean(sdr_den)),
        "stoi_mix": float(np.mean(stoi_mix)),
        "stoi": float(np.mean(stoi_den)),
        "wall_s": wall,
    }


def jax_state(key_seed: int):
    """The JAX test's start: `create_train_state(cfg, V2, PRNGKey(seed))`."""
    import jax

    from fullycnnspeechenhancement_tpu.models import get_model
    from fullycnnspeechenhancement_tpu.train import create_train_state

    jc, _ = _configs()
    return create_train_state(jc, get_model("FullyCNNV2"), jax.random.PRNGKey(key_seed))


def jax_run(key_seed: int = 0, steps: int = STEPS) -> dict:
    """tests/test_quality.py's loop from `PRNGKey(key_seed)`."""
    import jax
    import jax.numpy as jnp

    from fullycnnspeechenhancement_tpu.dsp import WaveformRebuilder
    from fullycnnspeechenhancement_tpu.eval.metrics import sdr, stoi
    from fullycnnspeechenhancement_tpu.models import get_model
    from fullycnnspeechenhancement_tpu.train import make_train_step
    from fullycnnspeechenhancement_tpu.train.step import Batch, make_eval_step
    import test_quality as jq

    t0 = time.perf_counter()
    cfg, _ = _configs()
    model = get_model("FullyCNNV2")
    state = jax_state(key_seed)
    step = jax.jit(make_train_step(cfg, model), donate_argnums=(0,))
    losses = []
    for it in range(steps):
        mix, clean = train_batch(it)
        state, m = step(state, Batch(jnp.asarray(mix), jnp.asarray(clean), jnp.full((BATCH,), jq.N, jnp.int32)))
        losses.append(float(m["loss"]))
    eval_step = jax.jit(make_eval_step(cfg, model, is_training=False))
    reb = WaveformRebuilder(cfg.dsp, mode="overlap_add")
    sm, sd, tm, td = [], [], [], []
    for clean, mix in held_out():
        mag, pre, pim = eval_step(state.params, state.bn_state, jnp.asarray(mix)[None], jnp.full((1,), jq.N, jnp.int32))
        den = np.asarray(reb(mag, pre, pim))[0][: jq.N]
        sm.append(sdr(clean, mix))
        sd.append(sdr(clean, den))
        tm.append(stoi(clean, mix, jq.SR))
        td.append(stoi(clean, den, jq.SR))
    return _summary(losses, sm, sd, tm, td, time.perf_counter() - t0)


def port_state_from_jax(key_seed: int):
    """JAX's `PRNGKey(key_seed)` start carried into the port: params and
    BN state through `ckpt.params_from_numpy`, fresh Adam moments."""
    import jax

    from fullycnnspeechenhancement_torch.train import checkpoint as ckpt
    from fullycnnspeechenhancement_torch.train.step import state_from_tensors

    js = jax_state(key_seed)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return state_from_tensors(*ckpt.params_from_numpy(np_tree(js.params), np_tree(js.bn_state)))


def port_run(state=None, generator_seed: int = 0, steps: int = STEPS) -> dict:
    """The recipe on the port, on the CPU, from `state` or from the port's
    own init drawn from `torch.Generator().manual_seed(generator_seed)`."""
    import torch

    from fullycnnspeechenhancement_torch.dsp import WaveformRebuilder
    from fullycnnspeechenhancement_torch.eval.metrics import sdr, stoi
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.train import step as tstep

    import test_quality as jq

    t0 = time.perf_counter()
    _, cfg = _configs()
    model = get_model("FullyCNNV2")
    if state is None:
        state = tstep.create_train_state(cfg, model, torch.Generator().manual_seed(generator_seed), device="cpu")
    train_step = tstep.make_train_step(cfg, model)
    lengths = torch.full((BATCH,), jq.N, dtype=torch.int32)
    losses = []
    for it in range(steps):
        mix, clean = train_batch(it)
        state, m = train_step(state, tstep.Batch(torch.as_tensor(mix), torch.as_tensor(clean), lengths))
        losses.append(m["loss"].item())
    eval_step = tstep.make_eval_step(cfg, model, is_training=False)
    reb = WaveformRebuilder(cfg.dsp, mode="overlap_add")
    sm, sd, tm, td = [], [], [], []
    for clean, mix in held_out():
        mag, pre, pim = eval_step(state.params, state.bn_state, torch.as_tensor(mix)[None],
                                  torch.full((1,), jq.N, dtype=torch.int32))
        den = reb(mag, pre, pim)[0, : jq.N].numpy()
        sm.append(sdr(clean, mix))
        sd.append(sdr(clean, den))
        tm.append(stoi(clean, mix, jq.SR))
        td.append(stoi(clean, den, jq.SR))
    return _summary(losses, sm, sd, tm, td, time.perf_counter() - t0)


def write_init_npz(package: str, path: str, seed: int = 0) -> str:
    """The Trainer's own init of `benchmarks/quality_run.py`'s V2 as an npz
    of the bridge layout: the JAX package's (`create_train_state` from
    `PRNGKey(seed)`) or the port's (`torch.Generator` seeded `seed`)."""
    if package == "jax":
        import jax

        from fullycnnspeechenhancement_tpu.config import Config, ModelConfig
        from fullycnnspeechenhancement_tpu.models import get_model
        from fullycnnspeechenhancement_tpu.train import create_train_state
        from fullycnnspeechenhancement_tpu.train.checkpoint import export_params_npz

        st = create_train_state(Config(model=ModelConfig(net_work="FullyCNNV2")), get_model("FullyCNNV2"),
                                jax.random.PRNGKey(seed))
        export_params_npz(path, jax.tree.map(np.asarray, st.params), jax.tree.map(np.asarray, st.bn_state))
    else:
        import torch

        from fullycnnspeechenhancement_torch.config import Config, ModelConfig, TrainConfig
        from fullycnnspeechenhancement_torch.models import get_model
        from fullycnnspeechenhancement_torch.train.checkpoint import export_params_npz
        from fullycnnspeechenhancement_torch.train.step import create_train_state

        cfg = Config(model=ModelConfig(net_work="FullyCNNV2"), train=TrainConfig(seed=seed))
        st = create_train_state(cfg, get_model("FullyCNNV2"), device="cpu")
        with torch.no_grad():
            export_params_npz(path, st.params, st.bn_state)
    return path


def jax_production_run(init_npz: str = "", epochs: int = 60, rotating: bool = False,
                       compute_dtype: str = "float32", steps_per_call: int = 1) -> dict:
    """`benchmarks/quality_run.py`'s recipe through the JAX package (its
    Trainer and device cache), from `init_npz` (the bridge layout, the
    Trainer's `base_checkpoint_file`) or the JAX Trainer's own init; the
    port's `quality.held_out_set`, which is quality_run.py's held-out set.
    Scores STOI and SDR (and native PESQ) like `quality.run_quality`.
    quality_run.py dispatches 4 steps at a time, the same steps; on the
    CPU the JAX package's scanned 4-step dispatch takes about 30 s a step,
    so one step a dispatch is the default here."""
    import tempfile

    import jax

    from fullycnnspeechenhancement_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
    from fullycnnspeechenhancement_tpu.data import write_manifest, write_wav
    from fullycnnspeechenhancement_tpu.data.device_cache import (
        DeviceCacheLoader,
        RotatingDeviceCacheLoader,
        build_device_corpus,
    )
    from fullycnnspeechenhancement_tpu.dsp import WaveformRebuilder
    from fullycnnspeechenhancement_tpu.eval.metrics import PESQ, sdr, stoi
    from fullycnnspeechenhancement_tpu.models import get_model
    from fullycnnspeechenhancement_tpu.train.step import make_eval_step
    from fullycnnspeechenhancement_tpu.train.trainer import Trainer

    from fullycnnspeechenhancement_torch import quality

    sr, n, utts = quality.SR, int(quality.SECONDS * quality.SR), 32
    with tempfile.TemporaryDirectory(prefix="jax_quality_") as root:
        entries = []
        for i in range(utts):
            p = os.path.join(root, f"c{i}.wav")
            write_wav(p, quality.speechlike(quality.TRAIN_SEED + i, n, sr), sr)
            entries.append({"audio_filepath": p, "duration": n / sr})
        noise_p = os.path.join(root, "noise.wav")
        rng = np.random.default_rng(quality.NOISE_SEED)
        write_wav(noise_p, (0.25 * rng.standard_normal(10 * sr)).astype(np.float32), sr)
        write_manifest(os.path.join(root, "m.clean"), entries)
        write_manifest(os.path.join(root, "m.noise"), [{"audio_filepath": noise_p, "duration": 10.0}])
        config = Config(
            model=ModelConfig(net_work="FullyCNNV2", compute_dtype=compute_dtype, blocked_compute=True),
            train=TrainConfig(batch_size=8, lr=1.5e-3, warmup_steps=100, steps_per_call=steps_per_call, epochs=epochs,
                              num_iter_print=10**9, checkpoints_path=os.path.join(root, "ckpts"),
                              log_dir=os.path.join(root, "logs"), continue_train=False,
                              max_checkpoints_to_keep=1, base_checkpoint_file=init_npz),
            data=DataConfig(audio_save_path=os.path.join(root, "denoise")),
        )
        if rotating:
            loader = RotatingDeviceCacheLoader(
                os.path.join(root, "m.clean"), os.path.join(root, "m.noise"), config.dsp, batch_size=8,
                hbm_budget_bytes=2 * n * (utts // 2), shuffle=True, seed=0, spill_dir=os.path.join(root, "spill"))
        else:
            corpus = build_device_corpus(os.path.join(root, "m.clean"), os.path.join(root, "m.noise"), config.dsp,
                                         commit=False)
            loader = DeviceCacheLoader(corpus, config.dsp, 8, shuffle=True, seed=0)
        model = get_model("FullyCNNV2")
        eval_step = make_eval_step(config, model, is_training=False)
        reb = WaveformRebuilder(config.dsp, mode="overlap_add")
        pesq = PESQ(sr=sr)
        pairs = quality.held_out_set()

        def score(outputs):
            return {"stoi": float(np.mean([stoi(c, o, sr) for (c, _), o in zip(pairs, outputs)])),
                    "sdr": float(np.mean([sdr(c, o) for (c, _), o in zip(pairs, outputs)])),
                    "pesq_native": float(np.mean([pesq(c, o) for (c, _), o in zip(pairs, outputs)]))}

        def denoise(state):
            outs = []
            for _, mix in pairs:
                pred, pre, pim = eval_step(state.params, state.bn_state, mix[None, :], np.asarray([n], np.int32))
                outs.append(np.asarray(reb(pred, pre, pim))[0][:n])
            return outs

        trainer = Trainer(config)
        untrained = score(denoise(trainer.state))
        t0 = time.perf_counter()
        trainer.train(loader)
        wall = time.perf_counter() - t0
        trained = score(denoise(trainer.state))
        trainer.ckpt.close()
        rows = []
        for name in os.listdir(config.train.log_dir):
            if name.startswith("scalars_"):
                with open(os.path.join(config.train.log_dir, name)) as f:
                    rows += [json.loads(line) for line in f if line.strip()]
        losses = [r["loss"] for r in sorted((r for r in rows if "loss" in r), key=lambda r: r["step"])]
    return {
        "package": "jax", "backend": jax.default_backend(), "loader": "rotating" if rotating else "resident",
        "compute_dtype": compute_dtype, "steps_per_call": steps_per_call,
        "init": init_npz or "the JAX Trainer's own (PRNGKey(0))",
        "steps": int(trainer.state.step), "train_wall_s": wall, "first_loss": losses[0], "last_loss": losses[-1],
        "noisy_mix": score([m for _, m in pairs]), "untrained": untrained, "trained": trained,
    }


def margins(r: dict) -> dict:
    """tests/test_quality.py's three margins."""
    return {
        "loss": r["last_loss"] < 0.75 * r["first_loss"],
        "sdr": r["sdr"] > r["sdr_mix"] + 0.7,
        "stoi": r["stoi"] > r["stoi_mix"] + 0.06,
    }


def production_main(argv) -> int:
    """`production`: quality_run.py's recipe from one start in both
    packages on the CPU, each a JSON line: the port's `quality.run_quality`
    and the JAX package's Trainer (`jax_production_run`)."""
    ap = argparse.ArgumentParser(prog="torch_quality_recipe.py production")
    ap.add_argument("--init", choices=("port", "jax"), default="port",
                    help="the Trainer's own init of this package (seed 0), carried to the other by npz")
    ap.add_argument("--package", choices=("port", "jax", "both"), default="both")
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--rotating", action="store_true")
    a = ap.parse_args(argv)
    import tempfile

    import torch

    from fullycnnspeechenhancement_torch import quality

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    with tempfile.TemporaryDirectory() as tmp:
        npz = write_init_npz(a.init, os.path.join(tmp, f"{a.init}_init.npz"))
        if a.package in ("port", "both"):
            r = quality.run_quality(device="cpu", epochs=a.epochs, loader="rotating" if a.rotating else "resident",
                                    compute_dtype=a.compute_dtype, init_npz=npz, gate=False)
            r.update(package="port", init=f"{a.init} Trainer's own, seed 0")
            print(json.dumps(r), flush=True)
        if a.package in ("jax", "both"):
            r = jax_production_run(npz, a.epochs, a.rotating, a.compute_dtype)
            r.update(init=f"{a.init} Trainer's own, seed 0")
            print(json.dumps(r), flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["production"]:
        return production_main(argv[1:])
    if argv[:1] == ["init-npz"]:
        ap = argparse.ArgumentParser(prog="torch_quality_recipe.py init-npz")
        ap.add_argument("--package", choices=("port", "jax"), default="jax")
        ap.add_argument("--seed", type=int, default=0)
        ap.add_argument("--out", default=os.path.join(ROOT, "tests", "fixtures", QUALITY_INIT_FIXTURE))
        a = ap.parse_args(argv[1:])
        print(write_init_npz(a.package, a.out, a.seed))
        return 0
    ap = argparse.ArgumentParser(description="the seed spread of tests/test_quality.py's recipe in both packages")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--package", choices=("port", "jax", "both"), default="both")
    ap.add_argument("--from-jax-state", action="store_true",
                    help="the port from JAX's PRNGKey(seed) state instead of its own init")
    a = ap.parse_args(argv)
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    rows = []
    for seed in a.seeds:
        runs = []
        if a.package in ("port", "both"):
            if a.from_jax_state:
                runs.append(("port, JAX's PRNGKey state", port_run(state=port_state_from_jax(seed))))
            else:
                runs.append(("port, torch.Generator", port_run(generator_seed=seed)))
        if a.package in ("jax", "both"):
            runs.append(("JAX test's code, PRNGKey", jax_run(seed)))
        for start, r in runs:
            r.update(start=start, seed=seed, margins=margins(r))
            print(json.dumps(r), flush=True)
            rows.append(r)
    print("| Start | Seed | Loss, first -> last | SDR (dB), mix -> trained | STOI, mix -> trained | Margins |")
    print("| --- | --- | --- | --- | --- | --- |")
    for r in rows:
        missed = [k for k, ok in r["margins"].items() if not ok]
        print(f"| {r['start']} | {r['seed']} | {r['first_loss']:.2f} -> {r['last_loss']:.2f} | "
              f"{r['sdr_mix']:.3f} -> {r['sdr']:.3f} | {r['stoi_mix']:.3f} -> {r['stoi']:.3f} | "
              f"{'met' if not missed else 'missed: ' + ', '.join(missed)} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
