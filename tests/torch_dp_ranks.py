"""Rank processes for the port's data-parallel tests.

`spawn` starts real `gloo` ranks on the CPU: spawned processes that meet
through a file store in the test's temp directory and run a function of
this module.  Every join has a deadline, and `FCSE_DIST_TIMEOUT_S` bounds
the rendezvous and each collective in the ranks, so a hung group fails
its test instead of stalling the run.  This module imports only the port
(never JAX), so the ranks do not either; the tests compute their JAX
references in the parent.
"""

import os
import time

import numpy as np
import torch

RANK_TIMEOUT_S = 60.0


def spawn(fn, world, tmp_dir, args=(), timeout=RANK_TIMEOUT_S, join_group=True):
    """Run `fn(rank, world, *args)` in `world` gloo ranks (with
    `join_group` False, in `world` processes that join no group before
    `fn` runs); raise what a rank raised, or TimeoutError after `timeout`
    seconds (the ranks are killed either way before this returns)."""
    import torch.multiprocessing as mp

    init = "file://" + os.path.join(str(tmp_dir), f"store_{time.monotonic_ns()}") if join_group else None
    ctx = mp.start_processes(
        _rank, args=(world, init, timeout, fn, args), nprocs=world, join=False,
        start_method="spawn",
    )
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def _rank(rank, world, init, timeout, fn, args):
    import torch.distributed as dist

    from fullycnnspeechenhancement_torch.parallel import multihost

    torch.set_num_threads(1)
    if init is not None:
        multihost.initialize_multihost(init, world, rank, backend="gloo", device="cpu", timeout_s=timeout)
    try:
        fn(rank, world, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def port_leaves(tree):
    """{(layer, leaf): float64 array} in the JAX layout (OIHW -> HWIO)."""
    out = {}
    for name, p in tree.items():
        for k, v in p.items():
            v = v.detach().cpu()
            out[(name, k)] = (v.permute(2, 3, 1, 0) if k == "w" else v).numpy().astype(np.float64)
    return out


def run_step_case(dp, case, device="cpu"):
    """One case of `STEP_CASES` (tests/test_torch_dp.py) through the port
    on `device`: the DP step of `dp`'s rank, or with `dp` None the
    single-process step on the whole batch.  Returns the metrics and the
    state as numpy."""
    from fullycnnspeechenhancement_torch import config as tcfg
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.parallel import dp as pdp
    from fullycnnspeechenhancement_torch.train import checkpoint as ckpt
    from fullycnnspeechenhancement_torch.train import step

    cfg = tcfg.Config(model=tcfg.ModelConfig(**case["model"]), train=tcfg.TrainConfig(**case["train"]))
    model = get_model(case["net"])
    params, bn = case["params"], case["bn"]
    zeros = {n: {k: np.zeros_like(v) for k, v in p.items()} for n, p in params.items()}
    state = ckpt.train_state_from_numpy(params, bn, zeros, zeros, 0, device=device)
    waves = [step.Batch(*(torch.as_tensor(a, device=device) for a in w)) for w in case["batches"]]
    k = len(waves)
    if k > 1:
        batch = step.Batch(*(None if f[0] is None else torch.stack(f) for f in zip(*waves)))
    else:
        batch = waves[0]
    # the steps as the Trainer builds them: the DP step, K of them in one call
    fn = step.make_train_step(cfg, model, dp=dp)
    fn = step.make_multi_step(fn) if k > 1 else fn
    if dp is not None:
        pdp.replicate(state, dp)
        batch = (pdp.shard_stacked_batch if k > 1 else pdp.shard_batch)(dp, batch)
    state, out = fn(state, batch)
    losses = out[:, 0] if k > 1 else out["loss"][None]
    return {
        "loss": losses.cpu().numpy().astype(np.float64),
        "params": port_leaves(state.params),
        "bn": {(n, s): v.cpu().numpy().astype(np.float64) for n, d in state.bn_state.items() for s, v in d.items()},
        "mu": port_leaves(state.opt_state.mu),
        "step": int(state.step),
    }


def run_grad_case(dp, case):
    """The loss gradient of one `GRAD_CASES` case in float64: this rank's
    rows through the model with its BN moments summed over the ranks, the
    loss's mask mean global, the gradients and the loss summed over the
    ranks (what the DP train step does between its forward and its
    update)."""
    import functools

    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.models.blocked import apply_blocked
    from fullycnnspeechenhancement_torch.train import checkpoint as ckpt
    from fullycnnspeechenhancement_torch.train import step

    model = get_model(case["net"])
    tp, tbn = ckpt.params_from_numpy(case["params"], case["bn"])
    tp = {n: {k: v.double().requires_grad_() for k, v in d.items()} for n, d in tp.items()}
    tbn = {n: {k: v.double() for k, v in d.items()} for n, d in tbn.items()}
    forward = functools.partial(apply_blocked, model, fb=8, dw_pallas=True) if case["blocked"] else model.apply
    x, tgt, mask = (torch.as_tensor(case[k]) for k in ("x", "tgt", "mask"))
    rows = dp.rows(x.shape[0])
    x, tgt = x[rows], tgt[rows]
    if mask.shape[0] > 1:  # a [B, T] mask is per utterance; [1, T] is shared
        mask = mask[rows]
    y, _ = forward(tp, tbn, x, is_training=True, frame_mask=mask, reduce=dp.sum)
    loss = step.spectral_l2_loss(y, tgt, case["batch_size"], mask, normalize_mask=case["mask_loss"],
                                 reduce=dp.sum)
    names = [(n, k) for n in sorted(tp) for k in sorted(tp[n])]
    grads = torch.autograd.grad(loss, [tp[n][k] for n, k in names])
    *grads, loss = dp.sum_flat(list(grads) + [loss])
    g = {}
    for (n, k), v in zip(names, grads):
        g.setdefault(n, {})[k] = v
    return {"loss": loss.item(), "grads": port_leaves(g)}


def dp_cases(rank, world, step_cases, grad_cases, out_dir):
    """Every case of tests/test_torch_dp.py in one group; each rank saves
    its results to `out_dir/rank<r>.pt`."""
    from fullycnnspeechenhancement_torch.parallel.dp import DataParallel

    dp = DataParallel.current(world)
    results = {("step", name): run_step_case(dp, c) for name, c in step_cases.items()}
    results.update({("grad", name): run_grad_case(dp, c) for name, c in grad_cases.items()})
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def env_ranks(rank, world, port, local_world, out_dir):
    """A rank that joins its group only through FCSE_MULTIHOST=1 and the
    torchrun variables, as `cli.train` does under torchrun; saves what it
    saw."""
    import torch.distributed as dist

    from fullycnnspeechenhancement_torch.parallel import multihost

    os.environ.update({
        "FCSE_MULTIHOST": "1", "RANK": str(rank), "WORLD_SIZE": str(world),
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
        "LOCAL_WORLD_SIZE": str(local_world), "LOCAL_RANK": str(rank % local_world),
        "FCSE_DIST_TIMEOUT_S": str(RANK_TIMEOUT_S),
    })
    multihost.maybe_initialize_from_env(device="cpu")
    multihost.initialize_multihost(device="cpu")  # idempotent
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    seen = {
        "backend": dist.get_backend(), "rank": dist.get_rank(), "world": dist.get_world_size(),
        "host_index": multihost.host_index(), "host_count": multihost.host_count(),
        "local_rank": multihost.local_rank(), "local_batch": multihost.local_batch_size(8),
        "sum": float(x),
    }
    torch.save(seen, os.path.join(out_dir, f"rank{rank}.pt"))


def epoch_rows(rank, world, ini, out_dir):
    """A rank on a node of its own (LOCAL_WORLD_SIZE=1: `world` hosts):
    the dataset indices of its rows of `cli.train`'s train loader over
    one epoch, saved with its host index and count."""
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    from fullycnnspeechenhancement_torch.cli import train as train_cli
    from fullycnnspeechenhancement_torch.config import load_ini_config
    from fullycnnspeechenhancement_torch.parallel import multihost
    from fullycnnspeechenhancement_torch.parallel.dp import DataParallel

    config = load_ini_config(ini)
    dp = DataParallel.current(config.train.data_parallel)
    loader = train_cli.build_loaders(config, 1)[0]
    loader.set_epoch(0)
    rows = [np.asarray(b.indices)[dp.rows(len(b.indices))] for b in loader]
    seen = {"hosts": (multihost.host_index(), multihost.host_count()),
            "indices": np.concatenate(rows).tolist()}
    torch.save(seen, os.path.join(out_dir, f"rank{rank}.pt"))


def cached_state_dict(state):
    return {
        "params": port_leaves(state.params),
        "bn": {(n, s): v.cpu().numpy().astype(np.float64) for n, d in state.bn_state.items() for s, v in d.items()},
        "mu": port_leaves(state.opt_state.mu),
        "nu": port_leaves(state.opt_state.nu),
        "step": int(state.step),
    }


def run_cached_case(dp, corpus, params, bn, k):
    """K cached steps (the DP cached step of `dp`'s rank, or with `dp`
    None the single-process one) over the first K batches of a resident
    cache of `corpus` (4 utterances a batch, FullyCNN)."""
    from fullycnnspeechenhancement_torch import config as tcfg
    from fullycnnspeechenhancement_torch.data import device_cache as T
    from fullycnnspeechenhancement_torch.models import get_model
    from fullycnnspeechenhancement_torch.parallel import dp as pdp
    from fullycnnspeechenhancement_torch.train import checkpoint as ckpt
    from fullycnnspeechenhancement_torch.train import step
    from fullycnnspeechenhancement_torch.train.cached_step import (
        Meta,
        make_cached_multi_step,
        make_cached_train_step,
    )

    dsp = tcfg.DSPConfig()
    cfg = tcfg.Config(model=tcfg.ModelConfig(net_work="FullyCNN"),
                      train=tcfg.TrainConfig(batch_size=4, lr=1e-3, warmup_steps=100))
    corpus_ = T.build_device_corpus(corpus["clean"], corpus["noise"], dsp).commit("cpu")
    loader = T.DeviceCacheLoader(corpus_, dsp, 4, shuffle=False, seed=0)
    batches = list(loader)[:k]
    samples = loader.pad_len(batches[0].bucket_frames)
    zeros = {n: {kk: np.zeros_like(v) for kk, v in p.items()} for n, p in params.items()}
    state = ckpt.train_state_from_numpy(params, bn, zeros, zeros, 0)
    meta = Meta.from_batch(batches[0], "cpu") if k == 1 else Meta.stack(batches, "cpu")
    # the cached steps over the (DP) train step, as the Trainer builds them
    maker = make_cached_train_step if k == 1 else make_cached_multi_step
    fn = maker(step.make_train_step(cfg, get_model("FullyCNN"), dp=dp), samples, corpus_.premixed)
    if dp is not None:
        pdp.replicate(state, dp)
        meta = (pdp.shard_batch if k == 1 else pdp.shard_stacked_batch)(dp, meta)
    state, out = fn(state, corpus_.clean, corpus_.other, meta)
    losses = out[:, 0] if k > 1 else out["loss"][None]
    return dict(cached_state_dict(state), loss=losses.numpy().astype(np.float64))


def dp_cached_cases(rank, world, corpus, params, bn, config, budget, out_dir):
    """Every case of tests/test_torch_dp_cached.py in one group: the cached
    DP step for K = 1 and 2, then the rotating-cache DP Trainer."""
    from fullycnnspeechenhancement_torch.parallel.dp import DataParallel

    dp = DataParallel.current(world)
    results = {k: run_cached_case(dp, corpus, params, bn, k) for k in (1, 2)}
    torch.save(results, os.path.join(out_dir, f"cached_rank{rank}.pt"))
    rotating_trainer(rank, config, corpus, budget, out_dir)


def rotating_trainer(rank, config, corpus, budget, out_dir):
    """A DP Trainer (config's data_parallel = the group's size) over a
    rotating cache, two epochs; each rank spills to its own directory and
    saves its final state and its loader's commit count."""
    from fullycnnspeechenhancement_torch.data import device_cache as T
    from fullycnnspeechenhancement_torch.train.trainer import Trainer

    rot = T.RotatingDeviceCacheLoader(
        corpus["clean"], corpus["noise"], config.dsp, config.train.batch_size,
        hbm_budget_bytes=budget, shuffle=True, seed=0,
        spill_dir=os.path.join(out_dir, f"spill_rank{rank}"),
    )
    trainer = Trainer(config, device="cpu")
    trainer.train(rot, epochs=2)
    trainer.ckpt.close()
    saved = dict(cached_state_dict(trainer.state), generation=rot.generation,
                 num_shards=rot.num_shards, batches=len(rot), host_step=trainer._host_step)
    torch.save(saved, os.path.join(out_dir, f"rank{rank}.pt"))


def dp_step_on_device(rank, world, case, device, out_dir):
    """One DP step case on `device` (both ranks may share one card under
    gloo); saves the state and the rank's `blocked_dw` launches."""
    from fullycnnspeechenhancement_torch.device import disable_tf32
    from fullycnnspeechenhancement_torch.ops import blocked_dw
    from fullycnnspeechenhancement_torch.parallel.dp import DataParallel

    disable_tf32()
    dp = DataParallel.current(world)
    blocked_dw.launches = blocked_dw.launches_bf16 = 0
    out = run_step_case(dp, case, device)
    out["launches"] = blocked_dw.launches + blocked_dw.launches_bf16
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
