"""Train CLI: `python -m fullycnnspeechenhancement_torch.cli.train --cfg <ini>`.

Same surface as the reference's train.py (--cfg, --num-works), wiring
config -> datasets -> loaders -> Trainer; a `val_manifest_path` gives the
Trainer a validation loader.  With `[data] use_device_cache` the training
corpus is decoded once into int16 flats that the Trainer commits to the
device (`data/device_cache.py`); a corpus estimated past
`device_cache_budget_gb` rotates through the device in shards instead.
Runs on the card; `--device cpu` runs on the CPU instead.

Data parallelism (`[training] data_parallel = N > 1`): with FCSE_MULTIHOST=1
(or under torchrun, which sets the same variables) the process joins its
process group first (`parallel/multihost.py`), as the JAX command does.
Without a process group the command starts the N ranks itself, one
process per card (`cuda:0` .. `cuda:N-1`; fewer cards than ranks raise)
or, with `--device cpu`, N CPU processes; each runs this same training.
The process group's backend is nccl on cards and gloo on the CPU; a
backend that fails to start raises.  Every rank reads the whole train
manifest and yields the same global batches, of which the Trainer keeps
the rank's rows, on one node or several.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from fullycnnspeechenhancement_torch.cli import setup_file_logger
from fullycnnspeechenhancement_torch.config import Config, load_ini_config
from fullycnnspeechenhancement_torch.data.dataset import SpeechDataset
from fullycnnspeechenhancement_torch.data.loader import DataLoader
from fullycnnspeechenhancement_torch.parallel import multihost


def build_loaders(config: Config, num_workers: int):
    """(train_loader, val_loader): the train loader (the device cache's
    with `use_device_cache`, else the host loader) and, when one is
    configured, a host loader over the validation manifest (else None).
    Under data parallelism every rank, on every node, reads the whole
    train manifest and yields the same global batches (same seed), of
    which the Trainer keeps the rank's rows: a manifest split by node
    would leave each node's ranks a slice of their node's batches and
    drop the rest."""
    if config.data.use_device_cache:
        train_loader = _device_cache_loader(config)
    else:
        train_ds = SpeechDataset.from_config(config.data, config.dsp, "train")
        train_loader = DataLoader(
            train_ds,
            config.dsp,
            config.train.batch_size,
            bucket_frames=config.data.bucket_frames,
            shuffle=True,
            num_workers=num_workers,
            prefetch=config.data.prefetch_batches,
            seed=config.data.seed,
            int16_transport=config.data.int16_transport,
        )
    val_loader = None
    if config.data.val_manifest_path:
        val_ds = SpeechDataset.from_config(config.data, config.dsp, "val")
        val_loader = DataLoader(
            val_ds,
            config.dsp,
            config.train.batch_size,
            bucket_frames=config.data.bucket_frames,
            shuffle=False,
            num_workers=num_workers,
            seed=config.data.seed,
        )
    return train_loader, val_loader


def _device_cache_loader(config: Config):
    """The resident cache's loader, or the rotating one when the corpus
    (estimated from the manifest's durations) exceeds a positive
    `device_cache_budget_gb` (each data-parallel rank spilling under its
    own `rank<r>` directory).  The corpus is decoded here; the
    Trainer commits it to its device."""
    from fullycnnspeechenhancement_torch.data.device_cache import (
        DeviceCacheLoader,
        RotatingDeviceCacheLoader,
        build_device_corpus,
    )
    from fullycnnspeechenhancement_torch.data.manifest import read_manifest

    data, dsp = config.data, config.dsp
    budget_gb = data.device_cache_budget_gb
    entries, est_bytes = None, 0  # entries are reused by the chosen loader
    if budget_gb > 0:
        entries = read_manifest(data.train_manifest_path, data.min_duration, data.max_duration)
        per = 2 * (2 if entries and entries[0].is_premixed else 1)
        est_bytes = sum(int(e.duration * dsp.sample_rate) * per for e in entries)
    if budget_gb > 0 and est_bytes > budget_gb * (1 << 30):
        spill = data.device_cache_spill_dir or None
        if spill and dist.is_initialized():
            # every rank spills its own copy of the shards
            spill = os.path.join(spill, f"rank{dist.get_rank()}")
        return RotatingDeviceCacheLoader(
            data.train_manifest_path,
            data.train_noise_manifest,
            dsp,
            config.train.batch_size,
            data=data,
            hbm_budget_bytes=int(budget_gb * (1 << 30)),
            bucket_frames=data.bucket_frames,
            shuffle=True,
            seed=data.seed,
            spill_dir=spill,
            entries=entries,
        )
    corpus = build_device_corpus(
        data.train_manifest_path,
        data.train_noise_manifest,
        dsp,
        data,
        max_bucket_frames=max(data.bucket_frames),
        entries=entries,
    )
    return DeviceCacheLoader(
        corpus, dsp, config.train.batch_size, bucket_frames=data.bucket_frames,
        shuffle=True, seed=data.seed,
    )


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a speech denoiser")
    parser.add_argument("--cfg", required=True, help="INI config file")
    parser.add_argument(
        "--num-works", default=4, type=int, help="loader worker threads"
    )
    parser.add_argument(
        "--device", default="cuda", help="torch device to run on (default: cuda)"
    )
    return parser


def _train(args):
    config = load_ini_config(args.cfg)
    logger = setup_file_logger(
        config.train.log_dir,
        f"{config.model.net_arch}_{config.model.net_work}",
    )

    from fullycnnspeechenhancement_torch.train.trainer import Trainer

    train_loader, val_loader = build_loaders(config, args.num_works)
    trainer = Trainer(config, device=args.device)
    try:
        trainer.train(train_loader, val_loader, log=logger)
    finally:
        trainer.ckpt.close()
    return trainer


def _rank_main(rank: int, world: int, init_method: str, argv, devices):
    """Rank `rank` started by `launch_ranks` (a spawned process), on
    `devices[rank]`."""
    device = devices[rank]
    os.environ.update({
        "RANK": str(rank), "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
    })
    args = _parser().parse_args(argv)
    args.device = device
    multihost.initialize_multihost(init_method, world, rank, device=device)
    try:
        _train(args)
    finally:
        dist.destroy_process_group()


def launch_ranks(argv, n: int, device: str) -> None:
    """Start `n` ranks of this command on this node and wait for them all:
    rank r on `cuda:r` (the card's index kept when `device` names one) or,
    for the CPU, a CPU process.  The ranks meet through a file store in a
    fresh temp directory.  A rank that fails raises here, after the others
    are stopped."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(
                f"data_parallel={n} needs {n} CUDA cards, this node has {have}; "
                "pass --device cpu to run the ranks on the CPU"
            )
        devices = [f"cuda:{r}" for r in range(n)]
    else:
        devices = [str(dev)] * n
    with tempfile.TemporaryDirectory(prefix="fcse_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(n, init_method, list(argv), devices), nprocs=n,
            join=False, start_method="spawn",
        )
        while not ctx.join():
            pass


def main(argv=None):
    """Train from an INI file.  Returns the Trainer, or None when this call
    started data-parallel ranks of its own (each rank trained and rank 0
    wrote the checkpoints and logs)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    multihost.maybe_initialize_from_env(device=args.device)
    n_dp = load_ini_config(args.cfg).train.data_parallel
    if n_dp > 1 and not dist.is_initialized():
        launch_ranks(argv, n_dp, args.device)
        return None
    return _train(args)


if __name__ == "__main__":
    main()
