"""Train CLI: `python -m fullycnnspeechenhancement_torch.cli.train --cfg <ini>`.

Same surface as the reference's train.py (--cfg, --num-works), wiring
config -> datasets -> loaders -> Trainer; a `val_manifest_path` gives the
Trainer a validation loader.  With `[data] use_device_cache` the training
corpus is decoded once into int16 flats that the Trainer commits to the
device (`data/device_cache.py`); a corpus estimated past
`device_cache_budget_gb` rotates through the device in shards instead.
Runs on the card; `--device cpu` runs on the CPU instead.
"""

from __future__ import annotations

import argparse

from fullycnnspeechenhancement_torch.cli import setup_file_logger
from fullycnnspeechenhancement_torch.config import Config, load_ini_config
from fullycnnspeechenhancement_torch.data.dataset import SpeechDataset
from fullycnnspeechenhancement_torch.data.loader import DataLoader


def build_loaders(config: Config, num_workers: int):
    """(train_loader, val_loader): the train loader (the device cache's
    with `use_device_cache`, else the host loader) and, when one is
    configured, a host loader over the validation manifest (else None).
    The port has one host: the manifests are not sharded."""
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
    `device_cache_budget_gb`.  The corpus is decoded here; the Trainer
    commits it to its device."""
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
            spill_dir=data.device_cache_spill_dir or None,
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


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a speech denoiser")
    parser.add_argument("--cfg", required=True, help="INI config file")
    parser.add_argument(
        "--num-works", default=4, type=int, help="loader worker threads"
    )
    parser.add_argument(
        "--device", default="cuda", help="torch device to run on (default: cuda)"
    )
    args = parser.parse_args(argv)

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


if __name__ == "__main__":
    main()
