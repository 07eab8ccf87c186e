"""Train CLI: `python -m fullycnnspeechenhancement_torch.cli.train --cfg <ini>`.

Same surface as the reference's train.py (--cfg, --num-works), wiring
config -> datasets -> host loaders -> Trainer; a `val_manifest_path`
gives the Trainer a validation loader.  Runs on the card; `--device cpu`
runs on the CPU instead.  The GPU-resident corpus cache
(`use_device_cache`, ROADMAP.md Queue 1 item 8) is not ported yet and
raises.
"""

from __future__ import annotations

import argparse

from fullycnnspeechenhancement_torch.cli import setup_file_logger
from fullycnnspeechenhancement_torch.config import Config, load_ini_config
from fullycnnspeechenhancement_torch.data.dataset import SpeechDataset
from fullycnnspeechenhancement_torch.data.loader import DataLoader


def build_loaders(config: Config, num_workers: int):
    """(train_loader, val_loader): host loaders over the train manifest and,
    when one is configured, the validation manifest (else None)."""
    if config.data.use_device_cache:
        raise NotImplementedError(
            "use_device_cache: the GPU-resident corpus cache is not ported "
            "yet (ROADMAP.md Queue 1 item 8)"
        )
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
