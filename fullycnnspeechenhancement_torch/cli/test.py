"""Test CLI: batch evaluation with PESQ/STOI/SDR and wav triplet dumps
(the reference's test.py/tester.py surface, test.py:13-41).

    python -m fullycnnspeechenhancement_torch.cli.test \\
        --cfg work/aishell_1/cfg/fully_cnn_test.cfg

Runs on the card; `--device cpu` runs on the CPU instead.  Prints
`name=value` for each metric average, sorted by name, and logs the same
line.
"""

from __future__ import annotations

import argparse

from fullycnnspeechenhancement_torch.cli import setup_file_logger
from fullycnnspeechenhancement_torch.config import load_ini_config
from fullycnnspeechenhancement_torch.data.dataset import SpeechDataset
from fullycnnspeechenhancement_torch.data.loader import DataLoader


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a speech denoiser")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--num-works", default=4, type=int)
    parser.add_argument("--checkpoint", default=None, help="override checkpoint (npz or run directory)")
    parser.add_argument(
        "--device", default="cuda", help="torch device to run on (default: cuda)"
    )
    args = parser.parse_args(argv)

    config = load_ini_config(args.cfg)
    logger = setup_file_logger(
        config.train.log_dir or "logs",
        f"test_{config.model.net_arch}_{config.model.net_work}",
    )

    from fullycnnspeechenhancement_torch.eval.evaluator import Evaluator
    from fullycnnspeechenhancement_torch.infer import InferenceEngine

    # The engine resolves the checkpoint (npz, epoch_<N>.pt or a run dir).
    engine = InferenceEngine(config, checkpoint=args.checkpoint, device=args.device)

    test_ds = SpeechDataset.from_config(config.data, config.dsp, "test")
    loader = DataLoader(
        test_ds,
        config.dsp,
        config.eval.batch_size,
        bucket_frames=config.data.bucket_frames,
        shuffle=False,
        num_workers=args.num_works,
        seed=config.data.seed,
    )
    loader.set_epoch(0)

    # Standalone testing runs BN in inference mode (tester.py:67-83).
    evaluator = Evaluator(config, engine.model, bn_training_mode=False, device=args.device)
    logger.info("PESQ implementation: %s", evaluator.pesq.implementation)
    try:
        results = evaluator.evaluate(
            loader, engine.params, engine.bn_state, save_dir=config.data.audio_save_path
        )
    finally:
        evaluator.close()
    msg = ", ".join(f"{k}={v:.4f}" for k, v in sorted(results.items()))
    logger.info("test results: %s", msg)
    print(msg)
    return results


if __name__ == "__main__":
    main()
