"""Inference CLI: denoise one wav file (reference infer.py:80-89).

    python -m fullycnnspeechenhancement_torch.cli.infer \\
        --cfg work/aishell_1/cfg/fully_cnn_infer.cfg --audio-file noisy.wav

Runs on the card; `--device cpu` runs on the CPU instead.  `--time-shard N`
shards utterances past the top bucket over N devices (`parallel/halo.py`):
the first N CUDA cards (fewer raise), or with `--device cpu` N shards on
the CPU.
"""

from __future__ import annotations

import argparse

from fullycnnspeechenhancement_torch.config import load_ini_config


def main(argv=None):
    parser = argparse.ArgumentParser(description="Denoise a wav file")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--audio-file", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument(
        "--device", default="cuda", help="torch device to run on (default: cuda)"
    )
    parser.add_argument(
        "--time-shard",
        type=int,
        default=0,
        metavar="N",
        help="shard over-top-bucket utterances' time axis across N devices "
        "with a halo exchange (parallel/halo.py); needs >= N CUDA cards "
        "(or --device cpu)",
    )
    args = parser.parse_args(argv)

    config = load_ini_config(args.cfg)

    from fullycnnspeechenhancement_torch.infer import InferenceEngine

    mesh = None
    if args.time_shard > 1:
        import torch

        from fullycnnspeechenhancement_torch.parallel import make_mesh

        cpu = torch.device(args.device).type == "cpu"
        mesh = make_mesh(n_data=args.time_shard, devices=[args.device] * args.time_shard if cpu else None)
    engine = InferenceEngine(config, checkpoint=args.checkpoint, device=args.device, mesh=mesh)
    out = engine.denoise(args.audio_file)
    print(out)


if __name__ == "__main__":
    main()
