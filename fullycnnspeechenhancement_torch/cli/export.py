"""Export CLI: checkpoint -> npz weights and/or a `torch.export` artefact
(the reference's freeze.py surface, freeze.py:51-55).

    python -m fullycnnspeechenhancement_torch.cli.export --cfg <ini> \\
        [--checkpoint ...] [--npz out.npz] [--torch-export out.pt2]

At least one of --npz and --torch-export.  Runs on the card (the
artefact's constants then live there); `--device cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse

from fullycnnspeechenhancement_torch.config import load_ini_config


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export a trained model")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--npz", default=None, help="output npz path")
    parser.add_argument("--torch-export", default=None, help="output torch.export path (.pt2)")
    parser.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    if not (args.npz or args.torch_export):
        parser.error("need at least one of --npz / --torch-export")

    config = load_ini_config(args.cfg)

    from fullycnnspeechenhancement_torch.export import export_npz, export_torch
    from fullycnnspeechenhancement_torch.infer import InferenceEngine

    engine = InferenceEngine(config, checkpoint=args.checkpoint, device=args.device)
    written = []
    if args.npz:
        written.append(export_npz(args.npz, engine.params, engine.bn_state))
    if args.torch_export:
        written.append(export_torch(config, engine.params, engine.bn_state, args.torch_export))
    for path in written:
        print(path)
    return written


if __name__ == "__main__":
    main()
