"""Noise corpus preparation.

Counterpart of `fullycnnspeechenhancement_tpu/data/prepare/noise.py`.

Spec: the reference's `Work/datasets/noise_prepare.py` -- resample every
wav under <target>/{train,dev,test} and write `<prefix>.{split}`
manifests.  (The reference's corpus is private; any directory tree of
noise wavs in that layout works.)
"""

from __future__ import annotations

import argparse
import os

from fullycnnspeechenhancement_torch.data.manifest import write_manifest
from fullycnnspeechenhancement_torch.data.prepare.common import process_pool, resample_tree_entry


def _entry_for(path, sample_rate):
    return resample_tree_entry(path, sample_rate, tag_token="Noise")


def prepare(target_dir, manifest_prefix, sample_rate, workers=None):
    target_dir = os.path.expanduser(target_dir)
    os.makedirs(os.path.dirname(manifest_prefix) or ".", exist_ok=True)
    with process_pool(workers) as pool:  # one pool: its workers start once
        for split in ("train", "dev", "test"):
            audio_dir = os.path.join(target_dir, split)
            paths = []
            for subfolder, _, files in sorted(os.walk(audio_dir)):
                paths += [
                    os.path.join(subfolder, f) for f in sorted(files)
                    if f.endswith(".wav")
                ]
            entries = list(
                pool.map(_entry_for, paths, [sample_rate] * len(paths))
            )
            entries = [e for e in entries if e is not None]
            write_manifest(f"{manifest_prefix}.{split}", entries)
            print(f"{split}: {len(entries)} noise clips")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--target-dir", default="~/data/Noise/_Farfiled_background_")
    parser.add_argument(
        "--manifest-prefix", default="work/noise/manifest.farfiled.background"
    )
    parser.add_argument("--sample-rate", default=16000, type=int)
    args = parser.parse_args(argv)
    prepare(args.target_dir, args.manifest_prefix, args.sample_rate)


if __name__ == "__main__":
    main()
