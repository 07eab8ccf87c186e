"""aishell_2 preparation: local tarball + gender-balanced speaker split.

Counterpart of `fullycnnspeechenhancement_tpu/data/prepare/aishell_2.py`.

Spec: the reference's `Work/datasets/aishell_2_prepare.py` -- unpack a
locally-provided AISHELL-2 iOS tarball, parse `iOS/data/spk_info.txt`
(tab-separated, gender in column 3), sort speakers per gender by numeric
id, take the first 10 of each gender for dev, the next 10 for test, the
rest for train, resample all wavs, and write
`<prefix>.{train,test,dev,all}` manifests.
"""

from __future__ import annotations

import argparse
import os

from fullycnnspeechenhancement_torch.data.manifest import write_manifest
from fullycnnspeechenhancement_torch.data.prepare.common import (
    process_pool,
    resample_tree_entry,
    unpack,
)


def read_speaker_split(spk_info_path):
    """-> (dev_ids, test_ids) per the reference's gender-balanced split."""
    males, females = [], []
    with open(spk_info_path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            cols = line.split("\t")
            spk_id, gender = cols[0].strip(), cols[2].strip()
            (females if gender == "女" else males).append(spk_id)
    females.sort(key=lambda x: int(x[1:]))
    males.sort(key=lambda x: int(x[1:]))
    dev = females[:10] + males[:10]
    test = females[10:20] + males[10:20]
    return set(dev), set(test)


def _entry_for(path, sample_rate):
    return resample_tree_entry(path, sample_rate, tag_token="ASR")


def prepare(target_dir, tarball, manifest_prefix, sample_rate, workers=None):
    target_dir = os.path.expanduser(target_dir)
    data_dir = target_dir
    if not os.path.exists(os.path.join(data_dir, "iOS")):
        if not tarball or not os.path.exists(tarball):
            raise FileNotFoundError(
                "AISHELL-2 is distributed under agreement; provide the local "
                "tarball via --tarball"
            )
        unpack(tarball, data_dir)
    dev_ids, test_ids = read_speaker_split(
        os.path.join(data_dir, "iOS/data/spk_info.txt")
    )
    audio_dir = os.path.join(data_dir, "iOS/data/wav")
    buckets = {"train": [], "dev": [], "test": []}
    with process_pool(workers) as pool:
        for subfolder, _, files in sorted(os.walk(audio_dir)):
            spk_id = os.path.basename(subfolder)
            paths = [
                os.path.join(subfolder, f) for f in sorted(files)
                if f.endswith(".wav")
            ]
            if not paths:
                continue
            entries = [
                e
                for e in pool.map(_entry_for, paths, [sample_rate] * len(paths))
                if e is not None
            ]
            split = (
                "dev" if spk_id in dev_ids
                else "test" if spk_id in test_ids
                else "train"
            )
            buckets[split].extend(entries)
    os.makedirs(os.path.dirname(manifest_prefix) or ".", exist_ok=True)
    for split in ("train", "test", "dev"):
        write_manifest(f"{manifest_prefix}.{split}", buckets[split])
        print(f"{split}: {len(buckets[split])} utterances")
    write_manifest(
        f"{manifest_prefix}.all",
        buckets["dev"] + buckets["test"] + buckets["train"],
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--target-dir", default="~/data/ASR/aishell_2")
    parser.add_argument("--tarball", default=None)
    parser.add_argument(
        "--manifest-prefix", default="work/aishell_2/data/manifest.aishell_2"
    )
    parser.add_argument("--sample-rate", default=16000, type=int)
    args = parser.parse_args(argv)
    prepare(args.target_dir, args.tarball, args.manifest_prefix, args.sample_rate)


if __name__ == "__main__":
    main()
