"""aishell_1 (openslr-33) preparation.

Counterpart of `fullycnnspeechenhancement_tpu/data/prepare/aishell_1.py`.

Spec: the reference's `Work/datasets/aishell_1_prepare.py` -- download
data_aishell.tgz, unpack the nested per-speaker tars, resample every wav
under wav/{train,dev,test} to the target rate, write
`<prefix>.{train,dev,test}` manifests.
"""

from __future__ import annotations

import argparse
import os

from fullycnnspeechenhancement_torch.data.manifest import write_manifest
from fullycnnspeechenhancement_torch.data.prepare.common import (
    process_pool,
    download,
    resample_tree_entry,
    unpack,
)

URL_ROOT = "http://www.openslr.org/resources/33"
DATA_URL = URL_ROOT + "/data_aishell.tgz"
MD5_DATA = "f6bf18f56e2315d1fed4ac7eaf911582"


def _walk_wavs(audio_dir):
    for subfolder, _, files in sorted(os.walk(audio_dir)):
        for fname in sorted(files):
            if fname.endswith(".wav"):
                yield os.path.join(subfolder, fname)


def create_manifests(data_dir, manifest_prefix, sample_rate, workers=None):
    os.makedirs(os.path.dirname(manifest_prefix) or ".", exist_ok=True)
    with process_pool(workers) as pool:  # one pool: its workers start once
        for split in ("train", "dev", "test"):
            audio_dir = os.path.join(data_dir, "wav", split)
            paths = list(_walk_wavs(audio_dir))
            entries = list(
                pool.map(
                    _entry_for,
                    paths,
                    [sample_rate] * len(paths),
                    chunksize=64,
                )
            )
            entries = [e for e in entries if e is not None]
            write_manifest(f"{manifest_prefix}.{split}", entries)
            print(f"{split}: {len(entries)} utterances")


def _entry_for(path, sample_rate):
    # rate-tagged sibling tree replaces the 'ASR' token, as the reference
    # does (aishell_1_prepare.py:44-58)
    return resample_tree_entry(path, sample_rate, tag_token="ASR")


def prepare(target_dir, manifest_prefix, sample_rate, workers=None):
    target_dir = os.path.expanduser(target_dir)
    data_dir = os.path.join(target_dir, "data_aishell")
    if not os.path.exists(data_dir):
        filepath = download(DATA_URL, target_dir, md5=None)
        unpack(filepath, target_dir)
        audio_dir = os.path.join(data_dir, "wav")
        for subfolder, _, files in sorted(os.walk(audio_dir)):
            for ftar in files:
                if ftar.endswith((".tar.gz", ".tgz", ".tar")):
                    unpack(os.path.join(subfolder, ftar), subfolder, remove=True)
    else:
        print(f"Data already exists in {target_dir}; skipping download.")
    create_manifests(data_dir, manifest_prefix, sample_rate, workers)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--target-dir", default="~/data/ASR/aishell_1")
    parser.add_argument(
        "--manifest-prefix", default="work/aishell_1/data/manifest.aishell_1"
    )
    parser.add_argument("--sample-rate", default=16000, type=int)
    args = parser.parse_args(argv)
    prepare(args.target_dir, args.manifest_prefix, args.sample_rate)


if __name__ == "__main__":
    main()
