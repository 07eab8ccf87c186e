"""VoiceBank-DEMAND preparation: pre-mixed clean/noisy pairs.

Counterpart of `fullycnnspeechenhancement_tpu/data/prepare/voicebank.py`.

Spec: the reference's `Work/datasets/voicebank.py` -- download the four
Edinburgh DataShare zips (28spk clean/noisy train + clean/noisy test),
unpack each under dataset/<first_two_tokens>/, resample clean+noisy pairs
together, and write dict manifests `<prefix>.{trainset,testset}` with
`clean_audio_filepath` / `mix_audio_filepath` / `duration` per line.
"""

from __future__ import annotations

import argparse
import os

from fullycnnspeechenhancement_torch.data.audio_io import read_wav, resample, write_wav
from fullycnnspeechenhancement_torch.data.manifest import write_manifest
from fullycnnspeechenhancement_torch.data.prepare.common import (
    process_pool,
    MIN_CLIP_SAMPLES,
    download,
    unpack,
)

URLS = [
    "https://datashare.is.ed.ac.uk/bitstream/handle/10283/2791/clean_trainset_28spk_wav.zip",
    "https://datashare.is.ed.ac.uk/bitstream/handle/10283/2791/noisy_trainset_28spk_wav.zip",
    "https://datashare.is.ed.ac.uk/bitstream/handle/10283/2791/clean_testset_wav.zip",
    "https://datashare.is.ed.ac.uk/bitstream/handle/10283/2791/noisy_testset_wav.zip",
]


def _pair_entry(clean_path, sample_rate):
    mix_path = clean_path.replace("clean", "noisy")
    clean, sr_c = read_wav(clean_path)
    mix, sr_m = read_wav(mix_path)
    if len(clean) < MIN_CLIP_SAMPLES:
        return None
    if sr_c != sample_rate or sr_m != sample_rate:
        clean = resample(clean, sr_c, sample_rate)
        mix = resample(mix, sr_m, sample_rate)
        tag = {8000: "8K", 16000: "16K", 32000: "32K"}.get(
            sample_rate, f"{sample_rate}Hz"
        )
        clean_path = clean_path.replace("SE", f"{tag}SE")
        mix_path = clean_path.replace("clean", "noisy")
        os.makedirs(os.path.dirname(clean_path), exist_ok=True)
        os.makedirs(os.path.dirname(mix_path), exist_ok=True)
        write_wav(clean_path, clean, sample_rate)
        write_wav(mix_path, mix, sample_rate)
    return {
        "clean_audio_filepath": clean_path,
        "mix_audio_filepath": mix_path,
        "duration": float(len(clean) / sample_rate),
    }


def create_manifests(data_dir, manifest_prefix, sample_rate, workers=None):
    os.makedirs(os.path.dirname(manifest_prefix) or ".", exist_ok=True)
    with process_pool(workers) as pool:  # one pool: its workers start once
        for data_set in ("clean_trainset", "clean_testset"):
            audio_dir = os.path.join(data_dir, data_set)
            paths = []
            for subfolder, _, files in sorted(os.walk(audio_dir)):
                paths += [
                    os.path.join(subfolder, f) for f in sorted(files)
                    if f.endswith(".wav")
                ]
            entries = [
                e
                for e in pool.map(
                    _pair_entry, paths, [sample_rate] * len(paths), chunksize=32
                )
                if e is not None
            ]
            split = data_set.split("_")[-1]  # trainset / testset
            write_manifest(f"{manifest_prefix}.{split}", entries)
            print(f"{split}: {len(entries)} pairs")


def prepare(target_dir, manifest_prefix, sample_rate, workers=None):
    target_dir = os.path.expanduser(target_dir)
    data_dir = os.path.join(target_dir, "dataset")
    if not os.path.exists(data_dir):
        for url in URLS:
            fname = url.split("/")[-1]
            sub = os.path.join(data_dir, "_".join(fname.split("_")[:2]))
            filepath = download(url, target_dir)
            unpack(filepath, sub)
    else:
        print(f"Data already exists in {target_dir}; skipping download.")
    create_manifests(data_dir, manifest_prefix, sample_rate, workers)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--target-dir", default="~/data/SE/voicebank")
    parser.add_argument(
        "--manifest-prefix", default="work/voicebank/data/manifest.voicebank"
    )
    parser.add_argument("--sample-rate", default=16000, type=int)
    args = parser.parse_args(argv)
    prepare(args.target_dir, args.manifest_prefix, args.sample_rate)


if __name__ == "__main__":
    main()
