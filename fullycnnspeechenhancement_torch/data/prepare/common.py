"""Shared dataset-prep helpers: download, unpack, checksum, resample.

Counterpart of `fullycnnspeechenhancement_tpu/data/prepare/common.py`.

Behavioural spec from the reference's `data_utils/utils.py:6-38` (download
via wget / unpack tar+zip / md5) and the `load_and_resample` pattern
repeated across `Work/datasets/*_prepare.py`: read a wav, drop clips under
100 samples, resample to the target rate writing the result beside the
original under a rate-tagged directory, and emit a manifest JSON object.
stdlib/scipy only -- no wget, soundfile or resampy dependency.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import tarfile
import urllib.request
import zipfile
from concurrent.futures import ProcessPoolExecutor
from typing import Optional

from fullycnnspeechenhancement_torch.data.audio_io import read_wav, write_wav

MIN_CLIP_SAMPLES = 100  # reference drops clips shorter than this


def process_pool(workers: Optional[int] = None) -> ProcessPoolExecutor:
    """The prepare scripts' worker pool.  Its workers are spawned, not forked:
    the caller may hold threads (a CUDA context, a loader), and a forked
    child would inherit their locks."""
    return ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))


def md5file(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, target_dir: str, md5: Optional[str] = None) -> str:
    """Download `url` into target_dir (skip if present); verify md5 if
    given.  Uses urllib with resumable-ish retry semantics rather than
    shelling out to wget."""
    os.makedirs(target_dir, exist_ok=True)
    filepath = os.path.join(target_dir, url.split("/")[-1])
    if os.path.exists(filepath):
        print(f"File exists, skip downloading. ({filepath})")
    else:
        print(f"Downloading {url} ...")
        tmp = filepath + ".part"
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, filepath)
    if md5 is not None:
        got = md5file(filepath)
        if got != md5:
            raise IOError(f"md5 mismatch for {filepath}: {got} != {md5}")
    return filepath


def unpack(filepath: str, target_dir: str, remove: bool = False) -> None:
    """Unpack .tar/.tgz/.tar.gz/.zip into target_dir."""
    print(f"Unpacking {filepath} ...")
    os.makedirs(target_dir, exist_ok=True)
    if filepath.endswith((".tar", ".tgz", ".tar.gz")):
        with tarfile.open(filepath) as tar:
            tar.extractall(target_dir)
    elif filepath.endswith(".zip"):
        with zipfile.ZipFile(filepath) as zf:
            zf.extractall(target_dir)
    else:
        raise ValueError(f"don't know how to unpack {filepath}")
    if remove:
        os.remove(filepath)


def _rate_tag(sample_rate: int) -> str:
    return {8000: "8K", 16000: "16K", 32000: "32K"}.get(
        sample_rate, f"{sample_rate}Hz"
    )


def resample_tree_entry(
    audio_path: str,
    sample_rate: int,
    tag_token: str,
) -> Optional[dict]:
    """Resample one wav to `sample_rate` if needed, writing the result under
    a rate-tagged sibling tree (the reference replaces the path token
    `tag_token` with e.g. '8K'+token); returns the manifest dict or None
    for clips under MIN_CLIP_SAMPLES."""
    data, sr = read_wav(audio_path)
    if len(data) < MIN_CLIP_SAMPLES:
        return None
    out_path = audio_path
    if sr != sample_rate:
        from fullycnnspeechenhancement_torch.data.audio_io import resample

        data = resample(data, sr, sample_rate)
        out_path = audio_path.replace(
            tag_token, f"{_rate_tag(sample_rate)}{tag_token}"
        )
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        write_wav(out_path, data, sample_rate)
    return {
        "audio_filepath": out_path,
        "duration": float(len(data) / sample_rate),
    }
