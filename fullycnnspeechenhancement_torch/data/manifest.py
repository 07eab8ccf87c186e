"""JSONL manifest reading/writing with duration filtering and host sharding.

The port's own copy of `fullycnnspeechenhancement_tpu/data/manifest.py`
(the port imports nothing of the JAX package).

Two schemas, as in the reference (`data_utils/data_loader.py:109-125`):
  * pair-with-noise mode: `{"audio_filepath": ..., "duration": ...}` lines
    in a clean manifest plus a separate noise manifest of the same shape;
  * pre-mixed dict mode: `{"clean_audio_filepath": ..,
    "mix_audio_filepath": .., "duration": ..}` (VoiceBank-DEMAND).

New capability: `shard_for_host` slices a manifest for multi-host input
pipelines (host i takes every k-th item) -- the reference is single-host.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class ManifestEntry:
    duration: float
    audio_filepath: Optional[str] = None
    clean_audio_filepath: Optional[str] = None
    mix_audio_filepath: Optional[str] = None

    @property
    def is_premixed(self) -> bool:
        return self.clean_audio_filepath is not None

    @property
    def clean_path(self) -> str:
        return self.clean_audio_filepath or self.audio_filepath

    @staticmethod
    def from_json(obj: dict) -> "ManifestEntry":
        return ManifestEntry(
            duration=float(obj["duration"]),
            audio_filepath=obj.get("audio_filepath"),
            clean_audio_filepath=obj.get("clean_audio_filepath"),
            mix_audio_filepath=obj.get("mix_audio_filepath"),
        )

    def to_json(self) -> dict:
        out = {"duration": self.duration}
        for k in ("audio_filepath", "clean_audio_filepath", "mix_audio_filepath"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out


def read_manifest(
    path: str,
    min_duration: float = 0.0,
    max_duration: float = float("inf"),
) -> List[ManifestEntry]:
    """Parse a JSONL manifest, keeping min <= duration <= max (the
    reference's filter, data_loader.py:93-107; default train filter is
    >= 0.4 s)."""
    entries = []
    with open(path, "r", encoding="utf-8") as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise IOError(f"{path}:{line_no}: bad manifest line: {e}") from e
            entry = ManifestEntry.from_json(obj)
            if min_duration <= entry.duration <= max_duration:
                entries.append(entry)
    return entries


def write_manifest(path: str, entries) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for e in entries:
            obj = e.to_json() if isinstance(e, ManifestEntry) else e
            f.write(json.dumps(obj) + "\n")


def shard_for_host(
    entries: List[ManifestEntry], host_index: int, host_count: int
) -> List[ManifestEntry]:
    """Deterministic per-host slice: host i takes items i, i+k, i+2k, ..."""
    if not 0 <= host_index < host_count:
        raise ValueError(f"host_index {host_index} not in [0, {host_count})")
    return entries[host_index::host_count]
