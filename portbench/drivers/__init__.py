"""Drivers: one per kind of window, named by a traffic mix's "driver" key.
Each exposes `run(cell, args, device, t_process, tmp) -> Outcome`."""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

from portbench import spec


class Readings(NamedTuple):
    """What the per-layer readers (`metrics/<name>.py`) read."""

    layers: tuple  # the frozen layer specs (reference/specs.py)
    precision: str  # the timed path's compute precision: "float32" or "bfloat16"
    window_s: float  # the window's length on the host clock
    trace: Optional[object]  # devtrace.Summary of a --trace 1 run, else None
    steps: list  # training: (rows, batch-max frames) of each step in the window
    requests: list  # serving: the real frame count of each request in the window
    feeder_wait: Optional[tuple]  # training: (seconds waited, dispatches) in the window


class Outcome(NamedTuple):
    correct: bool
    attempted: int
    failed: int
    end_to_end: dict  # metric name -> value
    readings: Readings
    checks: dict  # number -> {"value", "limit"}
    memory_peak_bytes: int


def program_config(cell, seed: int, tmp: str, extra: dict):
    """The cell's configuration as the program loads it: its INI sections
    with the run's seed and the `extra` keys (paths under `tmp`), written
    to `tmp` and read by the program's own loader."""
    from fullycnnspeechenhancement_torch.config import load_ini_config

    sections = {s: dict(keys) for s, keys in cell.config["ini"].items()}
    sections.setdefault("training", {})["seed"] = seed
    sections.setdefault("data", {})["seed"] = seed
    for s, keys in extra.items():
        sections.setdefault(s, {}).update(keys)
    return load_ini_config(spec.write_ini(os.path.join(tmp, "run.cfg"), sections))


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
