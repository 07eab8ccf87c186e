"""Profiling: `torch.profiler` traces of a window of train steps.

Counterpart of `fullycnnspeechenhancement_tpu/train/profiling.py`.
Enable for a training run with env FCSE_PROFILE_DIR=/path: it traces
steps [FCSE_PROFILE_START, FCSE_PROFILE_START + FCSE_PROFILE_STEPS)
(defaults 10..15, after the warm-up) and writes a Chrome trace there
(host and CUDA activity).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile

logger = logging.getLogger(__name__)


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class StepProfiler:
    """Traces a window of train steps based on FCSE_PROFILE_* env vars."""

    def __init__(self):
        self.dir: Optional[str] = os.environ.get("FCSE_PROFILE_DIR")
        self.start = int(os.environ.get("FCSE_PROFILE_START", "10"))
        self.steps = int(os.environ.get("FCSE_PROFILE_STEPS", "5"))
        self._prof = None
        self._done = False

    def step(self, global_step: int) -> None:
        """Call after each dispatch with the global step count."""
        if self.dir is None or self._done:
            return
        if self._prof is None and global_step >= self.start:
            os.makedirs(self.dir, exist_ok=True)
            self._prof = profile(activities=_activities())
            self._prof.start()
            logger.info("profiler trace started at step %d", global_step)
        elif self._prof is not None and global_step >= self.start + self.steps:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            path = os.path.join(self.dir, "trace.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            self._done = True
            logger.info("profiler trace written to %s", path)
