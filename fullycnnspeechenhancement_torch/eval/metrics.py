"""Running averages for the trainer's logs.

Counterpart of the `AverageMeter` of
`fullycnnspeechenhancement_tpu/eval/metrics.py` (reference utils.py:13-29).
The speech-quality metrics (SDR, STOI, PESQ) are not ported yet
(ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations


class AverageMeter:
    """Running average: the last value, the sum, the count and the mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val
        self.count += n
        self.avg = self.sum / self.count
