"""Evaluation: speech-quality metrics and the batch evaluator
(`eval/evaluator.py`)."""

from fullycnnspeechenhancement_torch.eval.metrics import (  # noqa: F401
    AverageMeter,
    SDR,
    STOI,
    PESQ,
    stoi,
    sdr,
    mos_lqo,
    mos_lqo_inverse,
)
