"""Evaluation.  This slice ports only `AverageMeter` (metrics.py)."""

from fullycnnspeechenhancement_torch.eval.metrics import AverageMeter  # noqa: F401
