"""Small sizes of every cell, for runs on the CPU: the cells' own
configurations and mixes with fewer, shorter utterances and requests."""

import time

import torch

from portbench import run, spec
from portbench.run import ROOT

SHORT_CORPUS = {"utterance_s": {"min": 1.0, "max": 3.5}, "noise_recordings": 2, "noise_s": 8.0}
TINY = {
    "rced16-train-cached": {"config": {"train_utterances": 24, "ini": {"training": {"batch_size": 4}}},
                            "traffic": SHORT_CORPUS},
    "rced16-denoise-long": {"traffic": {"pool": 3, "checked": 1, "request_s": {"min": 3.0, "max": 9.0}}},
}


# a float32 CR-CED training configuration on the training cell's path
FLOAT32_V3 = {"config": {"ini": {"model": {"net_work": "FullyCNNV3", "compute_dtype": "float32"}}}}


def cell(name, extra=None):
    """The small cell, with `extra` merged into its files."""
    return spec.load(ROOT, name, spec._merge(TINY[name], extra))


def execute(name, seed: int = 2**31 + 17, seconds: float = 1.0, trace: int = 0):
    """(outcome, result line) of a run of the small cell on the CPU."""
    c = cell(name)
    args = run.parse(["--workload", name, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)])
    out = run.execute(c, args, torch.device("cpu"), time.perf_counter())
    return out, run.result(c, args, out, {"platform": "cpu"})
