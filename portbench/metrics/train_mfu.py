"""The training step's share of the card's peak: the model FLOPs of
forward and backward (`work.train_flop`, from the frozen layer specs) of
every step in the traced window, each row counted over its batch's
longest utterance's frames as the reference pads it, over the window's
wall time and the peak of the configuration's compute precision
(`peaks.py`)."""

from portbench import peaks, work
from portbench.metrics._share import share


def read(r):
    if r.trace is None or not r.steps:
        return None
    flop = sum(rows * work.train_flop(r.layers, frames) for rows, frames in r.steps)
    return share(flop / peaks.PEAK_FLOP_S[r.precision], r.trace.window_s)
