"""The requests' share of the card's peak: the forward FLOPs of the model
(`work.forward_flop`, from the frozen layer specs) over each request's
real frames, for every request in the traced window, over the window's
wall time and the TF32 peak (the engine serves float32; `peaks.py`)."""

from portbench import peaks, work
from portbench.metrics._share import share


def read(r):
    if r.trace is None or not r.requests:
        return None
    flop = sum(work.forward_flop(r.layers, frames) for frames in r.requests)
    return share(flop / peaks.PEAK_FLOP_S["float32"], r.trace.window_s)
