"""The work a call needs, counted from the frozen layer specs
(`reference/specs.py`) and the shapes alone, whatever implements it.

Products count only pairs whose input is real: along an axis of n
positions, a kernel of k taps with TF SAME padding meets n - |d| real
inputs at tap offset d (the rest fall on the zero padding).  Bytes count
each input read once and each output written once.  So a kernel that
repacks its weights, blocks its bins (`blocked_fb`) or pads its tiles
reads against the same numbers.
"""

from __future__ import annotations

from typing import Iterable

from portbench.reference.specs import F_BINS, in_channels


def real_pairs(k: int, n: int) -> int:
    """(output, tap) pairs with a real input, over n positions."""
    lo = (k - 1) // 2
    return sum(max(0, n - abs(d)) for d in range(-lo, k - lo))


def layer_macs(lay, cin: int, frames: int) -> int:
    """Multiply-adds of one conv layer over one row of `frames` frames."""
    kh, kw = lay.kernel
    return cin * lay.out_ch * real_pairs(kh, frames) * real_pairs(kw, F_BINS)


def forward_flop(layers, frames: int) -> float:
    """FLOP of the model's convs over one row of `frames` frames."""
    return 2.0 * sum(layer_macs(lay, c, frames) for lay, c in zip(layers, in_channels(layers)))


def train_flop(layers, frames: int) -> float:
    """FLOP of one row's forward and backward: the forward, the weight
    gradient of every layer, and the input gradient of every layer but
    the first (the spectrum needs none)."""
    macs = [layer_macs(lay, c, frames) for lay, c in zip(layers, in_channels(layers))]
    return 2.0 * (2 * sum(macs) + sum(macs[1:]))


def inner(layers):
    """(spec, input channels) of the inner (1, k) layers: all but the
    first and the last."""
    return list(zip(layers, in_channels(layers)))[1:-1]


def stack_work(layers, rows_frames: Iterable[int]):
    """(FLOP, bytes) of the inner layers over rows of the given frame
    counts: float32 input of the first inner layer read once, the last
    one's output written once, each weight and bias read once a call."""
    lays = inner(layers)
    c_in, c_out = lays[0][1], lays[-1][0].out_ch
    weights = sum(lay.kernel[1] * c * lay.out_ch + lay.out_ch for lay, c in lays)
    flop = nbytes = 0.0
    for t in rows_frames:
        flop += 2.0 * sum(layer_macs(lay, c, t) for lay, c in lays)
        nbytes += 4.0 * t * F_BINS * (c_in + c_out) + 4.0 * weights
    return flop, nbytes


def dw_work(layers, rows: int, frames: int, elem_bytes: int):
    """[(FLOP, bytes)] of each inner layer's weight gradient over `rows`
    rows of `frames` frames: the canonical (1, kw) products over real
    bins; the layer's input z and its output gradient dy (`elem_bytes` a
    value) read once, dW (float32) written once."""
    out = []
    for lay, c in inner(layers):
        kw = lay.kernel[1]
        flop = 2.0 * rows * frames * c * lay.out_ch * real_pairs(kw, F_BINS)
        nbytes = elem_bytes * rows * frames * F_BINS * (c + lay.out_ch) + 4.0 * kw * c * lay.out_ch
        out.append((flop, nbytes))
    return out


def roofline_s(flop: float, nbytes: float, peak_flop_s: float, peak_bytes_s: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flop / peak_flop_s, nbytes / peak_bytes_s)
