"""`ops.proj_train`'s share of its roofline: the least time the final (1,
kw) projection of every step in the traced window needs, forward, dX and
dW (each the products over real taps and each step's batch-max frames; x,
dy and dX read or written once each pass in the compute dtype, y written
once, dW written once in float32; against `peaks.py`), over the device
time of the kernels whose names hold `proj_train_`.  A program without
those kernels reads nothing here."""

from portbench import peaks, work
from portbench.metrics._share import share
from portbench.reference.specs import F_BINS, in_channels

# ops/csrc/proj_train.cu: the forward, dX and dW kernels and the kernel
# that adds dW's partial sums
KERNELS = ("proj_train_",)


def least_work(layers, rows: int, frames: int, elem_bytes: int):
    """(FLOP, bytes) of the projection's forward, dX and dW over `rows` rows
    of `frames` frames."""
    lay, c = layers[-1], in_channels(layers)[-1]
    kw = lay.kernel[1]
    flop = 3 * 2.0 * rows * frames * c * work.real_pairs(kw, F_BINS)
    nbytes = elem_bytes * rows * frames * F_BINS * (3 * c + 3) + 4.0 * kw * c
    return flop, nbytes


def read(r):
    if r.trace is None or not r.steps:
        return None
    elem = 2 if r.precision == "bfloat16" else 4
    need = sum(
        work.roofline_s(*least_work(r.layers, rows, frames, elem), peaks.PEAK_FLOP_S[r.precision],
                        peaks.PEAK_BYTES_S)
        for rows, frames in r.steps
    )
    return share(need, r.trace.kernel_s(KERNELS))
