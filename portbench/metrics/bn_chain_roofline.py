"""`ops.bn_chain`'s share of its roofline: the least time the chains of
every BN layer of every step in the traced window need (in the compute
dtype over the real bins and each step's batch-max frames: the forward
reads the conv output and the skip or residual source once and writes the
output once, the backward reads the output gradient and the conv output
once and writes the conv output's gradient once; against `peaks.py`),
over the device time of the kernels named below in the trace.  A program
without those kernels reads nothing here."""

from portbench import peaks
from portbench.metrics._share import share
from portbench.reference.specs import F_BINS

# ops/csrc/bn_chain.cu: the moments, the output, the gradient's sums, the
# input gradients, and the kernel that adds a reduction's partial sums
KERNELS = (
    "bn_chain_moments_kernel",
    "bn_chain_apply_kernel",
    "bn_chain_grad_sums_kernel",
    "bn_chain_grad_apply_kernel",
    "bn_chain_sum_partials_kernel",
)


def least_bytes(layers, rows: int, frames: int, elem_bytes: int) -> float:
    """The bytes every BN layer's chain moves, forward and backward, over
    `rows` rows of `frames` frames."""
    values = sum(
        lay.out_ch * (2 + (lay.skip_from is not None) + (lay.add_from is not None) + 3)
        for lay in layers
        if lay.use_norm
    )
    return float(rows * frames * F_BINS * elem_bytes * values)


def read(r):
    if r.trace is None or not r.steps:
        return None
    elem = 2 if r.precision == "bfloat16" else 4
    need = sum(least_bytes(r.layers, rows, frames, elem) for rows, frames in r.steps) / peaks.PEAK_BYTES_S
    return share(need, r.trace.kernel_s(KERNELS))
