"""`ops.blocked_dw`'s share of its roofline: the least time the inner
layers' weight gradients of every step in the traced window need
(`work.dw_work`: canonical (1, kw) products over real bins and each
row's batch-max frames, z and dy read once in the compute dtype, dW
written once; against `peaks.py`), over the device time of the kernels
named below in the trace."""

from portbench import peaks, work
from portbench.metrics._share import share

# ops/csrc/blocked_dw.cu: the 3xTF32, bf16 mma.sync and bf16 wgmma
# kernels, and the reduce of their split partial sums
KERNELS = ("dw_mma_kernel", "dw_bf16_kernel", "dw_wgmma_kernel", "dw_reduce_kernel")


def read(r):
    if r.trace is None or not r.steps:
        return None
    elem = 2 if r.precision == "bfloat16" else 4
    need = sum(
        work.roofline_s(f, b, peaks.PEAK_FLOP_S[r.precision], peaks.PEAK_BYTES_S)
        for rows, frames in r.steps
        for f, b in work.dw_work(r.layers, rows, frames, elem)
    )
    return share(need, r.trace.kernel_s(KERNELS))
