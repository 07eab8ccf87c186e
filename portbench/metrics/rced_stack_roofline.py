"""`ops.rced_stack`'s share of its roofline: the least time the inner
layers of every request in the traced window need (`work.stack_work`:
products over real bins and the request's real frames, float32 input
read once, output written once; against the TF32 peak and HBM's, the
engine serving float32), over the device time of the kernels named
below in the trace."""

from portbench import peaks, work
from portbench.metrics._share import share

# ops/csrc/rced_stack.cu: the 3xTF32 (and conv_layer_bf16) kernel and the
# bf16 wgmma kernel
KERNELS = ("rced_stack_kernel", "rced_stack_wgmma_kernel")


def read(r):
    if r.trace is None or not r.requests:
        return None
    need = sum(
        work.roofline_s(*work.stack_work(r.layers, [frames]), peaks.PEAK_FLOP_S["float32"], peaks.PEAK_BYTES_S)
        for frames in r.requests
    )
    return share(need, r.trace.kernel_s(KERNELS))
