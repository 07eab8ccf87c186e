"""Device ms a request under `infer.model`: the fused forward (layer 1,
the stack kernel, the (1, 129) projection)."""

from portbench.metrics._span import REQUEST, device_ms


def read(r):
    return device_ms(r, REQUEST, ("infer.model",))
