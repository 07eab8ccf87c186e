"""Device ms an optimizer step under `train.forward`: the forward and
the loss."""

from portbench.metrics._span import STEP, device_ms


def read(r):
    return device_ms(r, STEP, ("train.forward",))
