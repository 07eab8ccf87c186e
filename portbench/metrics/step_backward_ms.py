"""Device ms an optimizer step under `train.backward`: the gradient,
through autograd's thread."""

from portbench.metrics._span import STEP, device_ms


def read(r):
    return device_ms(r, STEP, ("train.backward",))
