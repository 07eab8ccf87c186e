"""Device ms an optimizer step under `train.materialize`: the batch
rebuilt from the device cache."""

from portbench.metrics._span import STEP, device_ms


def read(r):
    return device_ms(r, STEP, ("train.materialize",))
