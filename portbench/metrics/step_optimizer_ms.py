"""Device ms an optimizer step under `train.optimizer`: the schedule and
TF-Adam."""

from portbench.metrics._span import STEP, device_ms


def read(r):
    return device_ms(r, STEP, ("train.optimizer",))
