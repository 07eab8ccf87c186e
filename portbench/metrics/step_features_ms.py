"""Device ms an optimizer step under `train.features`: the two STFTs
and the mask."""

from portbench.metrics._span import STEP, device_ms


def read(r):
    return device_ms(r, STEP, ("train.features",))
