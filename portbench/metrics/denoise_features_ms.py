"""Device ms a request under `infer.features`: the STFT analysis."""

from portbench.metrics._span import REQUEST, device_ms


def read(r):
    return device_ms(r, REQUEST, ("infer.features",))
