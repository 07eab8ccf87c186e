"""Device ms a request under `infer.rebuild`: the waveform's rebuild."""

from portbench.metrics._span import REQUEST, device_ms


def read(r):
    return device_ms(r, REQUEST, ("infer.rebuild",))
