"""Device ms a request under `infer.upload` and `infer.download`: the
waveform's copy to the card and the result's copy back."""

from portbench.metrics._span import REQUEST, device_ms


def read(r):
    return device_ms(r, REQUEST, ("infer.upload", "infer.download"))
