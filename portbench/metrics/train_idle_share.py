"""The device's idle share of the traced training window: the time in
which no kernel, copy or memset ran, over the window (torch.profiler's
device events; `devtrace`)."""

from portbench.metrics._share import idle_share


def read(r):
    return idle_share(r)
