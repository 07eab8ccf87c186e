"""Device operations launched a request under `infer.request`, which
holds every other `infer.*` span."""

from portbench.metrics._span import REQUEST, launches


def read(r):
    return launches(r, REQUEST, ("infer.request",))
