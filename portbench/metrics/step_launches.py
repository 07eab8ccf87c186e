"""Device operations launched an optimizer step under `train.dispatch`,
which holds the cache's rebuild and the step with its spans."""

from portbench.metrics._span import STEP, launches


def read(r):
    return launches(r, STEP, ("train.dispatch",))
