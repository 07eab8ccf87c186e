"""The Trainer's dispatch thread's mean wait on its feeder, per dispatch, in
the window: the change of `Trainer.data_time`'s sum over the change of its
count between the window's first and last epoch boundaries."""


def read(r):
    if r.feeder_wait is None or r.feeder_wait[1] <= 0:
        return None
    return 1e3 * r.feeder_wait[0] / r.feeder_wait[1]
