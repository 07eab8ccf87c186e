"""A guard for the test run's worker processes, and its test.

pytest-xdist drives each worker process over the worker's stdin and stdout
pipes, and a process that a test forks (a process pool's worker) inherits
them.  When the worker process dies while such a child lives on, the child
keeps the pipes open: the controller never sees the worker go and the run
waits until its time limit.  `tests/test_engine.py::
test_evaluator_survives_dead_scoring_worker` can end its own process that
way: once its evaluator has given up on process pools it scores in a thread,
and the planted `os._exit(13)` then runs in the worker itself (always when
the test runs alone; in the full run it depends on timing).

pytest imports every test module in every worker, so importing this one
makes each child that a process forks from its main thread die with that
process (Linux `PR_SET_PDEATHSIG`).  A worker that dies is then reported as
crashed, and its remaining tests run on a replacement.  Children forked
from other threads are left alone: the signal follows the forking thread,
not the process.
"""

import ctypes
import os
import signal
import sys
import threading
import time

import pytest

_PR_SET_PDEATHSIG = 1
_LINUX = sys.platform.startswith("linux")
# resolved here, not after a fork: dlopen in a child of a threaded process
# can wait on a loader lock that another thread held at the fork
_prctl = ctypes.CDLL(None, use_errno=True).prctl if _LINUX else None
_fork = {"main_thread": False, "parent": 0}


def _before_fork():
    _fork["main_thread"] = threading.current_thread() is threading.main_thread()
    _fork["parent"] = os.getpid()


def _after_fork_in_child():
    if not _fork["main_thread"]:
        return
    _prctl(_PR_SET_PDEATHSIG, signal.SIGKILL)
    if os.getppid() != _fork["parent"]:  # the parent died before prctl
        os._exit(1)


if _LINUX:
    os.register_at_fork(before=_before_fork, after_in_child=_after_fork_in_child)


def _gone(pid):
    """True once `pid` has exited (absent, or a zombie nobody reaps)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


@pytest.mark.skipif(not _LINUX, reason="PR_SET_PDEATHSIG is Linux's")
def test_a_child_forked_from_the_main_thread_dies_with_its_parent():
    """A middle process forks a grandchild that would sleep for a minute,
    then exits: the grandchild must go within seconds."""
    r, w = os.pipe()
    middle = os.fork()
    if middle == 0:
        try:
            os.close(r)
            grandchild = os.fork()
            if grandchild == 0:
                os.close(w)
                time.sleep(60)
                os._exit(0)
            os.write(w, str(grandchild).encode())
        finally:
            os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        grandchild = int(f.read())
    os.waitpid(middle, 0)
    deadline = time.monotonic() + 10
    while not _gone(grandchild) and time.monotonic() < deadline:
        time.sleep(0.05)
    alive = not _gone(grandchild)
    if alive:
        os.kill(grandchild, signal.SIGKILL)
    assert not alive, "the grandchild outlived its parent"
