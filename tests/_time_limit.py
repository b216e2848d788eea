"""A time limit for every test that has a `timeout(seconds)` marker,
without a plugin package. The limit covers setup and call, so a module
fixture's cost counts against the first test that uses it.

Two stops, both cancelled after each test:
- the soft stop, a SIGALRM handler, dumps every thread's stack and fails
  the test with its node id;
- the hard stop, `faulthandler.dump_traceback_later(limit +
  HARD_STOP_AFTER_S, exit=True)`, catches code that never returns to Python
  (an XLA compile, a gloo wait): it dumps every thread's stack and ends the
  process, which xdist reports as that test failing before it starts a new
  worker.

The repo's root conftest.py loads it and gives every test under tests/ a
marker (300 s, unless the test has its own); another run takes it with
`-p _time_limit` when tests/ is on its path.
"""
import contextlib
import faulthandler
import os
import signal
import threading
import time

import pytest

HARD_STOP_AFTER_S = 60

_limit = pytest.StashKey[float]()
_deadline = pytest.StashKey[float]()
_stderr_fd = pytest.StashKey[int]()


def pytest_configure(config):
    # Capture is suspended here, so this is the process's own stderr: the
    # hard stop writes there, since a test's captured stderr dies with it.
    config.stash[_stderr_fd] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_stderr_fd])


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    marker = item.get_closest_marker("timeout")
    if marker is None:
        return (yield)
    limit = float(marker.args[0])
    item.stash[_limit] = limit
    item.stash[_deadline] = time.monotonic() + limit
    faulthandler.dump_traceback_later(limit + HARD_STOP_AFTER_S, exit=True,
                                      file=item.config.stash[_stderr_fd])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


@contextlib.contextmanager
def _soft_stop(item):
    # Python runs signal handlers on the main thread only; xdist 3.8 runs
    # the tests there (execmodel main_thread_only).
    if (_limit not in item.stash
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def on_alarm(signum, frame):
        faulthandler.dump_traceback(all_threads=True)
        pytest.fail(f"{item.nodeid} ran past its time limit of "
                    f"{item.stash[_limit]:g} s")

    previous = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL,
                     max(item.stash[_deadline] - time.monotonic(), 1e-3))
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _soft_stop(item):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _soft_stop(item):
        return (yield)
