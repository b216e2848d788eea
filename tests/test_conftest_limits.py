"""The per-test time limit of tests/_time_limit.py, driven through pytester
in a fresh pytest process (the limit's alarm and hard stop are
process-wide, so an in-process run would cancel this test's own), and the
root conftest.py's list of the JAX package's slow tests."""
import importlib.util
import os
import re
import subprocess
import sys
import time

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)

INNER = """
import signal, time
import pytest

@pytest.mark.timeout(1)
def test_sleeps_past_its_limit():
    time.sleep(30)

def test_runs_after_it():
    pass

@pytest.mark.timeout(5)
def test_under_its_limit():
    time.sleep(0.1)
"""

# Prints, after each inner test, the interval timer and the SIGALRM handler
# that the limit left behind.
INNER_CONFTEST = """
import signal

def pytest_runtest_logfinish(nodeid, location):
    print("AFTER", nodeid, signal.getitimer(signal.ITIMER_REAL),
          signal.getsignal(signal.SIGALRM) is signal.SIG_DFL)
"""


@pytest.fixture
def inner_run(pytester, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", TESTS)
    pytester.makeconftest(INNER_CONFTEST)
    pytester.makepyfile(test_inner=INNER)
    pytester.makeini("[pytest]\nmarkers =\n    timeout(seconds): limit\n")
    t0 = time.monotonic()
    res = pytester.runpytest_subprocess("-p", "_time_limit", "-rA",
                                        "-p", "no:cacheprovider")
    return res, time.monotonic() - t0


def test_a_test_past_its_limit_fails_with_its_node_id(inner_run):
    res, seconds = inner_run
    res.assert_outcomes(passed=2, failed=1)
    res.stdout.fnmatch_lines([
        "*test_inner.py::test_sleeps_past_its_limit ran past its time "
        "limit of 1 s*"])
    # the soft stop's stack dump names the line the test was on
    res.stdout.fnmatch_lines(["*File *test_inner.py*, line * in "
                              "test_sleeps_past_its_limit*"])
    # failed at its limit, not at the hard stop a minute later, and the
    # run went on
    assert seconds < 30
    res.stdout.fnmatch_lines(["*PASSED test_inner.py::test_runs_after_it"])


def test_a_test_under_its_limit_passes_and_clears_its_alarm(inner_run):
    res, _ = inner_run
    res.stdout.fnmatch_lines(["*PASSED test_inner.py::test_under_its_limit"])
    after = re.findall(r"AFTER (\S+) (\(.*?\)) (\w+)", res.stdout.str())
    assert [a[0].rsplit("::", 1)[1] for a in after] == [
        "test_sleeps_past_its_limit", "test_runs_after_it",
        "test_under_its_limit"]
    assert all(a[1:] == ("(0.0, 0.0)", "True") for a in after), after


def test_slow_list_names_collected_tests():
    """Every node id of the root conftest.py's SLOW is a test that
    collection finds, and `-m slow` selects exactly those in their files."""
    # by path: the module name `conftest` is tests/conftest.py's here
    spec = importlib.util.spec_from_file_location(
        "root_conftest", os.path.join(ROOT, "conftest.py"))
    root_conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_conftest)
    assert set(root_conftest.TIMEOUTS) <= set(root_conftest.SLOW)
    files = sorted({k.split("::")[0] for k in root_conftest.SLOW})
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-m",
         "slow", "-p", "no:cacheprovider", "-p", "no:randomly", *files],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    got = {line for line in res.stdout.splitlines() if "::" in line}
    assert got == set(root_conftest.SLOW)


def test_a_test_without_a_marker_gets_the_default_limit(request):
    assert request.node.get_closest_marker("timeout").args == (300,)
