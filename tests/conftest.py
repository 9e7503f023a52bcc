"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on 1 CPU device;
multi-device behaviour is exercised in subprocesses (see helpers below).

Also hosts a minimal ``hypothesis`` shim: the container does not ship the
real package, so property-test modules import ``given / settings /
strategies`` from here.  When hypothesis *is* installed it is re-exported
unchanged; otherwise a deterministic seeded-numpy sampler with the same
decorator surface runs each property ``max_examples`` times.

And a per-test timeout shim in the same spirit: ``pytest-timeout`` cannot
be pip-installed here, so a SIGALRM itimer around each test call phase
turns a hung async drain into a failing test instead of a wedged lane.
Default 600 s, overridable per test with ``@pytest.mark.timeout(N)`` or
globally via ``PYTEST_PER_TEST_TIMEOUT`` (0 disables).  POSIX main-thread
only — elsewhere it degrades to a no-op, never a false failure.
"""
import os
import signal
import subprocess
import sys
import threading
import zlib

import numpy as np
import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy model/system tests excluded from the fast "
        "CI lane (run with -m slow or no marker filter)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips (inside the test) where "
        "there is none")
    config.addinivalue_line(
        "markers", "timeout(seconds): per-test wall-clock limit enforced by "
        "the conftest SIGALRM shim (default from PYTEST_PER_TEST_TIMEOUT, "
        "600 s)")


_DEFAULT_TIMEOUT = float(os.environ.get("PYTEST_PER_TEST_TIMEOUT", "600"))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    marker = item.get_closest_marker("timeout")
    seconds = float(marker.args[0]) if marker and marker.args \
        else _DEFAULT_TIMEOUT
    can_alarm = (seconds > 0 and hasattr(signal, "SIGALRM")
                 and threading.current_thread() is threading.main_thread())
    if not can_alarm:
        yield
        return

    def _on_alarm(signum, frame):
        raise TimeoutError(
            f"{item.nodeid} exceeded the per-test timeout of {seconds:g}s "
            f"(conftest SIGALRM shim; raise with @pytest.mark.timeout)")

    prev = signal.signal(signal.SIGALRM, _on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def run_with_devices(code: str, n_devices: int = 8, timeout: int = 600) -> str:
    """Run a python snippet in a subprocess with N forced host devices."""
    env = {"XLA_FLAGS": f"--xla_force_host_platform_device_count={n_devices}",
           "PYTHONPATH": "src", "PATH": os.environ.get(
               "PATH", "/usr/bin:/bin:/usr/local/bin"),
           "HOME": os.environ.get("HOME", "/root")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=REPO_ROOT)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    return proc.stdout


# ---------------------------------------------------------------------------
# hypothesis shim (@given / @settings / strategies)
# ---------------------------------------------------------------------------

try:                                      # real hypothesis wins when present
    from hypothesis import given, settings, strategies    # noqa: F401
except ImportError:

    class _Strategy:
        """A sampler ``rng -> value`` with hypothesis' map/flatmap surface."""

        def __init__(self, draw):
            self._draw = draw

        def map(self, f):
            return _Strategy(lambda rng: f(self._draw(rng)))

        def flatmap(self, f):
            return _Strategy(lambda rng: f(self._draw(rng))._draw(rng))

    class _Strategies:
        @staticmethod
        def integers(min_value, max_value):
            return _Strategy(
                lambda rng: int(rng.integers(min_value, max_value + 1)))

        @staticmethod
        def floats(min_value, max_value):
            return _Strategy(
                lambda rng: float(rng.uniform(min_value, max_value)))

        @staticmethod
        def sampled_from(elements):
            elements = list(elements)
            return _Strategy(
                lambda rng: elements[int(rng.integers(len(elements)))])

        @staticmethod
        def booleans():
            return _Strategy(lambda rng: bool(rng.integers(2)))

    strategies = _Strategies()

    def settings(max_examples=20, **_ignored):
        def deco(f):
            f._shim_max_examples = max_examples
            return f
        return deco

    def given(**strats):
        def deco(f):
            def wrapper():
                n = getattr(wrapper, "_shim_max_examples", 20)
                seed = zlib.crc32(f.__qualname__.encode())
                rng = np.random.default_rng(seed)
                for _ in range(n):
                    f(**{k: s._draw(rng) for k, s in strats.items()})
            wrapper.__name__ = f.__name__
            wrapper.__doc__ = f.__doc__
            wrapper._shim_max_examples = getattr(f, "_shim_max_examples", 20)
            return wrapper
        return deco
