"""The port's ktsan guard: its sanitizer on for a test file's tests.

The counterpart of `conftest.KTSAN_MODULES` and `_ktsan_guard` for
`kubernetes_tpu_torch`: a test file that imports `torch_ktsan_guard`
runs every test with the port's lock sanitizer (`utils/sanitizer.py`)
on, and fails a test on any lock-order inversion, blocking call under
a lock, lock held by a dead thread, or leaked non-daemon thread. A
file that wants it for some tests only imports `torch_ktsan` and marks
them `@pytest.mark.usefixtures("torch_ktsan")`.

Enablement is creation-time, as in the JAX guard: locks built before
`enable()` (in module-scoped fixtures) stay plain; the tests build
their stores, watch caches and daemons per test. Imported by
`test_torch_store.py`, `test_torch_gang.py`, `test_torch_preemption.py`
and `test_torch_sanitizer.py` (whole files) and by the watch-cache tests
of `test_torch_apiserver.py`.
"""

import threading
import time

import pytest


def _guard():
    from kubernetes_tpu_torch.utils import sanitizer

    env_on = sanitizer.enabled()
    sanitizer.enable()
    sanitizer.reset()
    before = {t.ident for t in threading.enumerate()}
    yield

    def fresh_nondaemon():
        return [
            t for t in threading.enumerate()
            if t.ident not in before and t.is_alive() and not t.daemon
        ]

    # Let teardown-stopped workers actually exit before judging.
    deadline = time.monotonic() + 2.0
    while fresh_nondaemon() and time.monotonic() < deadline:
        time.sleep(0.02)
    leaked_threads = [t.name for t in fresh_nondaemon()]
    found = sanitizer.findings()
    dead_held = sanitizer.leaked_locks()
    sanitizer.reset()
    if dead_held:
        # Reported below: forget the dead holders so one real leak
        # fails one test instead of every later one.
        sanitizer.purge_dead_threads()
    if not env_on:
        sanitizer.disable()
    problems = []
    if found:
        problems.append(f"ktsan findings: {found}")
    if dead_held:
        problems.append(f"locks held by dead threads: {dead_held}")
    if leaked_threads:
        problems.append(f"leaked non-daemon threads: {leaked_threads}")
    if problems:
        pytest.fail("ktsan (port): " + "; ".join(problems))


@pytest.fixture(autouse=True)
def torch_ktsan_guard():
    """Every test of the importing file runs sanitized."""
    yield from _guard()


@pytest.fixture
def torch_ktsan():
    """One test runs sanitized (`usefixtures("torch_ktsan")`)."""
    yield from _guard()
