"""Shared fixtures — notably the runtime lock-order witness.

``lock_order_witness`` instruments the ``threading`` lock factories (via
``tools.analyze.runtime``) so every lock created at a source site the
static analyzer knows about records its acquisition order.  On teardown
the observed edges must be a subset of the statically-predicted lock
graph: an unpredicted edge means the static deadlock analysis has a blind
spot and fails the test that exposed it.

The concurrency-heavy suites (``test_async_backend``, ``test_adaptive_io``,
``test_prefetch``) opt in with a module-level autouse fixture.
"""
import functools
import os
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)  # tools.analyze is imported from the repo root

from tools.analyze.runtime import LockOrderWitness, static_lock_graph  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips where there is none")


@functools.lru_cache(maxsize=1)
def _static_graph():
    # one AST pass per pytest session, shared by every witness fixture
    return static_lock_graph(os.path.join(_REPO, "src"))


@pytest.fixture
def lock_order_witness():
    """Instrument lock creation for this test; verify order on teardown."""
    witness = LockOrderWitness(_static_graph())
    with witness.installed():
        yield witness
    unpredicted = witness.unpredicted()
    assert not unpredicted, (
        "runtime lock acquisitions the static lock graph did not predict "
        f"(update tools/analyze or fix the ordering):\n{witness.report()}"
    )
