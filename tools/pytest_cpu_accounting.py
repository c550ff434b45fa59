"""A pytest plugin that records each test's wall time and CPU time: the
test process's own (all its threads) and that of the child processes it
reaped during the test (a JAX reference subprocess counts in the test that
waits for it).

    CPU_ACCOUNTING_DIR=out PYTHONPATH=tools python -m pytest tests/ \\
        -p pytest_cpu_accounting -p xdist -n 6 --dist loadfile ...

Each process (each xdist worker) writes ``out/cpu_<worker>.json``: a list
of ``[nodeid, start (epoch s), wall s, own CPU s, children's CPU s]``.
Without ``CPU_ACCOUNTING_DIR`` it records nothing.
"""

import json
import os
import resource
import time

import pytest

_ROWS = []


def _cpu(who) -> float:
    r = resource.getrusage(who)
    return r.ru_utime + r.ru_stime


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if not os.environ.get("CPU_ACCOUNTING_DIR"):
        yield
        return
    own, kids = _cpu(resource.RUSAGE_SELF), _cpu(resource.RUSAGE_CHILDREN)
    t0 = time.time()
    yield
    _ROWS.append([item.nodeid, t0, time.time() - t0,
                  _cpu(resource.RUSAGE_SELF) - own,
                  _cpu(resource.RUSAGE_CHILDREN) - kids])


def pytest_sessionfinish(session):
    out = os.environ.get("CPU_ACCOUNTING_DIR")
    if not out:
        return
    os.makedirs(out, exist_ok=True)
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    with open(os.path.join(out, f"cpu_{worker}.json"), "w",
              encoding="utf-8") as f:
        json.dump(_ROWS, f)
