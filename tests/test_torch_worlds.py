"""One gloo world per test module and per test run, however the tests
are spread over pytest-xdist workers.

A module-scoped fixture that spawns ranks runs once in every worker
that runs one of its module's tests.  ``shared_world(tmp_path_factory,
key, compute)`` runs ``compute()`` once per run: the first worker to
ask computes it under a file lock in the run's temporary root (the
parent of each worker's own root) and pickles the result there; the
others wait on the lock and load it.  Without xdist it is
``compute()`` itself, once per module.  The pipeline, placement and
staged-pipeline parity tests take their worlds through it."""

from __future__ import annotations

import fcntl
import os
import pickle


def shared_world(tmp_path_factory, key: str, compute):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the run's root, above every worker's own
    data = root / f"{key}.pkl"
    with open(root / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if data.exists():
            with open(data, "rb") as f:
                return pickle.load(f)
        result = compute()
        tmp = root / f"{key}.pkl.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, data)
        return result


def test_shared_world_computes_once(tmp_path_factory):
    calls = []

    def compute():
        calls.append(1)
        return {"value": len(calls)}

    first = shared_world(tmp_path_factory, "shared_world_selftest", compute)
    second = shared_world(tmp_path_factory, "shared_world_selftest", compute)
    assert first == second == {"value": 1}
    assert len(calls) == 1
