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


# ---- checkpoints of the lowerings that run in these worlds --------------
def npz_arrays(directory: str, step: int):
    """A snapshot's ``arrays.npz`` as {key: array}."""
    import numpy as np

    with np.load(os.path.join(directory, f"step_{step}",
                              "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


def checkpoint_round_trip(model, fresh, directory: str):
    """On a rank: save ``model`` (every rank takes part), restore the
    snapshot into ``fresh`` (a new compile of the same lowering), and
    return (the keys of the whole trees that differ bit for bit, the
    number of keys compared)."""
    import numpy as np

    from flexflow_tpu_torch.runtime.checkpoint import (
        CheckpointManager,
        snapshot_in_memory,
    )

    mgr = CheckpointManager(directory)
    mgr.save(1, model)
    assert mgr.restore(fresh) == 1
    a, b = (snapshot_in_memory(m)["trees"] for m in (model, fresh))
    differ = [f"{t}/{k}" for t in a for k in set(a[t]) | set(b[t])
              if k not in a[t] or k not in b[t]
              or not np.array_equal(a[t][k], b[t][k])]
    return differ, sum(len(v) for v in a.values())


def assert_npz_equal(got, ref):
    """Two snapshots' arrays: the same keys, each array bit-equal."""
    import numpy as np

    assert sorted(got) == sorted(ref), (sorted(set(got) ^ set(ref)))
    for k, v in ref.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(np.asarray(got[k], np.float64),
                                      np.asarray(v, np.float64), err_msg=k)
