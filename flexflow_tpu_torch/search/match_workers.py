"""Opt-in process-parallel substitution matching — a copy of
flexflow_tpu/search/match_workers.py.

At 10k-node scale the full-scan match sweeps that SEED the search —
the driver's one-time ``_score_edges`` pass and every popped
candidate's first (parent-less) match collection — are embarrassingly
parallel across xfers: each ``find_matches`` is a pure function of
(graph, xfer).  This module fans those sweeps out to a small process
pool when ``FLEXFLOW_TPU_MATCH_WORKERS=N`` (N >= 2) is set; the
default (unset/0/1) keeps the exact serial path, so the pool is
strictly opt-in and the zoo bit-identity gates hold by construction.

Workers rebuild the xfer registry themselves from ``(num_devices,
substitution_json)`` — xfer closures do not pickle — which is sound
because ``generate_all_pcg_xfers`` + the JSON loader are deterministic
in those inputs, so worker index ``i`` is the parent's ``xfers[i]``.
Matches return as guids (GraphXfer) or binding dicts
(BatchEmbeddingsXfer / PatternRule) and are re-bound to the parent's
Node objects.  Under ``FLEXFLOW_TPU_DELTA_CHECK=1`` every pooled sweep
is recomputed serially and asserted identical — the same oracle
discipline as delta simulation and the seed index.

The port starts its workers with ``spawn`` (the reference forks), since
the process runs torch's threads.  Any pool failure (spawn, pickle,
worker crash) degrades to the serial path and disables the pool for the
rest of the process — matching can never be less available than before.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

from flexflow_tpu_torch.obs.metrics import METRICS

BATCHES = METRICS.counter("substitution.match_worker_batches")

# graphs below this size never dispatch: the graph pickle + IPC costs
# more than the serial sweep saves
MIN_POOL_NODES = 384

_POOL = None  # (pool object, key) once armed
_DISABLED = False  # sticky off-switch after any pool failure

_W_XFERS: Optional[list] = None  # worker-process registry


def worker_count() -> int:
    v = os.environ.get("FLEXFLOW_TPU_MATCH_WORKERS", "")
    try:
        n = int(v)
    except ValueError:
        return 0
    return n if n >= 2 else 0


def _init_worker(num_devices: int, substitution_json: Optional[str]):
    global _W_XFERS
    from flexflow_tpu_torch.search.substitution import generate_all_pcg_xfers

    xfers = list(generate_all_pcg_xfers(num_devices))
    if substitution_json:
        from flexflow_tpu_torch.search.substitution_loader import (
            load_substitution_json,
        )

        xfers += load_substitution_json(substitution_json)
    _W_XFERS = xfers


def _match_task(args):
    graph_bytes, indices = args
    g = pickle.loads(graph_bytes)
    out = {}
    for xi in indices:
        ms = _W_XFERS[xi].find_matches(g)
        out[xi] = [m.guid if hasattr(m, "guid") else m for m in ms]
    return out


def _get_pool(num_devices: int, substitution_json: Optional[str]):
    global _POOL, _DISABLED
    if _DISABLED:
        return None
    n = worker_count()
    if n == 0:
        return None
    key = (n, num_devices, substitution_json or "")
    if _POOL is not None:
        if _POOL[1] == key:
            return _POOL[0]
        _POOL[0].terminate()
        _POOL = None
    import atexit
    import multiprocessing as mp

    try:
        # spawn, where the reference forks: this process runs torch's
        # threads, and a forked child of a threaded process can hang;
        # the workers rebuild the registry from the initializer's args
        ctx = mp.get_context("spawn")
        pool = ctx.Pool(
            n, initializer=_init_worker,
            initargs=(num_devices, substitution_json))
    except (ValueError, OSError):
        _DISABLED = True
        return None
    _POOL = (pool, key)
    atexit.register(shutdown)
    return pool


def shutdown() -> None:
    global _POOL
    if _POOL is not None:
        _POOL[0].terminate()
        _POOL = None


def find_all_matches(xfers: list, graph, config,
                     num_devices: int) -> Optional[List[list]]:
    """All xfers' matches of ``graph`` via the worker pool — a list
    aligned with ``xfers`` — or None when the pool is off/ineligible
    (caller runs the serial sweep).  Serial-identity is asserted under
    FLEXFLOW_TPU_DELTA_CHECK."""
    global _DISABLED
    if graph.num_nodes < MIN_POOL_NODES:
        return None
    pool = _get_pool(num_devices,
                     getattr(config, "substitution_json", None))
    if pool is None:
        return None
    try:
        blob = pickle.dumps(graph, protocol=4)
    except Exception:
        return None
    n = worker_count()
    chunks: List[List[int]] = [[] for _ in range(min(n * 2, len(xfers)))]
    for xi in range(len(xfers)):
        chunks[xi % len(chunks)].append(xi)
    try:
        results = pool.map(_match_task, [(blob, ch) for ch in chunks])
    except Exception:
        # a dead pool must not kill the search — degrade to serial
        shutdown()
        _DISABLED = True
        return None
    BATCHES.inc()
    merged = {}
    for r in results:
        merged.update(r)
    nodes = graph.nodes
    out: List[list] = []
    for xi in range(len(xfers)):
        ms = [nodes[m] if isinstance(m, int) else m
              for m in merged.get(xi, [])]
        out.append(ms)
    from flexflow_tpu_torch.search.substitution import DELTA_MATCH_CHECK

    if DELTA_MATCH_CHECK:
        for xi, xf in enumerate(xfers):
            serial = xf.find_matches(graph)
            a = [m.guid if hasattr(m, "guid") else m for m in out[xi]]
            b = [m.guid if hasattr(m, "guid") else m for m in serial]
            assert a == b, (
                f"match worker pool diverged from serial for "
                f"{getattr(xf, 'name', xf)}: {a} != {b}"
            )
    return out
