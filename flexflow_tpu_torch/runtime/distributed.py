"""Multi-process runtime — the port of flexflow_tpu/runtime/distributed.py.

The reference joins hosts with ``jax.distributed`` and runs one SPMD
program over every device.  The port runs one process per rank, joined
by ``torch.distributed``:

* ``initialize(init_method, num_processes, process_id, device)`` — one
  call per rank.  It picks the rank's device and the transport, prints
  both, and never changes them afterwards:

  - ``device="cuda"`` with a card per rank: card ``process_id`` and
    NCCL on device tensors (``"nccl"``);
  - ``device="cuda"`` with fewer cards than ranks: card
    ``process_id % count`` and gloo (``"gloo-host"``), because NCCL
    refuses two ranks on one card and gloo's send/recv takes host
    tensors only; the collectives of ``parallel/mesh.py`` copy each
    block to the host and back, and count the hops;
  - ``device="cpu"``: gloo on host tensors (``"gloo"``).

  A CUDA rank without CUDA raises: a rank never moves to the CPU.
  Then it builds the job's mesh (``parallel.mesh.Mesh``: the ranks over
  the prime-factor axes of the world size, with every process group of
  every set of axes, created on every rank in one order).
* ``is_initialized``, ``world_size``, ``rank``, ``num_hosts``,
  ``transport``, ``mesh``
  (the job's, or a one-rank mesh outside a job), ``mesh_over`` (a mesh
  over a block of the job's ranks or with other axes, built once per
  job: the pipelined, placed and staged lowerings');
* ``local_seq_slice(seq_len, axes)`` and ``local_batch_slice(
  global_batch, axes)`` — the [start, stop) of the sequence or of the
  batch this rank holds when it is split over ``axes`` (default: every
  axis, i.e. over all ranks);
* ``spawn(fn, num_processes, ...)`` — start the ranks of one job on this
  host (``torch.multiprocessing``, start method ``spawn``), run
  ``fn(rank, *args)`` in each after ``initialize``, and return their
  results in rank order; a rank that raises fails the call.
"""

from __future__ import annotations

import datetime
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


# the job this process joined (one per process, as torch.distributed's
# default group is)
_JOB: dict = {}


def initialize(init_method: str, num_processes: int, process_id: int,
               device: Optional[str] = None) -> str:
    """Join the job as rank ``process_id`` of ``num_processes`` through
    ``init_method`` (``tcp://host:port`` or ``file:///path``) and return
    the transport name.  ``device`` is ``"cuda"`` (the default) or
    ``"cpu"``; for ``"cuda"`` the rank's card becomes the current
    device."""
    device = device or "cuda"
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"rank {process_id} of {num_processes} processes")
    if device == "cpu":
        backend, transport = "gloo", "gloo"
        where = "cpu"
    elif device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {process_id}: device='cuda' but torch sees no CUDA "
                f"device; pass device='cpu' to run on the CPU")
        count = torch.cuda.device_count()
        card = process_id % count
        torch.cuda.set_device(card)
        if count >= num_processes:
            backend, transport = "nccl", "nccl"
        else:
            backend, transport = "gloo", "gloo-host"
        where = f"cuda:{card}"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(minutes=10))
    # every rank's first collective: NCCL sets up its communicator here,
    # so later batched sends may involve a subset of the ranks (the
    # zigzag exchange keeps some halves local)
    dist.barrier()
    import socket

    from flexflow_tpu_torch.parallel.mesh import Mesh

    hosts = [None] * num_processes
    dist.all_gather_object(hosts, socket.gethostname())
    _JOB["hosts"] = len(set(hosts))

    _JOB["transport"] = transport
    _JOB["mesh"] = Mesh(num_processes, process_id)
    print(f"rank {process_id}/{num_processes}: {where}, transport "
          f"{transport}", flush=True)
    return transport


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def num_hosts() -> int:
    """How many hosts the job's ranks run on (1 outside a job)."""
    return _JOB.get("hosts", 1) if is_initialized() else 1


def transport() -> Optional[str]:
    """The transport ``initialize`` chose: ``"nccl"``, ``"gloo-host"``
    (ranks sharing a card) or ``"gloo"`` (CPU); None outside a job."""
    return _JOB.get("transport") if is_initialized() else None


def mesh():
    """The job's mesh, or a one-rank mesh outside a job."""
    if is_initialized() and "mesh" in _JOB:
        return _JOB["mesh"]
    from flexflow_tpu_torch.parallel.mesh import Mesh

    return Mesh(1, 0, make_groups=False)


def mesh_over(axes=None, start: int = 0, width: Optional[int] = None):
    """The mesh of the job's ranks ``[start, start + width)`` over
    ``axes`` (``parallel.mesh.Mesh``; default width: the job's, default
    axes: the prime factors of the width).  Built once per job and
    geometry: every rank of the job must call it with the same
    arguments in the same order, because building it creates process
    groups on every rank."""
    from flexflow_tpu_torch.parallel.mesh import Mesh

    world = world_size()
    width = world if width is None else width
    key = (None if axes is None else tuple(tuple(a) for a in axes),
           start, width)
    if not is_initialized():
        return Mesh(1, 0, make_groups=False, axes=axes, start=start,
                    width=width)
    if key == (None, 0, world):
        return mesh()
    meshes = _JOB.setdefault("meshes", {})
    if key not in meshes:
        meshes[key] = Mesh(world, rank(), axes=axes, start=start,
                           width=width)
    return meshes[key]


def _local_slice(size: int, axes: Optional[Sequence[str]], what: str
                 ) -> Tuple[int, int]:
    m = mesh()
    axes = m.names if axes is None else tuple(axes)
    n = m.size(axes)
    if size % n:
        raise ValueError(f"{what} {size} does not split into {n} ranks")
    per = size // n
    i = m.index(axes)
    return i * per, (i + 1) * per


def local_seq_slice(seq_len: int, axes: Optional[Sequence[str]] = None
                    ) -> Tuple[int, int]:
    """[start, stop) of the sequence this rank holds when the sequence
    is split over ``axes`` of the mesh (default: over every rank)."""
    return _local_slice(seq_len, axes, "sequence length")


def local_batch_slice(global_batch: int,
                      axes: Optional[Sequence[str]] = None
                      ) -> Tuple[int, int]:
    """[start, stop) rows of the global batch this rank feeds when the
    batch is split over ``axes`` (default: over every rank)."""
    return _local_slice(global_batch, axes, "batch")


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()
    _JOB.clear()


def _rank_main(process_id, fn, num_processes, init_method, device, inbox,
               results):
    args = inbox.get()
    if device == "cpu":
        torch.set_num_threads(1)
    initialize(init_method, num_processes, process_id, device)
    try:
        results.put((process_id, fn(process_id, *args)))
    finally:
        shutdown()


def spawn(fn: Callable, num_processes: int, args: Sequence = (), *,
          init_method: str, device: str = "cuda",
          timeout: float = 600.0) -> List:
    """Run ``fn(rank, *args)`` in ``num_processes`` new processes, each
    joined to the job first (``initialize(init_method, num_processes,
    rank, device)``), and return the ranks' results in rank order.
    ``fn``, ``args`` and the results cross processes by pickle, so
    ``fn`` is a module-level function.  A rank that raises or exits
    ends every rank and raises here
    (``torch.multiprocessing.ProcessRaisedException`` with its
    traceback); so does a job still running after ``timeout`` seconds
    (``TimeoutError``).  CPU ranks run one intra-op thread each."""
    import threading

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    inbox, results = ctx.SimpleQueue(), ctx.SimpleQueue()
    # ``args`` go through a queue once every rank has started: inside the
    # process objects, a pickle larger than a pipe's buffer would hold
    # each start until that rank had imported its modules, one rank
    # after another
    job = mp.start_processes(
        _rank_main, args=(fn, num_processes, init_method, device, inbox,
                          results),
        nprocs=num_processes, join=False, start_method="spawn")
    payload = tuple(args)
    threading.Thread(target=lambda: [inbox.put(payload)
                                     for _ in range(num_processes)],
                     daemon=True).start()
    got = {}
    deadline = time.monotonic() + timeout
    try:
        while True:
            while not results.empty():  # drain before join: no pipe stall
                r, out = results.get()
                got[r] = out
            if job.join(timeout=0.2):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{num_processes} ranks still running "
                                   f"after {timeout:.0f} s")
    finally:
        for p in job.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    while not results.empty():
        r, out = results.get()
        got[r] = out
    return [got[r] for r in range(num_processes)]
