"""Shared runner for the example scripts (examples/common.py): synthetic
data generation, the train loop and the throughput report, the role of
each FlexFlow example's top_level_task and DataLoader (e.g.
transformer.cc:112-211).  The data helpers use the reference's numpy
generators, so they give its arrays bit for bit.

Every example is a module of this package with ``main(argv=None,
config=None)``: ``config`` defaults to ``FFConfig.parse_args(argv)``,
which runs on the card; pass ``dataclasses.replace(cfg, device="cpu")``
to run on the CPU.  ``on_card`` is the size switch: the reference picks
its TPU sizes from ``jax.devices()``, the port its card sizes from the
config's device."""

from __future__ import annotations

import importlib
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.ptensor import DataType


def config_of(argv: Optional[Sequence[str]] = None,
              config: Optional[FFConfig] = None) -> FFConfig:
    """``config``, or the command line's (``FFConfig.parse_args``)."""
    return config if config is not None else FFConfig.parse_args(argv)


def on_card(config: FFConfig) -> bool:
    """True when the example runs at its full (card) size."""
    return torch.device(config.device).type == "cuda"


def require(module: str, why: str):
    """``module`` imported, or an ImportError that names it."""
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        raise ImportError(f"{module} is not installed; this example needs "
                          f"it for {why}") from e


def in_job() -> bool:
    """True inside a job of ranks (``runtime.distributed.initialize``)."""
    from flexflow_tpu_torch.runtime import distributed

    return distributed.is_initialized()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(rank_fn, config: FFConfig, timeout: float = 900.0):
    """Rank 0's result of ``rank_fn(rank, config)`` run in
    ``config.num_devices`` new processes, one per rank, joined over a
    loopback rendezvous on the config's device
    (``runtime.distributed.spawn``); ``rank_fn`` is a module-level
    function."""
    from flexflow_tpu_torch.runtime.distributed import spawn

    return spawn(rank_fn, config.num_devices, (config,),
                 init_method=f"tcp://localhost:{free_port()}",
                 device=config.device, timeout=timeout)[0]


def job_summary(model) -> dict:
    """What a rank of a multi-rank example returns: its lowering's kind,
    the stages and microbatches of a staged pipeline, the views by op
    name and the losses (numbers only: results cross processes)."""
    views = {}
    for guid, v in (model.strategy or {}).items():
        if guid in model.graph.nodes:
            views[model.graph.nodes[guid].op.name] = (
                tuple(v.dim_degrees), v.replica_degree, v.start_part)
    comp = model.compiled
    return {"kind": type(comp).__name__,
            "num_stages": getattr(comp, "num_stages", None),
            "num_microbatches": getattr(comp, "num_microbatches", None),
            "views": views,
            "losses": list(model.step_losses)}


def synthetic_inputs(model, num_samples: int, seed: int = 0) -> List[np.ndarray]:
    """Arrays matching the model's input tensors (batch dim replaced by
    num_samples); integer inputs stay below the vocab of the embedding
    they feed."""
    rng = np.random.default_rng(seed)
    out = []
    for t in model._input_tensors:
        shape = (num_samples,) + tuple(t.sizes[1:])
        if DataType.from_any(t.dtype).value.startswith("int"):
            vocab = 1000
            node, _ = model._producer[t.guid]
            for e in model.graph.out_edges[node.guid]:
                consumer = model.graph.nodes[e.dst].op
                if "num_entries" in consumer.attrs:
                    vocab = consumer.attrs["num_entries"]
            out.append(rng.integers(0, vocab, size=shape).astype(np.int32))
        else:
            out.append(rng.normal(size=shape).astype(np.float32))
    return out


def lm_sequence_data(num_samples: int, seq_len: int, vocab: int, seed: int = 0):
    """(x, y) for next-token training on the deterministic rule
    token[j] = (token[j-1] * 3 + 1) mod vocab, learnable by a causal
    model."""
    rng = np.random.default_rng(seed)
    x = np.empty((num_samples, seq_len), np.int32)
    x[:, 0] = rng.integers(0, vocab, num_samples)
    for j in range(1, seq_len):
        x[:, j] = (x[:, j - 1] * 3 + 1) % vocab
    return x, np.roll(x, -1, axis=1)


def synthetic_labels(model, num_samples: int, loss: str, seed: int = 1):
    rng = np.random.default_rng(seed)
    sink = model.graph.sinks()[-1]
    out_shape = sink.op.output_shapes[0].sizes
    if loss == "sparse_categorical_crossentropy":
        if len(out_shape) > 2:  # per-position logits (causal LM)
            return rng.integers(
                0, out_shape[-1], (num_samples,) + tuple(out_shape[1:-1])
            ).astype(np.int32)
        return rng.integers(0, out_shape[-1], num_samples).astype(np.int32)
    return rng.normal(size=(num_samples,) + tuple(out_shape[1:])).astype(np.float32)


def run_example(model, name: str, loss: str = "sparse_categorical_crossentropy",
                metrics: Sequence[str] = ("accuracy",), num_samples: int = 0,
                optimizer=None, recompile_state=None, skip_compile=False):
    """Compile (unless ``skip_compile``), then ``fit`` on synthetic data
    and print the throughput (rank 0 only, under a strategy over
    ranks).  Returns the model."""
    cfg = model.config
    num_samples = num_samples or cfg.batch_size * 8
    prints = model._prints()
    if not skip_compile:
        t0 = time.perf_counter()
        model.compile(optimizer=optimizer, loss_type=loss, metrics=list(metrics))
        if prints:
            print(f"[{name}] compile (incl. strategy search): "
                  f"{time.perf_counter()-t0:.2f}s")
    xs = synthetic_inputs(model, num_samples)
    y = synthetic_labels(model, num_samples, loss)
    model.fit(x=xs if len(xs) > 1 else xs[0], y=y,
              recompile_state=recompile_state)
    thr = getattr(model, "last_throughput", None)
    if thr and prints:
        print(f"[{name}] THROUGHPUT = {thr:.2f} samples/s")
    return model
