"""FFConfig — the subset of flexflow_tpu/config.py the decode, training
and search paths read.

``device`` is explicit and defaults to ``"cuda"``: the entry points run
on the card unless the caller asks for the CPU (the tests pass
``device="cpu"``).  With the default device and no CUDA,
``torch_device`` raises instead of continuing on the CPU.
``num_devices`` is the job's number of ranks (one process each,
``runtime.distributed.initialize``); ``compile`` checks it against the
job.

The serving knobs are the reference's (config.py:193, 221-237):
``prefill_chunk`` (the chunked prefill lane's chunk size),
``serve_slo_classes`` (normalised by ``parse_slo_classes``, a copy of
config.py:18-66) and ``kv_precision`` (the KV page-pool dtype lane:
"off", a pinned "fp32"/"bf16"/"int8" that
``compile(comp_mode="inference")`` adopts onto the decode ops, or
"search": the serve-objective search prices the three and persists
the winner as ``__meta__.kv``).  The serve objective's fields are the
reference's too (config.py:179-247, validated as at :378-421):
``serve_p99_budget_ms``, ``serve_disaggregation`` and ``serve_fleet``
(off|search: the two proposals of search/disaggregation.py and
search/fleet.py), ``serve_prompt_tokens_mean``,
``serve_decode_tokens_mean``, ``serve_fleet_max_replicas``,
``serve_fleet_offered_load`` and ``serve_shared_prefix_pages``.

``trace_steps`` is the reference's: ``fit`` runs that many optimizer
steps per compiled call (``CompiledModel.train_steps``).
The gradient-sync options are the reference's (config.py:269-316,
364-372, 420-434), with its validation: ``zero_dp_shard`` (ZeRO-1: each
rank keeps and updates its shard of every optimizer slot, then the
updated weights are all-gathered), ``sync_precision``
(fp32|bf16|int8|search: the per-weight-group wire precision,
comm/quantized.py, chosen by search/sync_precision.py),
``sync_schedule`` (off|search: the bucketed, issue-ordered sync of
search/sync_schedule.py, executed by comm/bucketed.py, with staged
reduction plans on a machine with link levels), ``sync_bucket_bytes``
(pins the schedule search's coalescing floor), ``sync_ef`` (off|auto:
error feedback on the int8 groups) and ``co_search`` (the joint
strategy x comm-plan search of search/comm_plan.py; it turns on
``sync_schedule="search"``).  They lower in the flat lowering
(compiler/lowering.py); ZeRO with ``pipeline=`` raises, as in the
reference.

The strategy search's fields are the reference's, with its defaults
(config.py:106, 115-160): ``machine_spec`` (default
``MachineSpec.h100_sxm(num_devices)``, or ``machine_model_file``'s),
``search_budget``, ``search_alpha``, ``only_data_parallel``,
``search_num_devices`` (``search_devices``), ``search_timeout_s``,
``search_improvement_margin``, ``base_optimize_threshold``,
``substitution_json``, ``calibration_file``, ``calibrate``,
``calibration_budget_s``, ``cost_cache_file``, ``objective``, ``verify``,
``profiling`` and ``drift_threshold`` (the drift loop's predicted
side, below), the two proposal flags ``enable_pipeline_search`` and
``enable_placement_search`` with ``placement_search_max_nodes``, and
the strategy files ``export_strategy_file``, ``import_strategy_file``
and ``import_strategy_partial``.  ``compile(strategy=None)`` reads them
(model.py).

The observability fields are the reference's (config.py:166-167,
319-335): ``obs_log_file`` (the event bus's JSONL sink, armed at
compile), ``obs_trace_file`` (the predicted timeline, written at
compile), ``export_strategy_computation_graph_file`` and
``export_strategy_task_graph_file`` (graphviz, at compile) and
``device_trace_dir`` (``fit``'s ``torch.profiler`` capture of its
post-compile steps, ingested into ``model.lane_drift_report``).

``remat`` and ``grad_accum_steps`` are the reference's two memory
levers (config.py:258-266, lowering.py:266-279 and :613-693): every
weighted op that mutates no state recomputes its activations in the
backward, and each optimizer step runs its batch as that many
microbatches (the batch must divide by it; checked at the step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from flexflow_tpu_torch.core.machine import MachineSpec

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def parse_slo_classes(value) -> Tuple[Dict, ...]:
    """Normalize the SLO-class table: the CLI spelling
    ``"name:priority:deadline_frames[:quantile[:weight]][,...]"`` or an
    iterable of dicts -> a tuple of ``{"name", "priority",
    "deadline_frames", "quantile", "weight"}`` dicts (runtime/decode.py
    ``SLOClass`` takes the first four)."""
    if isinstance(value, str):
        classes = []
        for part in value.split(","):
            fields = part.split(":")
            if len(fields) not in (3, 4, 5):
                raise ValueError(
                    f"SLO class {part!r} must be "
                    f"name:priority:deadline_frames[:quantile[:weight]]")
            classes.append({
                "name": fields[0],
                "priority": int(fields[1]),
                "deadline_frames": int(fields[2]),
                "quantile": float(fields[3]) if len(fields) >= 4 else 0.99,
                "weight": float(fields[4]) if len(fields) == 5 else 1.0,
            })
        value = classes
    out = []
    seen = set()
    for c in value:
        c = {"name": str(c["name"]), "priority": int(c["priority"]),
             "deadline_frames": int(c.get("deadline_frames", 0)),
             "quantile": float(c.get("quantile", 0.99)),
             "weight": float(c.get("weight", 1.0))}
        if not c["name"] or c["name"] in seen:
            raise ValueError(
                f"SLO class names must be unique and non-empty "
                f"(got {c['name']!r})")
        if c["deadline_frames"] < 0 or not (0.0 < c["quantile"] < 1.0):
            raise ValueError(
                f"SLO class {c['name']!r}: deadline_frames must be >= 0 "
                f"and quantile in (0, 1)")
        if not c["weight"] > 0.0:
            raise ValueError(
                f"SLO class {c['name']!r}: weight must be > 0, got "
                f"{c['weight']}")
        seen.add(c["name"])
        out.append(c)
    return tuple(out)


@dataclass
class FFConfig:
    batch_size: int = 64
    num_devices: int = 1
    compute_dtype: str = "bfloat16"  # matmul dtype, as the reference
    seed: int = 0
    kv_precision: str = "off"  # KV page-pool dtype: off|fp32|bf16|int8
    prefill_chunk: int = 32  # chunk size of the chunked prefill lane
    serve_slo_classes: Optional[object] = None  # parse_slo_classes input
    device: str = "cuda"
    epochs: int = 1
    learning_rate: float = 0.01  # the default SGD's, as the reference
    weight_decay: float = 0.0001
    comp_mode: str = "training"  # set by compile(comp_mode=...)
    remat: bool = False
    grad_accum_steps: int = 1
    trace_steps: int = 1  # optimizer steps per compiled call in fit
    # the reference's ZeRO-1 and gradient-sync options (module docstring)
    zero_dp_shard: bool = False
    sync_precision: str = "fp32"  # fp32|bf16|int8|search
    sync_schedule: str = "off"  # off|search
    sync_bucket_bytes: int = 0  # 0: sweep the default coalescing floors
    sync_ef: str = "off"  # off|auto
    co_search: bool = False
    # the strategy search (reference config.py:103-160, its defaults)
    machine_spec: Optional[MachineSpec] = None
    machine_model_file: Optional[str] = None
    search_budget: int = 16
    search_alpha: float = 1.05
    only_data_parallel: bool = False
    search_num_devices: int = 0  # 0: num_devices
    base_optimize_threshold: int = 10
    search_timeout_s: float = 45.0  # <= 0: no deadline
    enable_pipeline_search: bool = True
    enable_placement_search: bool = True
    placement_search_max_nodes: int = 80
    search_improvement_margin: float = 0.03
    substitution_json: Optional[str] = None
    calibration_file: Optional[str] = None
    calibrate: bool = False
    calibration_budget_s: float = 60.0
    cost_cache_file: Optional[str] = None
    objective: str = "train"  # "train" | "serve"
    # the serve objective's options (reference config.py:179-247, its
    # defaults): the declared p99 SLO (0: rank only), the disaggregation
    # and fleet proposals ("off" | "search"), the phase-split arrival
    # model (0: derived from the frame), the fleet's bounds and offered
    # load, and the pages per sequence expected from the shared prefix
    serve_p99_budget_ms: float = 0.0
    serve_disaggregation: str = "off"
    serve_prompt_tokens_mean: int = 0
    serve_decode_tokens_mean: int = 0
    serve_fleet: str = "off"
    serve_fleet_max_replicas: int = 4
    serve_fleet_offered_load: float = 0.85
    serve_shared_prefix_pages: int = 0
    verify: bool = False
    # the predicted side of the drift loop (reference config.py:256,
    # 336): with ``profiling`` (or the obs bus, or a calibration file)
    # compile records the simulator's breakdown of the lowered strategy
    # as ``model.predicted_breakdown``; the controller's drift watch
    # judges measured step and serving times against it and calls a
    # ratio past ``1 + drift_threshold`` (or under its inverse) drifted
    profiling: bool = False
    drift_threshold: float = 0.5
    # strategy files (reference config.py:160-161): compile exports the
    # lowered strategy with its __meta__ (pipeline, placement) and
    # imports one through the digest gate instead of searching
    export_strategy_file: Optional[str] = None
    import_strategy_file: Optional[str] = None
    # a best-effort import (reference config.py:162): the provenance
    # checks become warnings and the views whose op names match apply
    import_strategy_partial: bool = False
    # graphviz exports at compile (reference config.py:166-167): the
    # strategy's computation graph and the simulated task graph
    export_strategy_computation_graph_file: Optional[str] = None
    export_strategy_task_graph_file: Optional[str] = None
    # observability (reference config.py:319-335): the JSONL event
    # sink compile arms; the PREDICTED task timeline compile writes as
    # Chrome-trace JSON; the directory fit captures its post-compile
    # steps into with torch.profiler (runtime.profiler.device_trace),
    # with the sync buckets' lanes stamped, then ingests into
    # model.lane_drift_report.  None (the default): no sink, no file,
    # no capture and no stamp.
    obs_log_file: Optional[str] = None
    obs_trace_file: Optional[str] = None
    device_trace_dir: Optional[str] = None

    def __post_init__(self):
        if self.num_devices < 1:
            raise ValueError(
                f"num_devices must be >= 1, got {self.num_devices}")
        if self.compute_dtype not in _DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {sorted(_DTYPES)}, got "
                f"{self.compute_dtype!r}")
        if self.kv_precision not in ("off", "fp32", "bf16", "int8",
                                     "search"):
            raise ValueError(
                f"kv_precision must be off|fp32|bf16|int8|search, got "
                f"{self.kv_precision!r}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.serve_slo_classes is not None:
            self.serve_slo_classes = parse_slo_classes(
                self.serve_slo_classes)
        if self.objective not in ("train", "serve"):
            raise ValueError(
                f"objective must be train|serve, got {self.objective!r}")
        if self.serve_disaggregation not in ("off", "search"):
            raise ValueError(
                f"serve_disaggregation must be off|search, got "
                f"{self.serve_disaggregation!r}")
        if self.serve_fleet not in ("off", "search"):
            raise ValueError(
                f"serve_fleet must be off|search, got "
                f"{self.serve_fleet!r}")
        if self.serve_fleet_max_replicas < 1:
            raise ValueError(
                f"serve_fleet_max_replicas must be >= 1, got "
                f"{self.serve_fleet_max_replicas}")
        if not (0.0 < self.serve_fleet_offered_load <= 4.0):
            raise ValueError(
                f"serve_fleet_offered_load must be in (0, 4], got "
                f"{self.serve_fleet_offered_load}")
        if self.serve_shared_prefix_pages < 0:
            raise ValueError(
                f"serve_shared_prefix_pages must be >= 0, got "
                f"{self.serve_shared_prefix_pages}")
        if self.sync_precision not in ("fp32", "bf16", "int8", "search"):
            raise ValueError(
                f"sync_precision must be fp32|bf16|int8|search, got "
                f"{self.sync_precision!r}")
        if self.sync_schedule not in ("off", "search"):
            raise ValueError(
                f"sync_schedule must be off|search, got "
                f"{self.sync_schedule!r}")
        if self.sync_ef not in ("off", "auto"):
            raise ValueError(
                f"sync_ef must be off|auto, got {self.sync_ef!r}")
        if self.objective == "serve" and self.co_search:
            # the joint currency prices gradient sync, which a decode
            # step does not run
            raise ValueError(
                "objective='serve' does not compose with co_search (the "
                "joint comm-plan currency prices gradient sync, which a "
                "decode step does not run)")
        if self.co_search and self.sync_schedule == "off":
            # the joint currency IS the scheduled exposed-comm sync:
            # co-search without the schedule would price plans the
            # lowering never runs
            self.sync_schedule = "search"
        if self.machine_spec is None:
            self.machine_spec = (
                MachineSpec.from_file(self.machine_model_file)
                if self.machine_model_file
                else MachineSpec.h100_sxm(self.num_devices))
        if int(self.grad_accum_steps) < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{self.grad_accum_steps}")

    @property
    def search_devices(self) -> int:
        return self.search_num_devices or self.num_devices

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def torch_device(self) -> torch.device:
        """The device every tensor of the model lives on.  A CUDA device
        without CUDA is an error, never a silent move to the CPU."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"FFConfig.device={self.device!r} but torch sees no CUDA "
                f"device; pass device='cpu' to run on the CPU")
        return dev
