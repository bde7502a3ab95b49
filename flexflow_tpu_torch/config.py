"""FFConfig — the port's flexflow_tpu/config.py: the fields the decode,
training, search and frontend paths read, and the command line.

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

The command line is the reference's (config.py:464-697):
``FFConfig.parse_args(argv)`` takes its flags, destinations and
defaults, unknown flags left to the caller (``parse_known_args``).
``-ll:tpu`` keeps its spelling and counts cards here; its default 0
means every visible card (``num_devices=0``, below).  ``parse_args``
leaves ``device`` at ``"cuda"``: for the CPU, ``dataclasses.replace(
FFConfig.parse_args(argv), device="cpu")``.  ``slice_levels`` is the
reference's too (config.py:69-90, 108, 447-456): a link hierarchy above
the cards' own links, ``"span:bandwidth:latency[,...]"`` or triples,
laid over whichever ``machine_spec`` resolves and validated at
construction.  ``num_devices=0`` resolves to the visible cards
(``torch.cuda.device_count()``, at least 1, so that a CUDA config made
on a host without CUDA still constructs and raises in
``torch_device``) on a CUDA device, and to 1 on the CPU.

``iteration`` is the reference's ``IterationConfig`` (config.py:89-94,
361): its ``seq_length``, when positive, reaches every lowering's
``LoweringContext`` and ``batch_matmul`` masks the sequence tail past
it (ops/attention.py).  ``param_dtype``, ``perform_fusion``,
``enable_parameter_parallel``, ``enable_attribute_parallel`` and
``enable_inplace_optimizations`` (config.py:120-122, 254, 257) are
accepted with the reference's defaults and read nowhere, as in the
reference; ``parse_args`` maps ``--enable-parameter-parallel`` and
``--enable-attribute-parallel`` onto the two flags.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

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


def parse_slice_levels(value) -> Tuple[Tuple[int, float, float], ...]:
    """Normalize a slice-level hierarchy: the CLI spelling
    ``"span:bw:lat[,span:bw:lat...]"`` or an iterable of (span,
    bandwidth, latency) triples -> MachineSpec.slice_levels tuples.
    Structural validation (ascending aligned spans) stays in
    MachineSpec.topology_levels(), the one reader."""
    if isinstance(value, str):
        levels = []
        for part in value.split(","):
            fields = part.split(":")
            if len(fields) != 3:
                raise ValueError(
                    f"slice level {part!r} must be span:bandwidth:latency")
            levels.append(
                (int(fields[0]), float(fields[1]), float(fields[2])))
        return tuple(levels)
    return tuple(
        (int(span), float(bw), float(lat)) for span, bw, lat in value)


@dataclass
class IterationConfig:
    """Per-iteration knobs threaded into the forward and backward
    (reference config.py:89-94, after FlexFlow's FFIterationConfig):
    ``seq_length`` > 0 masks ``batch_matmul``'s sequence tail."""

    seq_length: int = -1


@dataclass
class FFConfig:
    batch_size: int = 64
    num_devices: int = 1  # 0: every visible card (1 on the CPU)
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
    # a link hierarchy above the cards' own links (reference
    # config.py:108): (span, bandwidth, latency) triples or the CLI
    # spelling "span:bw:lat[,...]", laid over the resolved machine_spec
    slice_levels: Optional[object] = None
    search_budget: int = 16
    search_alpha: float = 1.05
    only_data_parallel: bool = False
    # accepted and read nowhere, as in the reference (config.py:120-122)
    enable_parameter_parallel: bool = True
    enable_attribute_parallel: bool = True
    enable_inplace_optimizations: bool = True
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
    # accepted and read nowhere, as in the reference (config.py:254, 257)
    param_dtype: str = "float32"
    perform_fusion: bool = True
    iteration: IterationConfig = field(default_factory=IterationConfig)

    def __post_init__(self):
        if self.num_devices == 0:
            self.num_devices = (max(1, torch.cuda.device_count())
                                if torch.device(self.device).type == "cuda"
                                else 1)
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
        if self.slice_levels:
            levels = parse_slice_levels(self.slice_levels)
            self.machine_spec = dataclasses.replace(
                self.machine_spec, slice_levels=levels)
            # fail at construction, not mid-search
            self.machine_spec.topology_levels()
            self.slice_levels = levels
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

    # ---- argv parsing ----------------------------------------------------
    @staticmethod
    def parse_args(argv: Optional[Sequence[str]] = None) -> "FFConfig":
        """Accepts the reference's flag spellings (flexflow_tpu
        config.py:464-697, after FlexFlow's model.cc:3371-3654).
        ``-ll:tpu`` keeps the reference's spelling and counts CUDA cards
        here (0, its default: every visible card).  The config runs on
        the card; replace ``device`` for the CPU."""
        p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
        p.add_argument("-e", "--epochs", type=int, default=1)
        p.add_argument("-b", "--batch-size", type=int, default=64)
        p.add_argument("--lr", "--learning-rate", dest="lr", type=float, default=0.01)
        p.add_argument("--wd", "--weight-decay", dest="wd", type=float, default=1e-4)
        p.add_argument("-ll:tpu", "--num-devices", dest="num_devices", type=int, default=0,
                       help="CUDA cards of the job (0 = every visible "
                            "card)")
        p.add_argument("--budget", "--search-budget", dest="budget", type=int, default=128)
        p.add_argument("--alpha", "--search-alpha", dest="alpha", type=float, default=1.05)
        p.add_argument("--only-data-parallel", action="store_true")
        p.add_argument("--enable-parameter-parallel", action="store_true", default=True)
        p.add_argument("--enable-attribute-parallel", action="store_true", default=True)
        p.add_argument("--search-num-nodes", type=int, default=0)
        p.add_argument("--search-num-workers", type=int, default=0)
        p.add_argument("--base-optimize-threshold", type=int, default=10)
        p.add_argument("--search-timeout", dest="search_timeout", type=float, default=45.0)
        p.add_argument("--search-improvement-margin",
                       dest="search_improvement_margin", type=float,
                       default=0.03,
                       help="minimum simulated win over plain DP before a "
                            "searched strategy is accepted (champion-vs-DP "
                            "floor)")
        p.add_argument("--disable-pipeline-search",
                       dest="disable_pipeline_search", action="store_true",
                       help="compile() stops proposing pipelined lowerings "
                            "for stacked-block graphs")
        p.add_argument("--substitution-json", type=str, default=None)
        p.add_argument("--calibration-file", type=str, default=None)
        p.add_argument("--calibrate", action="store_true")
        p.add_argument("--calibration-budget", dest="calibration_budget",
                       type=float, default=60.0)
        p.add_argument("--export-strategy", dest="export_strategy", type=str, default=None)
        p.add_argument("--import-strategy", dest="import_strategy", type=str, default=None)
        p.add_argument("--import-strategy-partial",
                       dest="import_strategy_partial", action="store_true",
                       help="apply a strategy file best-effort even when "
                            "its graph digest/coverage does not match "
                            "(provenance checks downgrade to warnings)")
        p.add_argument("--machine-model-file", type=str, default=None)
        p.add_argument("--slice-levels", dest="slice_levels", type=str,
                       default=None,
                       help="multi-slice link hierarchy above ICI "
                            "without a machine file: comma list of "
                            "span:bandwidth:latency triples, e.g. "
                            "'16:3.1e9:1e-5' for one DCN class "
                            "spanning 16 devices (MachineSpec."
                            "slice_levels)")
        p.add_argument("--taskgraph", dest="export_taskgraph", type=str, default=None)
        p.add_argument("--profiling", action="store_true")
        p.add_argument("--trace-steps", dest="trace_steps", type=int, default=1)
        p.add_argument("--grad-accum-steps", dest="grad_accum_steps",
                       type=int, default=1)
        p.add_argument("--remat", action="store_true")
        p.add_argument("--zero-dp-shard", dest="zero_dp_shard",
                       action="store_true")
        p.add_argument("--sync-precision", dest="sync_precision",
                       choices=("fp32", "bf16", "int8", "search"),
                       default="fp32",
                       help="gradient-sync wire precision; 'search' "
                            "lets the strategy search pick it per "
                            "weight group")
        p.add_argument("--sync-schedule", dest="sync_schedule",
                       choices=("off", "search"), default="off",
                       help="gradient-sync schedule: 'search' buckets "
                            "the weight-grad collectives and issues "
                            "them inside the backward "
                            "(search/sync_schedule.py)")
        p.add_argument("--sync-bucket-bytes", dest="sync_bucket_bytes",
                       type=int, default=0,
                       help="pin the schedule search's per-bucket "
                            "coalescing floor in bytes (0 = sweep)")
        p.add_argument("--co-search", dest="co_search",
                       action="store_true",
                       help="joint strategy x comm-plan co-search: "
                            "price every candidate strategy with its "
                            "best sync schedule/precision/reduction "
                            "plan inside the substitution search "
                            "(search/comm_plan.py)")
        p.add_argument("--sync-ef", dest="sync_ef",
                       choices=("off", "auto"), default="off",
                       help="error-feedback residuals on int8 gradient "
                            "sync (per-group int8_ef wire choice, "
                            "residual threaded as training-loop state)")
        p.add_argument("--objective", dest="objective",
                       choices=("train", "serve"), default="train",
                       help="search objective: 'serve' ranks decode "
                            "graphs by simulated p99 latency over a "
                            "ragged arrival model under the HBM "
                            "KV-residency budget (search/serving.py)")
        p.add_argument("--serve-p99-budget-ms",
                       dest="serve_p99_budget_ms", type=float,
                       default=0.0,
                       help="declared p99 SLO for objective=serve "
                            "(recorded in __meta__.serving, linted "
                            "SHD163); 0 = rank-only")
        p.add_argument("--serve-disaggregation",
                       dest="serve_disaggregation",
                       choices=("off", "search"), default="off",
                       help="under objective=serve, also search a "
                            "prefill/decode disaggregation: prompt and "
                            "decode graphs on disjoint submeshes, the "
                            "KV handoff priced as a cross-block "
                            "transfer (search/disaggregation.py)")
        p.add_argument("--prefill-chunk", dest="prefill_chunk",
                       type=int, default=32,
                       help="chunk size of the batched prefill lane "
                            "(runtime/prefill.py): prompt tokens "
                            "written into the KV page pool per causal "
                            "forward pass")
        p.add_argument("--serve-fleet", dest="serve_fleet",
                       choices=("off", "search"), default="off",
                       help="under objective=serve, also search a "
                            "serving FLEET: N replica blocks on "
                            "disjoint submeshes, per-replica strategy "
                            "and per-SLO-class routing priced together "
                            "in per-class p99 (search/fleet.py)")
        p.add_argument("--serve-fleet-max-replicas",
                       dest="serve_fleet_max_replicas", type=int,
                       default=4,
                       help="upper bound on fleet replica count the "
                            "partition enumeration explores")
        p.add_argument("--serve-slo-classes", dest="serve_slo_classes",
                       type=str, default=None,
                       help="request SLO classes for the serving "
                            "executor: comma list of name:priority:"
                            "deadline_frames[:quantile] — priority "
                            "admission, deadline expiry, preemption "
                            "(runtime/decode.py)")
        p.add_argument("--kv-precision", dest="kv_precision",
                       choices=("off", "fp32", "bf16", "int8", "search"),
                       default="off",
                       help="KV page-pool dtype lane (ops/"
                            "decode_attention.py): pin fp32/bf16/int8 "
                            "(int8 adds per-page scales + in-kernel "
                            "dequant) or 'search' to price the lane "
                            "under objective=serve; 'off' is "
                            "byte-identical to history")
        p.add_argument("--serve-shared-prefix-pages",
                       dest="serve_shared_prefix_pages", type=int,
                       default=0,
                       help="pages per sequence expected to be CLAIMED "
                            "from the radix prefix trie instead of "
                            "privately allocated (runtime/decode.py) — "
                            "prices SHARED KV residency in SHD161 and "
                            "kv_residency_bytes")
        p.add_argument("--obs-log", dest="obs_log", type=str, default=None,
                       help="JSONL structured-event telemetry sink "
                            "(flexflow_tpu_torch/obs; tools/ffobs.py renders it)")
        p.add_argument("--obs-trace", dest="obs_trace", type=str,
                       default=None,
                       help="write the PREDICTED task timeline as "
                            "Chrome-trace JSON at compile (Perfetto)")
        p.add_argument("--device-trace-dir", dest="device_trace_dir",
                       type=str, default=None,
                       help="capture a REAL torch.profiler device trace "
                            "of fit's post-compile steps into this "
                            "logdir, lane-stamped and tag-matched "
                            "against the predicted comm lanes "
                            "(obs/trace_ingest.py LaneDriftReport)")
        p.add_argument("--drift-threshold", dest="drift_threshold",
                       type=float, default=0.5,
                       help="predicted-vs-measured step-time drift "
                            "beyond which the DriftReport flags "
                            "calibration staleness")
        p.add_argument("--cost-cache-file", dest="cost_cache_file",
                       type=str, default=None,
                       help="persistent per-(op, view) cost-row + "
                            "search-result cache (search/cost_cache.py); "
                            "repeated searches start warm")
        p.add_argument("--no-cost-cache", dest="no_cost_cache",
                       action="store_true",
                       help="bypass the persistent cost cache even when "
                            "a file/env default is configured")
        p.add_argument("--verify", action="store_true",
                       help="static-analysis verification "
                            "(flexflow_tpu_torch/analysis): check graph "
                            "invariants after every rewrite and the "
                            "compile-time graph before lowering")
        p.add_argument("--seed", type=int, default=0)
        args, _ = p.parse_known_args(argv)
        search_devs = args.search_num_workers * max(1, args.search_num_nodes or 1)
        return FFConfig(
            epochs=args.epochs,
            batch_size=args.batch_size,
            learning_rate=args.lr,
            weight_decay=args.wd,
            num_devices=args.num_devices,
            search_budget=args.budget,
            search_alpha=args.alpha,
            only_data_parallel=args.only_data_parallel,
            enable_parameter_parallel=args.enable_parameter_parallel,
            enable_attribute_parallel=args.enable_attribute_parallel,
            search_num_devices=search_devs,
            base_optimize_threshold=args.base_optimize_threshold,
            search_timeout_s=args.search_timeout,
            search_improvement_margin=args.search_improvement_margin,
            enable_pipeline_search=not args.disable_pipeline_search,
            substitution_json=args.substitution_json,
            calibration_file=args.calibration_file,
            calibrate=args.calibrate,
            calibration_budget_s=args.calibration_budget,
            export_strategy_file=args.export_strategy,
            import_strategy_file=args.import_strategy,
            import_strategy_partial=args.import_strategy_partial,
            export_strategy_task_graph_file=args.export_taskgraph,
            machine_model_file=args.machine_model_file,
            slice_levels=args.slice_levels,
            profiling=args.profiling,
            trace_steps=args.trace_steps,
            grad_accum_steps=args.grad_accum_steps,
            remat=args.remat,
            zero_dp_shard=args.zero_dp_shard,
            sync_precision=args.sync_precision,
            sync_schedule=args.sync_schedule,
            sync_bucket_bytes=args.sync_bucket_bytes,
            co_search=args.co_search,
            sync_ef=args.sync_ef,
            objective=args.objective,
            serve_p99_budget_ms=args.serve_p99_budget_ms,
            serve_disaggregation=args.serve_disaggregation,
            serve_fleet=args.serve_fleet,
            serve_fleet_max_replicas=args.serve_fleet_max_replicas,
            prefill_chunk=args.prefill_chunk,
            serve_slo_classes=args.serve_slo_classes,
            kv_precision=args.kv_precision,
            serve_shared_prefix_pages=args.serve_shared_prefix_pages,
            obs_log_file=args.obs_log,
            obs_trace_file=args.obs_trace,
            device_trace_dir=args.device_trace_dir,
            drift_threshold=args.drift_threshold,
            cost_cache_file="" if args.no_cost_cache else args.cost_cache_file,
            verify=args.verify,
            seed=args.seed,
        )
