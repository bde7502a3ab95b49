"""Always-on training controller — the port of
flexflow_tpu/runtime/controller.py: the loop that KEEPS the best
parallelization instead of finding it once.

It composes what the port already has: drift reports
(``obs/drift.py``), a warm re-search served from the persistent caches
(``search/driver.py``), the legality gates on every served strategy
(``analysis``), the hot swap (``FFModel.swap_strategy``) and the
checkpoint format (``runtime/checkpoint.py``):

* **drift → live re-search → hot swap**: it watches the calibration
  signature (content digest of the persisted ``CalibrationTable``), the
  measured-vs-predicted step drift, a serving p99 feed, SLO burn rates
  and device-trace lane reports; a trigger re-searches for the current
  cost surface and hot-swaps the strategy BETWEEN steps.
* **elastic meshes**: on device loss it rebuilds the FFConfig for the
  surviving ranks (``shrink_config``), re-searches, and re-homes the
  whole training state onto them.
* **transient faults**: collective failures retry with bounded backoff;
  one that outlives the retry budget degrades to the monolithic fp32
  sync path instead of killing the run.
* **torn checkpoints**: a corrupted ``step_N`` triggers a restore drill
  that falls back to the newest complete snapshot and replays
  deterministically (the rng counter rides the checkpoint).

Faults come from a seeded ``runtime.faults.FaultPlan`` (or the
``FLEXFLOW_TPU_FAULTS`` variable), so every recovery path replays
exactly under a fixed fault seed.

Where the port departs from the reference: a job runs one process per
rank, so every rank runs the controller on its blocks, and the loop
keeps the ranks in step.  Rank 0 of the model's mesh decides every
step's re-search triggers (it alone watches the calibration file and
the step-time drift, and writes the injected drift and the torn
snapshot) and sends them to the other ranks; rank 0 searches and sends
its (graph, strategy) to every rank, as ``compile(strategy=None)``
does.  On device loss every rank takes part in building the survivors'
mesh (``runtime.distributed.mesh_over``: ``dist.new_group`` is
collective over the whole job) and in the swap's snapshot; then the
ranks the shrink leaves out drop their program (``model.compiled`` is
None) and ``run`` returns on them with the history so far.  The loop
advances ``model._rng_counter`` once per step and hands it to
``compiled.train_step`` as the step seed (the train step reads no
counter), as the reference's ``run`` and the port's ``fit`` do.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.obs.events import BUS
from flexflow_tpu_torch.obs.flight import FLIGHT
from flexflow_tpu_torch.obs.tracing import TRACER
from flexflow_tpu_torch.runtime.faults import (
    FaultPlan,
    TransientCollectiveError,
)


def shrink_config(config, num_devices: int):
    """An FFConfig for the surviving ranks: same knobs, the machine model
    re-sized without changing WHAT machine it describes (the platform
    especially: ``driver.coherent_calibration`` keys on it).  The
    default family (``h100_sxm`` at the config's size) is re-derived, a
    ``host_cpu`` spec rebuilt at the new size (its constants scale with
    the count), any other spec keeps its constants and shrinks its
    count.  The reference's ``force_cpu_devices`` slice of the devices
    has no field here: a port job's devices are its ranks, and a config
    of ``num_devices`` below the job's lowers on the ranks
    ``[0, num_devices)`` (``FFModel.swap_strategy``,
    ``parallel.mesh.Mesh(start=0, width=num_devices)``)."""
    import dataclasses

    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.machine import MachineSpec

    kw = {f.name: getattr(config, f.name)
          for f in dataclasses.fields(FFConfig)}
    kw["num_devices"] = num_devices
    kw["search_num_devices"] = 0
    spec = config.machine_spec
    if spec is None or spec == MachineSpec.h100_sxm(config.num_devices):
        kw["machine_spec"] = None  # the default family: re-derive
    elif spec == MachineSpec.host_cpu(config.num_devices):
        kw["machine_spec"] = MachineSpec.host_cpu(num_devices)
    else:
        kw["machine_spec"] = dataclasses.replace(
            spec, num_devices=num_devices, ici_torus=())
    return FFConfig(**kw)


class TrainingController:
    """Drive a compiled FFModel's training steps under the always-on
    policy above (every rank of the model's job runs one).

    >>> ctl = TrainingController(model, faults=plan,
    ...                          checkpoint_dir="/ckpt")
    >>> out = ctl.run(x, y, steps=20)
    >>> out["history"][-1]["loss"], ctl.stats["swaps"]
    """

    def __init__(self, model, faults: Optional[FaultPlan] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, max_retries: int = 2,
                 backoff_s: float = 0.0, drift_check_every: int = 1,
                 drift_window: int = 4, verbose: bool = False):
        assert model.compiled is not None, "compile() the model first"
        self.model = model
        self.faults = faults if faults is not None else FaultPlan.from_env()
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.drift_check_every = max(1, drift_check_every)
        self.drift_window = max(2, drift_window)
        self.verbose = verbose
        self.stats: Dict[str, object] = {
            "steps": 0, "swaps": 0, "recoveries": 0, "retries": 0,
            "fallbacks": 0, "restores": 0,
            "swap_seconds": [], "research_seconds": [],
            "research_warm": [], "research_detail": [],
            "restore_seconds": [],
        }
        self.history: List[dict] = []
        self._step_times: List[float] = []
        self._armed_collective = None
        # measured-drift triggers, consumed at the next step boundary
        self._p99_trigger: Optional[float] = None
        self._fleet_trigger: Optional[float] = None
        self._burn_trigger: Optional[str] = None
        self._lane_trigger: Optional[str] = None
        self._lane_seen = None
        self._ckpt_mgr = None
        if checkpoint_dir is not None:
            from flexflow_tpu_torch.runtime.checkpoint import (
                CheckpointManager,
            )

            self._ckpt_mgr = CheckpointManager(checkpoint_dir)

    # -- keeping the ranks in step -----------------------------------------
    def _mesh(self):
        return self.model.compiled.mesh

    def _lead(self) -> bool:
        """True on rank 0 of the model's mesh (the job's rank 0 in one
        process)."""
        m = self._mesh()
        return m.rank == m.start

    def _group(self):
        m = self._mesh()
        if m.world == 1:
            return None
        return m.group(m.names)

    def _agree(self, obj):
        """Rank 0's ``obj`` on every rank of the model's mesh."""
        group = self._group()
        if group is None:
            return obj
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, src=self._mesh().start, group=group)
        return box[0]

    def _barrier(self) -> None:
        group = self._group()
        if group is not None:
            import torch.distributed as dist

            dist.barrier(group=group)

    # -- calibration-signature watch ------------------------------------
    def _live_cal_state(self) -> Tuple[Optional[str], bool]:
        """(content digest, stale flag) of the persisted calibration
        table — the signature whose rotation triggers the live
        re-search; (None, False) when no table is configured.  An
        unchanged file is answered from an os.stat fast path."""
        path = self.model.config.calibration_file
        if not path or not os.path.exists(path):
            return None, False
        st = os.stat(path)
        stat_sig = (st.st_mtime_ns, st.st_size)
        cached = getattr(self, "_cal_stat_cache", None)
        if cached is not None and cached[0] == stat_sig:
            return cached[1]
        try:
            from flexflow_tpu_torch.search.calibration import (
                CalibrationTable,
            )
            from flexflow_tpu_torch.search.cost_cache import (
                calibration_digest,
            )

            table = CalibrationTable.load(path)
        except (OSError, ValueError, KeyError, TypeError):
            # malformed rows must not kill the training hot loop
            return None, False
        state = (calibration_digest(table), bool(table.stale))
        self._cal_stat_cache = (stat_sig, state)
        return state

    # -- measured-drift feeds (serving p99 + device-trace lanes) ---------
    def observe_p99(self, measured_s: float,
                    predicted_s: Optional[float] = None,
                    step: Optional[int] = None) -> Optional[float]:
        """Feed a measured serving p99 (e.g.
        ``ContinuousBatchingExecutor.measured_p99(window)``) against
        the searched prediction.  Emits ``controller.p99_drift``;
        drifted past the model's drift threshold, the next step
        boundary re-searches with trigger ``"p99_drift"``.  Returns
        the measured/predicted ratio (None when either side is
        missing)."""
        pred = predicted_s
        if pred is None:
            pred = (getattr(self.model, "predicted_breakdown", None)
                    or {}).get("total_s")
        if (not pred or not math.isfinite(pred) or not measured_s
                or not math.isfinite(measured_s)):
            return None
        ratio = measured_s / pred
        thr = self.model.config.drift_threshold
        drifted = ratio > 1.0 + thr or ratio < 1.0 / (1.0 + thr)
        BUS.emit("controller.p99_drift",
                 step=step if step is not None else self.stats["steps"],
                 ratio=ratio, drifted=drifted, predicted_s=pred,
                 measured_s=measured_s, threshold=thr)
        if drifted:
            self._p99_trigger = ratio
        return ratio

    def observe_burn_rate(self, source, targets: Optional[Dict[str, float]] = None,
                          metric: str = "ttft_s",
                          budgets: Optional[Dict[str, float]] = None,
                          fast: int = 8, slow: int = 32,
                          fire: float = 2.0,
                          step: Optional[int] = None) -> Optional[Dict[str, dict]]:
        """Feed an executor/fleet's finished-request records through the
        multi-window SLO burn-rate computer (obs/slo.py): per class,
        the violation fraction of the trailing fast and slow completion
        windows over the class's error budget.  ``targets`` defaults to
        the live fleet proposal's per-class p99 predictions
        (``model.fleet.per_class_p99_s``); ``budgets`` default to
        ``1 - quantile`` per SLOClass when the source carries a class
        table.  One ``controller.burn_rate`` event per class; any class
        burning past ``fire`` on BOTH windows arms a ``"burn_rate"``
        re-search at the next step boundary — an EARLIER trigger than
        ``observe_p99``: a persistent moderate violation (say every
        request at 1.3x target) torches the budget while the raw p99
        stays under the 1.5x drift threshold forever.  Returns the
        per-class burn map (None when nothing was comparable)."""
        from flexflow_tpu_torch.obs.slo import burn_rates

        if targets is None:
            prop = getattr(self.model, "fleet", None)
            if prop is None:
                return None
            targets = dict(prop.per_class_p99_s)
        targets = {k: v for k, v in targets.items()
                   if v and math.isfinite(v)}
        if not targets:
            return None
        if budgets is None:
            classes = getattr(source, "slo_classes", None) or {}
            budgets = {name: max(1.0 - cls.quantile, 1e-4)
                       for name, cls in classes.items()
                       if name in targets}
        records = getattr(source, "request_records", source)
        rates = burn_rates(records, targets, metric=metric,
                           budgets=budgets, fast=fast, slow=slow,
                           fire=fire)
        step = step if step is not None else self.stats["steps"]
        fired = None
        for name, row in sorted(rates.items()):
            BUS.emit("controller.burn_rate", step=step, slo=name,
                     fast=row["fast"], slow=row["slow"],
                     fired=row["fired"], target_s=row["target_s"],
                     budget=row["budget"],
                     completions=row["completions"])
            if row["fired"]:
                fired = name if fired is None else f"{fired},{name}"
        if fired is not None:
            self._burn_trigger = fired
        return rates or None

    def observe_fleet(self, fleet, proposal=None, metric: str = "ttft_s",
                      window: int = 0,
                      step: Optional[int] = None) -> Optional[Dict[str, float]]:
        """Feed a ``FleetExecutor``'s measured per-class p99 windows
        against a fleet proposal's predictions (``per_class_p99_s``,
        search/fleet.py).  One ``controller.p99_drift`` event per
        class (tagged ``slo=``); any class past the model's drift
        threshold arms a FLEET re-search with the worst
        measured/predicted ratio as its load scale — consumed by
        ``maybe_refleet`` (or directly ``research_fleet``), which can
        re-size N.  Returns the per-class ratio map (None when nothing
        was comparable)."""
        prop = proposal if proposal is not None \
            else getattr(self.model, "fleet", None)
        if prop is None:
            return None
        thr = self.model.config.drift_threshold
        ratios: Dict[str, float] = {}
        worst = None
        for name, pred in sorted(prop.per_class_p99_s.items()):
            if not pred or not math.isfinite(pred):
                continue
            measured = fleet.measured_request_p99(metric, slo=name,
                                                  window=window)
            if not measured or not math.isfinite(measured):
                continue
            ratio = measured / pred
            ratios[name] = ratio
            drifted = ratio > 1.0 + thr or ratio < 1.0 / (1.0 + thr)
            BUS.emit("controller.p99_drift",
                     step=step if step is not None
                     else self.stats["steps"],
                     ratio=ratio, drifted=drifted, predicted_s=pred,
                     measured_s=measured, threshold=thr, slo=name)
            if drifted:
                worst = ratio if worst is None else max(worst, ratio)
        if worst is not None:
            self._fleet_trigger = worst
        return ratios or None

    def research_fleet(self, step: Optional[int] = None,
                       load_scale: Optional[float] = None,
                       proposal=None):
        """Re-run the fleet search with the measured drift folded into
        the offered load (``propose_fleet(load_scale=)``) — the
        elastic re-size: a saturated fleet's re-search shifts the
        optimum toward more replicas, a lightly-loaded one toward
        fewer.  Hot-applies the new proposal onto ``model.fleet`` (the
        same slot the compile-time search fills; callers rebuild their
        ``FleetExecutor`` from it) and emits ``fleet.scale``.  The
        load scale is clamped to [1, 8] so a pathological measured
        window cannot demand an unpriceable load."""
        from flexflow_tpu_torch.search.driver import coherent_calibration
        from flexflow_tpu_torch.search.fleet import propose_fleet

        prop = proposal if proposal is not None \
            else getattr(self.model, "fleet", None)
        scale = load_scale if load_scale is not None \
            else (self._fleet_trigger or 1.0)
        self._fleet_trigger = None
        scale = min(8.0, max(1.0, float(scale)))
        step = step if step is not None else self.stats["steps"]
        tid = None
        if TRACER.enabled:
            tid = TRACER.episode_root(trigger="fleet_drift", step=step)
            TRACER.begin(tid, "refleet", parent="controller.episode",
                         load_scale=round(scale, 4))
        new = propose_fleet(
            self.model.graph, self.model.strategy, self.model.config,
            calibration=coherent_calibration(self.model.config),
            base_graph=getattr(self.model, "fleet_base_graph", None),
            load_scale=scale)
        old_n = len(prop.replicas) if prop is not None else 1
        new_n = len(new.replicas) if new is not None else old_n
        if tid is not None:
            TRACER.end(tid, "refleet", to_replicas=new_n)
            TRACER.finish_trace(tid, outcome="applied"
                                if new is not None else "kept")
        BUS.emit("fleet.scale", step=step, from_replicas=old_n,
                 to_replicas=new_n, load_scale=round(scale, 6),
                 resized=new_n != old_n)
        self.stats["fleet_scales"] = \
            int(self.stats.get("fleet_scales", 0)) + 1
        if self.verbose:
            print(f"[controller] fleet re-search at load x{scale:.2f}: "
                  f"{old_n} -> {new_n} replicas")
        if new is not None:
            self.model.fleet = new
        return new

    def maybe_refleet(self, step: Optional[int] = None):
        """Consume a pending fleet drift trigger (armed by
        ``observe_fleet``): re-search and hot-apply, or None when no
        drift is pending — the idempotent per-step hook a serving loop
        calls next to ``step()``."""
        if self._fleet_trigger is None:
            return None
        return self.research_fleet(step=step)

    def observe_lane_drift(self, lane_report) -> None:
        """Feed a matched ``LaneDriftReport`` (obs/trace_ingest.py);
        any stale lane arms a ``"lane_drift"`` re-search at the next
        step boundary.  ``_watch_drift`` also consumes a fresh
        ``model.lane_drift_report`` automatically."""
        if lane_report is None or lane_report is self._lane_seen:
            return
        self._lane_seen = lane_report
        stale = lane_report.stale_lanes
        if stale:
            self._lane_trigger = ",".join(stale[:4])

    def _watch_drift(self, step: int) -> None:
        """The controller's own per-phase DriftReport: measured mean of
        the trailing step window vs the compile-time prediction.  On
        calibration staleness it marks the persisted table + cost cache
        exactly like ``model._report_profile`` — the next signature
        check then sees the rotation and re-searches."""
        # a device-trace lane report the model's fit produced since the
        # last check rides the same watch (per-lane drift is a sharper
        # signal than the aggregate step ratio: it names WHICH comm
        # lane the cost model mispriced)
        self.observe_lane_drift(
            getattr(self.model, "lane_drift_report", None))
        pred = getattr(self.model, "predicted_breakdown", None)
        window = self._step_times[1:]  # step 0 pays compile
        if (not pred or not pred.get("calibrated")
                or len(window) < self.drift_window):
            return
        from flexflow_tpu_torch.obs.drift import build_drift_report

        measured = sum(window[-self.drift_window:]) / self.drift_window
        report = build_drift_report(
            pred, measured_step_s=measured,
            threshold=self.model.config.drift_threshold, calibrated=True)
        if report is None:
            return
        BUS.emit("drift.report", phase=f"step_{step}", **report.to_dict())
        if not report.calibration_stale:
            return
        cfg = self.model.config
        if cfg.calibration_file:
            from flexflow_tpu_torch.search.calibration import CalibrationTable

            CalibrationTable.mark_stale_file(
                cfg.calibration_file, report.ratio)
        from flexflow_tpu_torch.search.cost_cache import (
            mark_calibration_stale,
            resolve_cost_cache_path,
        )

        cache_path = resolve_cost_cache_path(cfg)
        if cache_path:
            mark_calibration_stale(cache_path)

    # -- re-search + swap ------------------------------------------------
    def _search(self, config):
        """Rank 0's search: (graph or None for the live one, strategy,
        the searches' stats, whether it degraded to data parallelism)."""
        from flexflow_tpu_torch import analysis
        from flexflow_tpu_torch.search import driver as _driver

        new_graph, strategy = _driver.optimize_strategy(
            self.model.graph, config, return_graph=True)
        episodes = [dict(_driver.LAST_SEARCH_STATS)]
        dp_fallback = False
        if analysis.errors_only(analysis.lint_swap(
                self.model.graph, new_graph, strategy, config.num_devices)):
            new_graph = self.model.graph
            if new_graph.num_nodes > _driver.CHAIN_MIN_NODES:
                # a strategy-only search past the chain threshold falls
                # into the flat whole-graph DP: a LIVE run degrades to
                # plain data parallelism, always legal and swappable
                from flexflow_tpu_torch.compiler.lowering import (
                    data_parallel_strategy,
                )

                strategy = data_parallel_strategy(new_graph,
                                                  config.num_devices)
                dp_fallback = True
            else:
                strategy = _driver.optimize_strategy(
                    self.model.graph, config, return_graph=False)
                episodes.append(dict(_driver.LAST_SEARCH_STATS))
        same = new_graph is self.model.graph
        return (None if same else new_graph), strategy, episodes, dp_fallback

    def _research(self, config, trigger: str, step: int):
        """Warm re-search for the current graph under ``config`` (on rank
        0, its result sent to every rank); the result must pass the
        swap gate against the LIVE state, else the search falls back to
        strategy-only on the current graph."""
        from flexflow_tpu_torch.compiler.graphs import COUNTED

        t0 = time.perf_counter()
        # a re-probe of a stale calibration table launches the kernels
        # outside any step: counted apart from the steps' launches
        launched = [w.launches for w in COUNTED]
        got = None
        if self._lead():
            try:
                got = {"result": self._search(config)}
            except Exception as e:
                if self._group() is None:
                    raise
                # every rank raises rank 0's error, none waits for it
                got = {"error": RuntimeError(
                    f"rank 0's re-search raised {type(e).__name__}: {e}")}
        got = self._agree(got)
        if "error" in got:
            raise got["error"]
        new_graph, strategy, episodes, dp_fallback = got["result"]
        if new_graph is None:
            new_graph = self.model.graph
        seconds = time.perf_counter() - t0
        # the episode may span TWO searches: sum their seconds, and call
        # it warm only when every search was cache-served
        search_s = sum(float(e.get("search_seconds") or 0.0)
                       for e in episodes)
        cal_s = sum(float(e.get("calibration_seconds") or 0.0)
                    for e in episodes)
        warm = all(bool(e.get("result_cache_hit")) for e in episodes)
        self.stats["research_seconds"].append(seconds)
        self.stats["research_warm"].append(warm)
        self.stats["research_detail"].append({
            "wall_s": seconds, "trigger": trigger, "warm": warm,
            "search_s": search_s, "calibration_s": cal_s,
            "searches": len(episodes), "dp_fallback": dp_fallback,
            "launches": {w.__name__: w.launches - b
                         for w, b in zip(COUNTED, launched)},
        })
        BUS.emit("controller.research", step=step, trigger=trigger,
                 search_seconds=search_s, calibration_seconds=cal_s,
                 wall_s=seconds, warm=warm, nodes=new_graph.num_nodes)
        if self.verbose:
            print(f"# controller: re-search ({trigger}) at step {step}: "
                  f"{search_s:.3f}s search + {cal_s:.3f}s re-probe "
                  f"({seconds:.3f}s wall){' warm' if warm else ''}")
        return new_graph, strategy

    def _swap(self, step: int, strategy, graph=None, config=None) -> dict:
        report = self.model.swap_strategy(strategy, graph=graph,
                                          config=config)
        # measured step times describe the PREVIOUS program
        self._step_times = []
        self.stats["swaps"] += 1
        self.stats["swap_seconds"].append(report["swap_seconds"])
        if report["fallback"]:
            self.stats["fallbacks"] += 1
        BUS.emit("controller.swap", step=step,
                 swap_seconds=report["swap_seconds"],
                 fallback=report["fallback"],
                 fresh=len(report["fresh"]),
                 dropped=len(report["dropped"]))
        if self.verbose:
            print(f"# controller: hot swap at step {step} in "
                  f"{report['swap_seconds']:.3f}s"
                  + (" (fp32 monolithic fallback)"
                     if report["fallback"] else ""))
        return report

    def _research_and_swap(self, step: int, trigger: str,
                           config=None) -> None:
        cfg = config if config is not None else self.model.config
        tid = None
        if TRACER.enabled:
            tid = TRACER.episode_root(trigger=trigger, step=step)
            TRACER.begin(tid, "research", parent="controller.episode")
        new_graph, strategy = self._research(cfg, trigger, step)
        if tid is not None:
            TRACER.end(tid, "research")
            TRACER.begin(tid, "swap", parent="controller.episode")
        self._swap(step, strategy,
                   graph=new_graph if new_graph is not self.model.graph
                   else None,
                   config=config)
        if tid is not None:
            TRACER.end(tid, "swap")
            TRACER.finish_trace(tid, outcome="applied")
        if self.model.compiled is not None:
            self._cal_state = self._live_cal_state()

    def _monolithic_fallback(self, step: int, reason: str) -> None:
        """Degrade to the monolithic fp32 sync path: the searched comm
        plan (schedule, precision, ZeRO groups) is dropped and the SAME
        strategy re-lowers."""
        cfg = self.model.config
        cfg.sync_schedule = "off"
        cfg.sync_precision = "fp32"
        cfg.co_search = False
        cfg.sync_ef = "off"
        self.model.zero_groups = ()
        self.stats["fallbacks"] += 1
        BUS.emit("controller.fallback", step=step, reason=reason)
        FLIGHT.dump(reason=f"controller-fallback-step{step}")
        if self.verbose:
            print(f"# controller: falling back to monolithic fp32 sync "
                  f"at step {step} ({reason})")
        self._swap(step, self.model.strategy)
        if self._armed_collective is not None:
            self.faults.neutralize(self._armed_collective)
            self._armed_collective = None

    # -- fault handling ----------------------------------------------------
    def _handle_faults(self, step: int) -> Optional[int]:
        """Inject and recover every fault due at ``step``.  Returns a
        rewound step to resume from (the restore drill), else None."""
        resume_at = None
        for fault in (self.faults.due(step) if self.faults else ()):
            BUS.emit("fault.injected", fault=fault.kind, step=step,
                     arg=fault.arg)
            if self.verbose:
                print(f"# controller: fault {fault.kind} at step {step}")
            if fault.kind == "calibration_drift":
                path = self.model.config.calibration_file
                if path and os.path.exists(path) and self._lead():
                    self.faults.inject_calibration_drift(fault, path)
                else:
                    fault.fired = True
            elif fault.kind == "device_loss":
                survivors = self.faults.inject_device_loss(
                    fault, self.model.config.num_devices)
                cfg = shrink_config(self.model.config, survivors)
                self._research_and_swap(step, "device_loss", config=cfg)
                self.stats["recoveries"] += 1
                BUS.emit("controller.recovery", step=step,
                         cause="device_loss", devices=survivors)
                if self.model.compiled is None:
                    return None  # this rank was lost
            elif fault.kind == "p99_drift":
                ratio = self.faults.inject_p99_drift(fault)
                pred = (getattr(self.model, "predicted_breakdown", None)
                        or {}).get("total_s")
                if pred and math.isfinite(pred):
                    self.observe_p99(pred * ratio, predicted_s=pred,
                                     step=step)
            elif fault.kind == "collective_failure":
                self._armed_collective = fault
            elif fault.kind == "corrupt_checkpoint":
                if self._ckpt_mgr is not None:
                    if self._lead():
                        self.faults.inject_corrupt_checkpoint(
                            fault, self.checkpoint_dir)
                    else:
                        fault.fired = True
                    self._barrier()  # the torn snapshot, seen by all
                    t0 = time.perf_counter()
                    try:
                        restored = self._ckpt_mgr.restore(self.model)
                    except (FileNotFoundError, ValueError) as e:
                        # nothing complete to rewind to: the LIVE state
                        # is intact, so the run continues
                        BUS.emit("controller.fallback", step=step,
                                 reason=f"restore drill skipped: {e}")
                        if self.verbose:
                            print(f"# controller: no complete snapshot "
                                  f"to rewind to at step {step}; "
                                  f"continuing on live state")
                    else:
                        self.stats["recoveries"] += 1
                        self.stats["restores"] += 1
                        self.stats["restore_seconds"].append(
                            time.perf_counter() - t0)
                        BUS.emit("controller.recovery", step=step,
                                 cause="checkpoint",
                                 restored_step=restored)
                        resume_at = restored + 1
                else:
                    fault.fired = True
        return resume_at

    def _triggers(self, step: int) -> List[str]:
        """This step boundary's re-search triggers, in the reference's
        order (rank 0's, on every rank): the calibration signature, the
        SLO burn rate (which consumes a p99 trigger armed with it), the
        p99 drift, the lane drift."""
        out: List[str] = []
        if self._lead() and step % self.drift_check_every == 0:
            self._watch_drift(step)
            if self._live_cal_state() != self._cal_state:
                out.append("calibration_drift")
        if self._burn_trigger is not None:
            out.append("burn_rate")
        elif self._p99_trigger is not None:
            out.append("p99_drift")
        if self._lane_trigger is not None:
            out.append("lane_drift")
        self._burn_trigger = self._p99_trigger = self._lane_trigger = None
        return self._agree(out)

    def _batch(self, xs, y, idx):
        """This rank's blocks of batch ``idx``, on the model's device."""
        c = self.model.compiled

        def put(a, sl):
            return torch.from_numpy(np.ascontiguousarray(a[sl])).to(
                c.device)

        inputs = [put(a[idx], c.input_slices(i, a[idx].shape))
                  for i, a in enumerate(xs)]
        return inputs, put(y[idx], c.label_slices(y[idx].shape))

    # -- the loop ----------------------------------------------------------
    def run(self, x, y, steps: int,
            batch_size: Optional[int] = None) -> dict:
        """Run ``steps`` optimizer steps over (x, y) in deterministic
        sequential batches (no shuffle: recovery replay and the
        bit-exactness oracles need byte-identical batch streams).  On a
        rank that a device loss leaves out, returns at that step."""
        model = self.model
        cfg = model.config
        if cfg.comp_mode != "training":
            raise RuntimeError("controller drives training models only")
        bs = batch_size or cfg.batch_size
        xs = [np.asarray(a)
              for a in (x if isinstance(x, (list, tuple)) else [x])]
        y = np.asarray(y)
        num_batches = len(y) // bs
        if num_batches == 0:
            raise ValueError(
                f"no full batch: {len(y)} samples < batch_size {bs}")
        self._cal_state = self._live_cal_state()
        step = 0
        while step < steps:
            resume_at = self._handle_faults(step)
            if model.compiled is None:
                break  # lost to a device loss
            if resume_at is not None:
                # the restore drill rewound the run; history past the
                # restored step is replayed deterministically
                self.history = [h for h in self.history
                                if h["step"] < resume_at]
                step = resume_at
                continue
            for trigger in self._triggers(step):
                self._research_and_swap(step, trigger)
            b = step % num_batches
            idx = slice(b * bs, (b + 1) * bs)
            model._rng_counter += 1
            seed = model._rng_counter
            t0 = time.perf_counter()
            attempt = 0
            while True:
                # (re)place the batch each attempt: a fallback swap
                # re-lowers, and the batch must land under the CURRENT
                # program's layout
                inputs, labels = self._batch(xs, y, idx)
                try:
                    if self._armed_collective is not None:
                        self.faults.check_collective(
                            self._armed_collective)
                    (model.params, model.opt_state, model.state, loss,
                     _metrics) = model.compiled.train_step(
                        model.params, model.opt_state, model.state,
                        inputs, labels, seed=seed)
                    loss = float(loss)
                    break
                except TransientCollectiveError as e:
                    attempt += 1
                    self.stats["retries"] += 1
                    BUS.emit("controller.retry", step=step,
                             attempt=attempt, backoff_s=self.backoff_s)
                    if attempt > self.max_retries:
                        self._monolithic_fallback(step, str(e))
                        continue
                    if self.backoff_s:
                        time.sleep(self.backoff_s * attempt)
            self._armed_collective = None
            if attempt == 0:
                # a retried step's wall time includes the failed
                # attempts: it must not feed the drift watch
                self._step_times.append(time.perf_counter() - t0)
            self.stats["steps"] = int(self.stats["steps"]) + 1
            self.history.append({"step": step, "loss": loss})
            if (self._ckpt_mgr is not None and self.checkpoint_every
                    and (step + 1) % self.checkpoint_every == 0):
                self._ckpt_mgr.save(step, model)
            if self.verbose:
                print(f"# controller: step {step} loss={loss:.4f}")
            step += 1
        if not all(math.isfinite(h["loss"]) for h in self.history):
            # a swapped run must not quietly report a NaN trajectory
            BUS.emit("controller.fallback", step=steps,
                     reason="non-finite loss in history")
        BUS.emit("controller.summary", steps=self.stats["steps"],
                 swaps=self.stats["swaps"],
                 recoveries=self.stats["recoveries"],
                 retries=self.stats["retries"],
                 fallbacks=self.stats["fallbacks"])
        BUS.flush()
        return {"history": list(self.history), "stats": dict(self.stats)}
