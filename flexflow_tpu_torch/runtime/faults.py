"""Deterministic fault injection for the always-on training loop — a
copy of flexflow_tpu/runtime/faults.py.  The draws are the
reference's (``random.Random(seed)``, one per fault in schedule order),
so both packages fire the same faults at the same steps with the same
factors.

The controller's recovery story (runtime/controller.py) is only
testable if the faults themselves are reproducible: every injector
here is a pure function of the ``FaultPlan``'s seed + schedule, so two
runs with the same plan inject byte-identical failures at the same
steps — the property the end-to-end recovery tests assert.

Fault kinds (the four failure classes the controller recovers from):

* ``calibration_drift`` — the world changed under the cost model:
  scales every measured record of the persisted CalibrationTable by a
  seeded drift factor and marks the file stale (the same signal a
  measured DriftReport produces), so the controller's signature watch
  sees a rotation and triggers the warm re-search + hot swap.
* ``device_loss``       — preemption / elastic shrink: ``survivors``
  devices remain.  The controller re-searches for the surviving set
  and re-shards the live state onto the shrunken mesh.
* ``collective_failure``— a transient wire fault in the searched comm
  plan: raises ``TransientCollectiveError`` for ``failures``
  consecutive attempts at the armed step.  Bounded retry/backoff is
  the controller's job; when the fault outlives the retry budget the
  controller falls back to the monolithic fp32 sync path (which this
  injector, modeling a searched-plan-specific fault, does not touch).
* ``corrupt_checkpoint``— a torn write on shared storage: truncates
  the newest on-disk ``step_N`` snapshot so the next restore must
  detect the manifest mismatch and fall back to the newest complete
  step (runtime/checkpoint.py's completeness check).

Env-var spelling (documented in README "Fault tolerance"):

    FLEXFLOW_TPU_FAULTS="calibration_drift@3,device_loss@6:4"
    FLEXFLOW_TPU_FAULT_SEED=7

``kind@step[:arg]`` comma list — arg is ``survivors`` for device_loss
and ``failures`` for collective_failure.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from flexflow_tpu_torch.obs.flight import FLIGHT


def _post_mortem(fault: "Fault") -> None:
    """Every injection dumps the flight ring (last-N events + the
    in-flight requests' open spans) — the injected failure is exactly
    the rehearsal for the unplanned one, so it must exercise the
    post-mortem path too.  A no-op unless a dump dir is armed
    (``FLEXFLOW_TPU_FLIGHT_DIR`` / ``FLIGHT.configure``)."""
    FLIGHT.dump(reason=f"fault-{fault.kind}-step{fault.step}")


FAULT_KINDS = (
    "calibration_drift",
    "device_loss",
    "collective_failure",
    "corrupt_checkpoint",
    # the serving currency drifted: a seeded measured-p99 vs
    # searched-p99 ratio fed to the controller's observe_p99 watch —
    # past threshold it becomes a "p99_drift" re-search trigger
    "p99_drift",
)


class TransientCollectiveError(RuntimeError):
    """A collective in the searched comm plan failed; retryable."""


@dataclass
class Fault:
    kind: str
    step: int
    # kind-specific argument: survivors (device_loss), failures
    # (collective_failure); unused otherwise
    arg: Optional[int] = None
    fired: bool = False

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} "
                f"(must be one of {FAULT_KINDS})")
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if (self.kind in ("collective_failure", "device_loss")
                and self.arg is not None and self.arg < 1):
            # a zero failure budget / zero survivors would be accepted
            # and then silently never fire (or blow up mid-run) — a
            # recovery test built on such a plan would test nothing
            raise ValueError(
                f"{self.kind} arg must be >= 1, got {self.arg}")


@dataclass
class FaultPlan:
    """A seeded, ordered fault schedule.  ``due(step)`` hands out the
    faults armed for that step (once each); the kind-specific helpers
    below actually inject them."""

    faults: List[Fault] = field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        # the drift factors are PRE-DRAWN from the seed at construction
        # (one per fault, in schedule order): injection order can then
        # never perturb determinism, and Date-free replays are exact
        rng = random.Random(self.seed)
        self._draws = {
            id(f): 1.5 + rng.random() * 2.0 for f in self.faults
        }
        # collective_failure remaining-attempt counters
        self._remaining: Dict[int, int] = {
            id(f): (f.arg if f.arg is not None else 1)
            for f in self.faults if f.kind == "collective_failure"
        }

    @staticmethod
    def parse(spec: str, seed: int = 0) -> "FaultPlan":
        """``kind@step[:arg]`` comma list -> FaultPlan."""
        faults = []
        for part in (p.strip() for p in spec.split(",")):
            if not part:
                continue
            if "@" not in part:
                raise ValueError(
                    f"fault {part!r} must be kind@step[:arg]")
            kind, rest = part.split("@", 1)
            arg: Optional[int] = None
            if ":" in rest:
                step_s, arg_s = rest.split(":", 1)
                arg = int(arg_s)
            else:
                step_s = rest
            faults.append(Fault(kind=kind.strip(), step=int(step_s),
                                arg=arg))
        return FaultPlan(faults=faults, seed=seed)

    @staticmethod
    def from_env() -> Optional["FaultPlan"]:
        """FLEXFLOW_TPU_FAULTS / FLEXFLOW_TPU_FAULT_SEED, or None."""
        spec = os.environ.get("FLEXFLOW_TPU_FAULTS", "")
        if not spec:
            return None
        return FaultPlan.parse(
            spec, seed=int(os.environ.get("FLEXFLOW_TPU_FAULT_SEED", "0")))

    # ------------------------------------------------------------------
    def due(self, step: int) -> List[Fault]:
        """Unfired faults scheduled at ``step`` (collective failures
        stay live until their attempt budget drains)."""
        out = []
        for f in self.faults:
            if f.step != step:
                continue
            if f.kind == "collective_failure":
                if self._remaining.get(id(f), 0) > 0:
                    out.append(f)
            elif not f.fired:
                out.append(f)
        return out

    # ---- injectors ----------------------------------------------------
    def inject_calibration_drift(self, fault: Fault,
                                 calibration_file: str) -> float:
        """Scale every measured record by the fault's seeded factor and
        mark the table stale in place.  Returns the factor applied (the
        drift ratio a DriftReport would have reported)."""
        factor = self._draws[id(fault)]
        with open(calibration_file) as f:
            data = json.load(f)
        for row in data.get("records", []):
            row["seconds"] = float(row["seconds"]) * factor
        for row in data.get("clusters", []):
            row["seconds"] = float(row["seconds"]) * factor
        data["stale"] = True
        data["stale_ratio"] = factor
        with open(calibration_file, "w") as f:
            json.dump(data, f, indent=1)
        fault.fired = True
        _post_mortem(fault)
        return factor

    def inject_p99_drift(self, fault: Fault) -> float:
        """The measured serving p99 drifted off the searched
        prediction: returns the seeded measured/predicted ratio
        (1.5x–3.5x — always past the default 0.5 drift threshold, so a
        scheduled p99_drift fault deterministically trips the
        controller's observe_p99 watch)."""
        fault.fired = True
        _post_mortem(fault)
        return self._draws[id(fault)]

    def inject_device_loss(self, fault: Fault, num_devices: int) -> int:
        """Surviving device count after the loss (>= 1)."""
        fault.fired = True
        survivors = fault.arg if fault.arg is not None else max(
            1, num_devices // 2)
        if not 1 <= survivors <= num_devices:
            raise ValueError(
                f"device_loss survivors={survivors} not in "
                f"[1, {num_devices}]")
        _post_mortem(fault)
        return survivors

    def check_collective(self, fault: Fault) -> None:
        """One attempt at the armed step: raises while the fault's
        failure budget lasts, then lets the step through.  The caller
        passes only faults whose searched comm plan is still live —
        after the monolithic fp32 fallback this is not consulted."""
        rem = self._remaining.get(id(fault), 0)
        if rem > 0:
            self._remaining[id(fault)] = rem - 1
            _post_mortem(fault)
            raise TransientCollectiveError(
                f"injected collective failure at step {fault.step} "
                f"({rem - 1} failure(s) remaining)")
        fault.fired = True

    def neutralize(self, fault: Fault) -> None:
        """Retire a collective fault: the monolithic fp32 fallback
        removed the comm path the fault models, so its remaining
        failure budget is void."""
        self._remaining[id(fault)] = 0
        fault.fired = True

    def inject_corrupt_checkpoint(self, fault: Fault,
                                  directory: str) -> Optional[str]:
        """Truncate the newest ``step_N`` snapshot (drop the payload
        behind the manifest) — the torn-write case restore must detect.
        Returns the corrupted path, or None when nothing exists."""
        fault.fired = True
        _post_mortem(fault)
        from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

        mgr = CheckpointManager(directory)
        step = mgr.latest_step()
        if step is None:
            return None
        path = mgr._step_dir(step)
        for name in ("arrays.npz", "tree"):
            victim = os.path.join(path, name)
            if os.path.isfile(victim):
                with open(victim, "r+b") as f:
                    f.truncate(max(0, os.path.getsize(victim) // 2))
            elif os.path.isdir(victim):
                import shutil

                shutil.rmtree(victim)
        return path
