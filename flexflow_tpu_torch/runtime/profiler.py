"""Profiling — the port of flexflow_tpu/runtime/profiler.py.

* ``StepProfiler`` (a copy of the reference's): host wall time per
  step with the compile step left out, and named host phases within a
  step (``dispatch``/``wait`` in ``fit``) — the measured side of the
  obs ``DriftReport``.
* ``device_trace(logdir)``: a ``torch.profiler`` capture (CPU and CUDA
  activity on the card, CPU only for a model on the CPU) with the obs
  phase and lane annotations armed while it is live
  (obs/annotate.py), written as one Chrome-trace file per rank under
  ``logdir`` (``rank<r>.<ns>.pt.trace.json``), the file
  ``obs/trace_ingest.py`` reads.  A CUDA graph's replay appears in a
  CUDA capture kernel by kernel, under the range that launched it.
* ``measure_operator_cost`` times one forward of an op on the device
  its inputs live on, at whatever (per-shard) shapes the caller gives,
  and feeds ``search/calibration.py``'s ``CalibrationTable``, which the
  cost model consults before its roofline.  The reference runs the op
  N times inside one jitted ``lax.scan`` behind a host-scalar fence and
  differences two scan lengths; the port runs eagerly, so it times the
  op the way ``chip_smoke.py``'s ``time_ms`` times a kernel: on the
  card, each timed call runs between two CUDA events after the L2
  cache has been flushed (a 256 MB buffer zeroed) and the device has
  been kept busy for twice the time the host takes to issue the call's
  launches (an op is several kernels), so the window holds the
  device's time, not the host's dispatch; the median of ``repeats``
  calls is returned.  On the CPU the same calls are timed by the host
  clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

# bytes zeroed before each timed call on the card: well past the H100's
# 50 MB L2, as chip_smoke.py's flush buffer
FLUSH_BYTES = 256 << 20
# device cycles the card spins between the flush and the start event (at
# least), and the clock rate that turns a host time into cycles (the
# H100's top SM clock: a slower clock only spins longer)
SPIN_CYCLES = 200_000
SPIN_HZ = 1.98e9

_FLUSH: Dict[torch.device, torch.Tensor] = {}


class StepProfiler:
    """Wall-clock per-step timing with compile-step exclusion, plus
    named host-side phases within a step (``dispatch``/``wait`` in
    model.fit) — the measured side of the obs DriftReport."""

    def __init__(self):
        self.step_times: List[float] = []
        self.phase_times: Dict[str, List[float]] = {}
        self._t_last: Optional[float] = None
        self._phase_t0: Dict[str, float] = {}

    def start_step(self) -> None:
        self._t_last = time.perf_counter()

    def end_step(self) -> None:
        if self._t_last is not None:
            self.step_times.append(time.perf_counter() - self._t_last)
            self._t_last = None

    def start_phase(self, name: str) -> None:
        self._phase_t0[name] = time.perf_counter()

    def end_phase(self, name: str) -> None:
        t0 = self._phase_t0.pop(name, None)
        if t0 is not None:
            self.phase_times.setdefault(name, []).append(
                time.perf_counter() - t0)

    def summary(self, skip_first: int = 1) -> Dict[str, float]:
        """Stats excluding the first (compile) steps.  When every
        recorded step WOULD be skipped the stats still cover all steps
        but say so via ``includes_compile``."""
        kept = self.step_times[skip_first:]
        includes_compile = (
            not kept and bool(self.step_times) and skip_first > 0
        )
        ts = np.asarray(kept or self.step_times)
        if len(ts) == 0:
            return {"steps": 0}
        return {
            "steps": len(ts),
            "mean_s": float(ts.mean()),
            "p50_s": float(np.percentile(ts, 50)),
            "p95_s": float(np.percentile(ts, 95)),
            "max_s": float(ts.max()),
            "includes_compile": includes_compile,
        }

    def phase_summary(self, skip_first: int = 1
                      ) -> Dict[str, Dict[str, float]]:
        """Per-phase stats with the same compile-step exclusion (and
        the same ``includes_compile`` flag) as ``summary``."""
        out: Dict[str, Dict[str, float]] = {}
        for name, times in self.phase_times.items():
            kept = times[skip_first:]
            includes_compile = not kept and bool(times) and skip_first > 0
            ts = np.asarray(kept or times)
            if len(ts) == 0:
                continue
            out[name] = {
                "count": len(ts),
                "mean_s": float(ts.mean()),
                "total_s": float(ts.sum()),
                "includes_compile": includes_compile,
            }
        return out

    def __str__(self) -> str:
        s = self.summary()
        if not s.get("steps"):
            return "StepProfiler(no steps)"
        return (f"steps={s['steps']} mean={s['mean_s']*1e3:.2f}ms "
                f"p50={s['p50_s']*1e3:.2f}ms p95={s['p95_s']*1e3:.2f}ms")


class DeviceTrace:
    """A live ``device_trace`` capture; ``trace_file`` is the written
    Chrome-trace file once it has stopped."""

    def __init__(self, logdir: str, device="cuda"):
        from torch.profiler import ProfilerActivity, profile

        from flexflow_tpu_torch.runtime.distributed import rank

        self.logdir = logdir
        self.device = probe_device(device)
        self.worker = f"rank{rank()}"
        self.trace_file: Optional[str] = None
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def start(self) -> "DeviceTrace":
        from flexflow_tpu_torch.obs import annotate

        os.makedirs(self.logdir, exist_ok=True)
        self._prof.start()
        annotate.LANES.clear()
        annotate.arm()
        return self

    def stop(self) -> Optional[str]:
        """Disarm, wait for the device, stop and write the file."""
        from flexflow_tpu_torch.obs import annotate

        annotate.disarm()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        path = os.path.join(self.logdir, f"{self.worker}."
                            f"{time.time_ns()}.pt.trace.json")
        self._prof.export_chrome_trace(path)
        self.trace_file = path
        return path


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """A ``torch.profiler`` timeline of the block on ``device`` (CUDA
    activity on the card, CPU only for the CPU; a CUDA device without
    CUDA raises, as ``probe_device``), the obs phase and lane
    annotations armed while it is live, written as
    ``rank<r>.<ns>.pt.trace.json`` under ``logdir``.  Yields the
    ``DeviceTrace``, whose ``trace_file`` is set after the block."""
    trace = DeviceTrace(logdir, device).start()
    try:
        yield trace
    finally:
        trace.stop()


def _flush(device: torch.device) -> None:
    buf = _FLUSH.get(device)
    if buf is None:
        buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                          device=device)
        _FLUSH[device] = buf
    buf.zero_()


def time_call(fn, device: torch.device, warmup: int = 2,
              repeats: int = 5) -> float:
    """Median seconds of ``fn()`` on ``device`` (see the module
    docstring for how the card's calls are timed)."""
    for _ in range(max(1, warmup)):
        fn()
    times = []
    if device.type == "cuda":
        # an op of many kernels takes the host longer to issue than the
        # fixed spin covers: spin for twice its issue time, so the
        # window holds none of the host's dispatch
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn()
        issue_s = time.perf_counter() - t0
        spin = max(SPIN_CYCLES, int(2.0 * issue_s * SPIN_HZ))
        for _ in range(max(1, repeats)):
            _flush(device)
            torch.cuda._sleep(spin)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
    else:
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def probe_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device without CUDA raises
    (no probe moves to the CPU unasked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "operator probe: device 'cuda' asked but torch sees no CUDA "
            "device; pass device='cpu' to probe on the CPU")
    return device


def measure_operator_cost(op, batch_inputs: Optional[Sequence] = None,
                          warmup: int = 2, repeats: int = 5,
                          weight_shapes=None, device="cuda",
                          compute_dtype: torch.dtype = torch.bfloat16
                          ) -> Optional[float]:
    """Median seconds of one forward of ``op`` on ``device``, or None
    when it has no floating input or weight (the reference's rule: such
    an op, an input or a constant, is not measured and keeps the
    roofline).  Builds zero inputs from the op's input shapes unless
    given; weights come from the op's initializers, at
    ``weight_shapes[name]`` where given (calibration probes at per-shard
    shapes).  ``compute_dtype`` is the matmul dtype the model runs in.
    A CUDA device without CUDA raises (``probe_device``)."""
    from flexflow_tpu_torch.ops.base import LoweringContext

    device = probe_device(device)
    if batch_inputs is None:
        batch_inputs = [torch.zeros(s.sizes, dtype=s.dtype.to_torch())
                        for s in op.input_shapes]
    inputs = [x.to(device) for x in batch_inputs]
    gen = torch.Generator().manual_seed(0)
    weights = {}
    for ws in getattr(op, "_weight_specs", ()):
        shape = tuple((weight_shapes or {}).get(ws.name, ws.shape))
        weights[ws.name] = ws.initializer.init(gen, shape).to(
            device=device, dtype=ws.dtype.to_torch())
    if not any(t.is_floating_point()
               for t in list(inputs) + list(weights.values())):
        return None
    state = {f"{op.name}/{name}": torch.full(shape, fill, dtype=dtype,
                                             device=device)
             for name, shape, dtype, fill in (
                 op.state_specs() if hasattr(op, "state_specs") else ())}

    def run():
        ctx = LoweringContext(compute_dtype=compute_dtype, train=False,
                              state_in=dict(state), device=device)
        op.forward(ctx, inputs, weights)

    with torch.no_grad():
        return time_call(run, device, warmup=warmup, repeats=repeats)
