"""SLO burn-rate signals — a copy of flexflow_tpu/obs/slo.py:
multi-window error-budget consumption per serving class, as an earlier
and less noisy controller trigger than raw p99 drift.

The p99-drift trigger compares a measured tail quantile
against ``drift_threshold`` — it fires only once the tail itself has
moved past 1.5x, and a single straggler can swing a small-window p99.
SRE burn-rate alerting inverts the question: an SLOClass with target
quantile q carries an error budget of ``1 - q`` (the tolerated
violation fraction); the **burn rate** over a window is the observed
violation fraction divided by that budget.  A burn rate of 1.0 spends
budget exactly on schedule; sustained 2x spends it twice as fast.
Firing only when BOTH a fast and a slow completion window burn past a
factor keeps the signal early (the fast window reacts within a few
completions) AND quiet (the slow window vetoes one-off stragglers).

Crucially this fires on episodes p99-drift NEVER sees: a persistent
moderate violation — every request at 1.3x target — keeps p99 below
the 1.5x drift threshold while torching the entire error budget
(violation fraction 1.0 → burn rate 1/budget, e.g. 100x at q=0.99).

Windows are counted in COMPLETIONS, not wall time, matching how
``request_records`` arrive from the executor drain.

Stdlib-only; gauges land in the shared registry as
``slo.burn_rate|slo=<class>,window=fast|slow`` for /metrics.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEFAULT_FAST = 8     # completions in the fast window
DEFAULT_SLOW = 32    # completions in the slow window
DEFAULT_FIRE = 2.0   # both windows must burn past this factor
DEFAULT_BUDGET = 0.01  # error budget when the class carries no quantile


def _window_burn(lat: Sequence[float], target_s: float, window: int,
                 budget: float) -> Optional[float]:
    """Burn rate over the trailing ``window`` completions (None until
    the window is full — an empty window must not fire)."""
    if len(lat) < window or window <= 0:
        return None
    tail = lat[-window:]
    violations = sum(1 for v in tail if v > target_s)
    return (violations / window) / max(budget, 1e-9)


def burn_rates(records: Iterable[dict], targets: Dict[str, float], *,
               metric: str = "ttft_s",
               budgets: Optional[Dict[str, float]] = None,
               fast: int = DEFAULT_FAST, slow: int = DEFAULT_SLOW,
               fire: float = DEFAULT_FIRE) -> Dict[str, dict]:
    """Per-class multi-window burn rates over finished-request records
    (the ``executor.request_records`` shape: dicts carrying ``slo``
    and the latency ``metric``).  Returns, per class with a target::

        {"fast": r|None, "slow": r|None, "fired": bool,
         "target_s": t, "budget": b, "completions": n}

    and sets ``slo.burn_rate|slo=<c>,window=fast|slow`` gauges so the
    exposition endpoint serves the signal live.
    """
    budgets = budgets or {}
    by_class: Dict[str, List[float]] = {}
    for rec in records:
        slo = rec.get("slo")
        v = rec.get(metric)
        if slo in targets and isinstance(v, (int, float)):
            by_class.setdefault(slo, []).append(float(v))

    from flexflow_tpu_torch.obs.metrics import METRICS

    out: Dict[str, dict] = {}
    for slo, target_s in targets.items():
        lat = by_class.get(slo, [])
        budget = budgets.get(slo, DEFAULT_BUDGET)
        r_fast = _window_burn(lat, target_s, fast, budget)
        r_slow = _window_burn(lat, target_s, min(slow, max(len(lat),
                                                          fast)),
                              budget) if len(lat) >= fast else None
        fired = (r_fast is not None and r_slow is not None
                 and r_fast > fire and r_slow > fire)
        out[slo] = {"fast": r_fast, "slow": r_slow, "fired": fired,
                    "target_s": target_s, "budget": budget,
                    "completions": len(lat)}
        if r_fast is not None:
            METRICS.gauge(
                f"slo.burn_rate|slo={slo},window=fast").set(r_fast)
        if r_slow is not None:
            METRICS.gauge(
                f"slo.burn_rate|slo={slo},window=slow").set(r_slow)
    return out


def first_fire_indices(latencies: Sequence[float], target_s: float, *,
                       budget: float = DEFAULT_BUDGET,
                       fast: int = DEFAULT_FAST,
                       slow: int = DEFAULT_SLOW,
                       fire: float = DEFAULT_FIRE,
                       drift_threshold: float = 0.5,
                       p99_window: int = 32,
                       quantile: float = 0.99,
                       ) -> Tuple[Optional[int], Optional[int]]:
    """Replay a latency stream and return the completion index (1-based
    count of completions seen) at which (a) the burn-rate trigger and
    (b) the raw p99-drift trigger would first fire — the bench's
    burn-fires-earlier claim.  p99-drift fires when the trailing
    ``p99_window`` quantile exceeds ``target_s * (1 + drift_threshold)``
    (the ``observe_p99`` ratio contract).
    """
    burn_at: Optional[int] = None
    drift_at: Optional[int] = None
    seen: List[float] = []
    for i, v in enumerate(latencies, start=1):
        seen.append(float(v))
        if burn_at is None:
            r_fast = _window_burn(seen, target_s, fast, budget)
            r_slow = _window_burn(
                seen, target_s, min(slow, max(len(seen), fast)),
                budget) if len(seen) >= fast else None
            if (r_fast is not None and r_slow is not None
                    and r_fast > fire and r_slow > fire):
                burn_at = i
        if drift_at is None and len(seen) >= min(p99_window, fast):
            tail = sorted(seen[-p99_window:])
            k = max(int(round(quantile * (len(tail) - 1))), 0)
            p99 = tail[k]
            if target_s > 0 and (p99 / target_s - 1.0) > drift_threshold:
                drift_at = i
        if burn_at is not None and drift_at is not None:
            break
    return burn_at, drift_at
