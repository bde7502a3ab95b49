"""Serving objective: KV-cache-aware latency/SLO search currency — a
copy of flexflow_tpu/search/serving.py (it holds no JAX).

Training search optimizes MEAN step time (throughput).  A decode-step
serving deployment wants **p99 latency under an HBM budget** — a
different Pareto point, because the decode step's dominant term is the
RAGGED paged-KV stream (ops/decode_attention.py) whose per-device load
depends on how the strategy shards sequences:

* a **batch split** of degree d partitions the frame's sequence slots
  over d device groups — each step's latency is gated by the group
  holding the most live tokens, and with ragged lengths the max-shard
  load concentrates: fewer sequences per shard = less averaging = a
  fatter p99 tail;
* a **head split** (decode TP, the replica slot) divides EVERY
  sequence's KV stream evenly — no imbalance term, at the price of the
  output projection's partial-sum allreduce.

``ServingSpec`` is the arrival model that makes this priceable: a
deterministic (seeded) population of ragged decode frames, reduced to
``load_factor(batch_degree)`` — the p-quantile max-shard token load
relative to full occupancy.  The decode op's ``sharded_bytes_accessed``
hook scales its cache stream by exactly this factor when a
``CostModel.serving`` spec is armed, so under ``FFConfig.
objective="serve"`` the ENTIRE search — both DP engines, substitution
estimates, delta sim, the champion-vs-DP floor — natively ranks in the
p99-latency currency with zero search-machinery changes; with
``objective="train"`` (default) nothing here runs and every priced
number is bit-identical to history (tests/test_serving.py inertness
gate).  The HBM budget needs no separate mechanism: per-device KV
residency at FULL page-pool occupancy enters ``CostModel.op_memory``
(``kv_cache_bytes``), so a strategy that cannot hold the pool is
rejected during search, not at OOM.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

import numpy as np

# arrival-model defaults: enough samples for a stable p99 of a
# max-of-shards statistic, pinned seed so searches are reproducible
DEFAULT_SAMPLES = 256
DEFAULT_QUANTILE = 0.99


@dataclass(frozen=True)
class ServingSpec:
    """The decode deployment the serve objective prices against.

    ``max_seqs``/``page_size``/``pages_per_seq`` mirror the decode
    graph's own frame geometry (``serving_spec_for`` derives them from
    its DecodeAttentionOps); ``p99_budget_ms`` is the declared SLO —
    recorded + linted (SHD163 warns when the predicted p99 exceeds
    it), never silently enforced by clamping."""

    max_seqs: int
    page_size: int
    pages_per_seq: int
    p99_budget_ms: float = 0.0
    quantile: float = DEFAULT_QUANTILE
    samples: int = DEFAULT_SAMPLES
    seed: int = 0
    # phase-split arrival model (prefill/decode disaggregation,
    # search/disaggregation.py): steady-state prompt traffic the
    # PREFILL phase must absorb, separate from the decode p99 load.
    # 0 derives defaults from the cache geometry.  Deliberately NOT
    # part of ``signature()``: these fields price only the
    # disaggregation proposal pass, never the per-(op, view) cost rows,
    # so train/serve search paths stay bit-identical to history.
    prompt_tokens_mean: int = 0  # 0 = max_seq_len // 2
    decode_tokens_mean: int = 0  # 0 = max(1, max_seq_len // 4)
    # fleet arrival share (search/fleet.py): a replica routed a
    # fraction of the fleet's traffic runs PARTIAL frames — only
    # ``occupancy_slots`` of its sequence slots are live, the rest
    # stream nothing.  0 = full frame (every non-fleet path).  Folded
    # into ``signature()`` ONLY when set, so no-fleet cost rows stay
    # byte-identical to history while occupancy-priced rows can never
    # cross-serve full-frame ones.
    occupancy_slots: int = 0
    # radix prefix sharing (runtime/decode.py PageAllocator): pages per
    # sequence expected to be CLAIMED from the shared prefix trie
    # rather than privately allocated (FFConfig.
    # serve_shared_prefix_pages — e.g. a fleet-wide system prompt of
    # N*page_size tokens).  Enters ``shared_residency_factor`` so
    # RESIDENCY pricing (kv_cache_bytes, SHD161) counts the shared
    # pages ONCE across the frame; the decode STREAM is deliberately
    # unaffected — every sequence still reads its own prefix.  Folded
    # into ``signature()`` ONLY when set (extension-only, like
    # occupancy_slots).  0 = no sharing assumed.
    shared_prefix_pages: int = 0
    _factors: Dict[int, float] = field(default_factory=dict, compare=False,
                                       repr=False, hash=False)

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.pages_per_seq

    def signature(self) -> Tuple:
        """The fields a priced cost row depends on — the extension-only
        component ``cost_cache.cost_signature`` folds in under the
        serve objective (serve rows must never cross-serve train
        runs)."""
        sig: Tuple = ("serve", self.max_seqs, self.page_size,
                      self.pages_per_seq, self.quantile, self.samples,
                      self.seed)
        if self.occupancy_slots:
            # extension-only: absent ⇒ bytes identical to pre-fleet
            sig = sig + ("occ", self.occupancy_slots)
        if self.shared_prefix_pages:
            # extension-only: absent ⇒ bytes identical to pre-sharing
            sig = sig + ("shared", self.shared_prefix_pages)
        return sig

    def shared_residency_factor(self) -> float:
        """SHARED/private residency ratio of the page pool: with
        ``shared_prefix_pages`` pages per sequence claimed from one
        trie-resident prefix, the frame holds
        ``max_seqs * (pps - shared) + shared`` distinct pages instead
        of ``max_seqs * pps``.  Multiplies kv_cache_bytes (residency/
        SHD161) only — never the decode stream."""
        s = max(0, min(self.shared_prefix_pages, self.pages_per_seq - 1))
        if s == 0 or self.max_seqs <= 0 or self.pages_per_seq <= 0:
            return 1.0
        total = self.max_seqs * self.pages_per_seq
        distinct = self.max_seqs * (self.pages_per_seq - s) + s
        return float(distinct) / float(total)

    # ---- arrival model ---------------------------------------------------
    def sample_lengths(self) -> np.ndarray:
        """[samples, max_seqs] int32 live-token counts: the ragged
        decode-frame population.  Deterministic under the seed.  The
        mixture is the continuous-batching steady state: most slots
        mid-generation (uniform over the cache), a short-prompt mode
        (fresh admissions), and a near-full mode (about to evict) —
        enough spread that max-shard concentration is a real
        phenomenon, not a degenerate constant."""
        rng = np.random.default_rng(self.seed)
        L = self.max_seq_len
        shape = (self.samples, self.max_seqs)
        mode = rng.random(shape)
        uniform = rng.integers(1, L + 1, size=shape)
        fresh = rng.integers(1, max(2, L // 8) + 1, size=shape)
        full = rng.integers(max(1, (7 * L) // 8), L + 1, size=shape)
        lens = np.where(mode < 0.2, fresh, np.where(mode < 0.9, uniform,
                                                    full))
        lens = lens.astype(np.int64)
        if 0 < self.occupancy_slots < self.max_seqs:
            # partial frame: the trailing slots are EMPTY, not short —
            # the draws for the live slots stay bit-identical to the
            # full frame's (same rng stream), so occupancy only removes
            # load, never reshuffles it
            lens[:, self.occupancy_slots:] = 0
        return lens

    def load_factor(self, batch_degree: int) -> float:
        """p-quantile of the max-shard live-token load under a batch
        split of ``batch_degree``, relative to full occupancy — the
        multiplier on the decode op's cache-stream bytes.  degree 1
        averages over every slot (factor well below 1); degree ==
        max_seqs is gated by the single longest sequence (factor near
        1): the imbalance amplification batch splits pay and head
        splits don't."""
        d = max(1, int(batch_degree))
        hit = self._factors.get(d)
        if hit is not None:
            return hit
        if self.max_seqs % d != 0:
            # propagation rejects such views anyway; price pessimally
            self._factors[d] = 1.0
            return 1.0
        lens = self.sample_lengths()  # [S, B]
        shards = lens.reshape(self.samples, d, self.max_seqs // d)
        max_shard = shards.sum(axis=2).max(axis=1)  # [S]
        q = float(np.quantile(max_shard, self.quantile))
        full = (self.max_seqs // d) * self.max_seq_len
        f = min(1.0, q / float(full)) if full > 0 else 1.0
        self._factors[d] = f
        return f

    def with_quantile(self, q: float) -> "ServingSpec":
        return replace(self, quantile=float(q), _factors={})

    def with_occupancy(self, slots: int) -> "ServingSpec":
        """The same deployment at ``slots`` live sequence slots per
        frame (fleet pricing: a replica's arrival share in frame
        currency).  ``slots >= max_seqs`` is the full frame."""
        k = max(1, min(self.max_seqs, int(slots)))
        if k >= self.max_seqs:
            k = 0
        return replace(self, occupancy_slots=k, _factors={})

    # ---- phase-split arrival model (disaggregation pricing) -------------
    def prefill_tokens_per_frame(self) -> float:
        """Expected PROMPT tokens the prefill phase must absorb per
        decode frame, in steady state: every live slot generates one
        token per frame and turns over every ``decode_tokens_mean``
        frames; each turnover admits a fresh prompt of
        ``prompt_tokens_mean`` tokens.  This is the compute-bound
        arrival load the disaggregation search prices against the
        prefill block — colocated deployments pay it as phase
        interference on the decode devices, disaggregated ones overlap
        it on their own submesh and pay the KV handoff instead
        (search/disaggregation.py)."""
        g = self.decode_tokens_mean or max(1, self.max_seq_len // 4)
        p = self.prompt_tokens_mean or max(1, self.max_seq_len // 2)
        return self.max_seqs * (float(p) / float(g))


def decode_nodes(graph):
    """The graph's DecodeAttentionOp nodes, topo order."""
    from flexflow_tpu_torch.core.optype import OperatorType

    return [n for n in graph.topo_order()
            if n.op.op_type == OperatorType.DECODE_ATTENTION]


def serving_spec_for(graph, config) -> Optional[ServingSpec]:
    """Derive the ServingSpec from the graph's own decode ops (frame
    geometry is a graph property, not a config guess), or None when the
    graph has no decode ops — the serve objective then degenerates to
    train pricing and the driver says so."""
    nodes = decode_nodes(graph)
    if not nodes:
        return None
    first = nodes[0].op
    geo = (first.max_seqs, first.attrs["page_size"],
           first.attrs["pages_per_seq"])
    for n in nodes[1:]:
        g = (n.op.max_seqs, n.op.attrs["page_size"],
             n.op.attrs["pages_per_seq"])
        if g != geo:
            raise ValueError(
                f"decode ops disagree on frame geometry: "
                f"{nodes[0].op.name} has {geo}, {n.op.name} has {g} — "
                f"one page allocator cannot serve both")
    return ServingSpec(
        max_seqs=geo[0], page_size=geo[1], pages_per_seq=geo[2],
        p99_budget_ms=float(getattr(config, "serve_p99_budget_ms", 0.0)
                            or 0.0),
        prompt_tokens_mean=int(getattr(
            config, "serve_prompt_tokens_mean", 0) or 0),
        decode_tokens_mean=int(getattr(
            config, "serve_decode_tokens_mean", 0) or 0),
        shared_prefix_pages=int(getattr(
            config, "serve_shared_prefix_pages", 0) or 0),
    )


def kv_residency_bytes(graph, strategy, num_devices: int,
                       serving: Optional[ServingSpec] = None) -> float:
    """Per-device resident KV bytes of ``(graph, strategy)``: the sum of
    every decode op's ``kv_cache_bytes`` under its view — the number
    SHD161 checks against the HBM capacity and the serve bench records
    per strategy.  ``serving`` threads the prefix-sharing residency
    discount (``shared_residency_factor``) into ops whose hook accepts
    it; a legacy hook without the keyword is priced unshared."""
    from flexflow_tpu_torch.core.machine import MachineView

    total = 0.0
    for node in decode_nodes(graph):
        mv = strategy.get(node.guid)
        if mv is None:
            mv = node.op.fixed_machine_view() or MachineView.trivial(
                node.op.output_shapes[0].ndim)
        try:
            total += node.op.kv_cache_bytes(mv, serving=serving)
        except TypeError:
            total += node.op.kv_cache_bytes(mv)
    return total


def serve_latency_quantiles(graph, strategy, config, calibration=None,
                            quantiles=(0.5, 0.9, 0.99)) -> Dict[str, float]:
    """Simulated decode-step latency at several arrival quantiles for
    one (graph, strategy) — the bench's p50/p90/p99 columns.  Each
    quantile gets a FRESH simulator (per-(op, view) cost rows bake the
    serving load factor, so one simulator cannot serve two quantiles)
    with the persistent cost cache detached (quantile sweeps are
    bench-local probes, not the search's cost surface)."""
    from flexflow_tpu_torch.search.simulator import Simulator

    spec = serving_spec_for(graph, config)
    out: Dict[str, float] = {}
    for q in quantiles:
        sim = Simulator(
            config.machine_spec, num_devices=config.search_devices,
            calibration=calibration, inference=True,
            serving=spec.with_quantile(q) if spec is not None else None,
        )
        t = sim.simulate(graph, strategy)
        out[f"p{int(round(q * 100))}"] = t
    return out
