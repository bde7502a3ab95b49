"""Prefill/decode disaggregation searched as a two-block placement — a
copy of flexflow_tpu/search/disaggregation.py.  As in the reference,
the proposal is priced and margin-gated, and an adopted one persists
as ``__meta__.disaggregation``; nothing executes it.

A serving deployment runs two phases with opposite cost shapes: the
compute-bound PREFILL of arriving prompts and the HBM-bound DECODE of
live sequences.  Colocated (the single-lane shape) the prompt
work rides the decode devices, so every decode frame pays the
interleaved prefill chunks as PHASE INTERFERENCE on top of its p99
cache stream.  Disaggregated — the placement-synthesis thesis of
arXiv:2110.10548 applied to the ragged-paged serving model of
arXiv:2604.15464 — prefill and decode run on DISJOINT device blocks:
the phases overlap instead of interleaving, at the price of moving
each admitted prompt's KV pages across the block boundary once.

This pass makes that trade a SEARCHED decision in the serve currency
(seconds per decode frame, steady state):

    T_coloc  = T_dec(all n) + load_pre * T_pre(all n) / L
    T_disagg = max(T_dec(block B), load_pre * T_pre(block A) / L)
             + T_handoff(KV bytes of load_pre tokens across the cut)

where ``load_pre = ServingSpec.prefill_tokens_per_frame()`` is the
steady-state prompt-token arrival per decode frame (the phase-split
load factor: prefill = compute-bound arrivals, decode = the p99 token
load the serve objective already prices), ``T_pre``/``T_dec`` are
intra-op-searched per block with the two-block machinery
(``SearchHelper.graph_cost(budget=, start=)`` — block B's views carry
``start_part`` like every placed strategy), and the handoff is priced
at the boundary link's speed (DCN when the cut spans hosts, the same
rule the placed executor's move cost applies).  The prompt graph is
DERIVED from the deployment's own decode graph
(models/decode.py ``derive_prefill_model``) and must share one
parameter set with it (``prefill_weight_bridge`` — gated by SHD165).

The winner is adopted only past the search margin (honest zero when
colocation stays optimal — small configs usually do), always-on
lint-gated (``analysis.lint_disaggregation``, SHD164/165 + the flat
SHD101-110 lint per block), and persists as ``__meta__.disaggregation``
behind the digest gate with import re-lint (model.compile).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from flexflow_tpu_torch.core.machine import MachineView

Strategy = Dict[int, MachineView]


@dataclass
class DisaggregationProposal:
    """One priced disaggregation decision: the two-block frame, both
    phase strategies, and the colocated-vs-disaggregated serve-currency
    comparison.  ``adopted`` is the margin-gated verdict — a proposal
    is always returned (the bench records honest zeros), only adopted
    winners persist."""

    num_devices: int
    prefill_devices: int
    decode_devices: int
    chunk: int
    prefill_seq_len: int
    max_seqs: int
    page_size: int
    pages_per_seq: int
    colocated_step_s: float
    disagg_step_s: float
    handoff_s: float
    prefill_tokens_per_frame: float
    spans_dcn: bool
    adopted: bool
    slo_classes: Tuple[dict, ...] = ()
    # runtime-only (not persisted): the searched per-phase strategies
    prefill_strategy: Strategy = field(default_factory=dict, repr=False)
    decode_strategy: Strategy = field(default_factory=dict, repr=False)

    def to_meta(self) -> dict:
        """The jsonable ``__meta__.disaggregation`` block (what fflint
        STR211 re-checks stdlib-only).  Pool geometry rides along
        because it must AGREE across the handoff — the prefill writer
        scatters into pages the decode block's allocator owns."""
        return {
            "num_devices": self.num_devices,
            "prefill_devices": self.prefill_devices,
            "decode_devices": self.decode_devices,
            "chunk": self.chunk,
            "prefill_seq_len": self.prefill_seq_len,
            "max_seqs": self.max_seqs,
            "page_size": self.page_size,
            "pages_per_seq": self.pages_per_seq,
            "colocated_step_ms": round(self.colocated_step_s * 1e3, 6),
            "disagg_step_ms": round(self.disagg_step_s * 1e3, 6),
            "handoff_ms": round(self.handoff_s * 1e3, 6),
            "prefill_tokens_per_frame": round(
                self.prefill_tokens_per_frame, 3),
            "spans_dcn": self.spans_dcn,
            "slo_classes": [dict(c) for c in self.slo_classes],
        }


def _budget_pairs(n: int):
    from flexflow_tpu_torch.search.placement_search import _budget_pairs as bp

    return bp(n)


def kv_handoff_bytes(decode_graph, tokens: float) -> float:
    """KV bytes ``tokens`` prompt tokens occupy across every decode
    layer — what one decode frame's worth of admissions moves over the
    block boundary."""
    from flexflow_tpu_torch.search.serving import decode_nodes

    return tokens * sum(n.op.kv_bytes_per_token()
                        for n in decode_nodes(decode_graph))


def propose_disaggregation(decode_graph, decode_strategy, config, *,
                           calibration=None, prefill_graph=None,
                           prefill_config=None, base_graph=None,
                           ) -> Optional[DisaggregationProposal]:
    """Price colocated vs disaggregated serving for ``decode_graph``
    under its searched ``decode_strategy`` and return the best
    two-block proposal (``adopted`` when it beats colocation by the
    search margin), or None when the graph/machine cannot express one
    (no decode ops, fewer than 2 devices).  Always-on lint gate: an
    adopted proposal that fails SHD164/165 is a search bug and raises
    ``AnalysisError`` loudly.

    ``base_graph`` is the UN-REWRITTEN decode graph when the search
    rewrote ``decode_graph``: substitution rewrites bake repartition
    views sized for the FULL mesh, so the narrow-block solves start
    from the base graph and run their OWN full search (rewrites
    included) at their block width — each block is a real deployment
    on its submesh, so both sides of the comparison carry whatever
    rewrites their mesh admits."""
    import dataclasses

    from flexflow_tpu_torch.obs.events import BUS
    from flexflow_tpu_torch.search.serving import serving_spec_for
    from flexflow_tpu_torch.search.simulator import Simulator

    n = config.search_devices
    if n < 2:
        return None
    spec = serving_spec_for(decode_graph, config)
    if spec is None:
        return None
    load_pre = spec.prefill_tokens_per_frame()
    L = spec.prompt_tokens_mean or max(1, spec.max_seq_len // 2)

    if prefill_graph is None:
        from flexflow_tpu_torch.models.decode import derive_prefill_model

        pre_model, prefill_config = derive_prefill_model(
            decode_graph, config, seq_len=L)
        prefill_graph = pre_model.graph
    elif prefill_config is None:
        prefill_config = config
    # one parameter set or no proposal: the bridge failing here is a
    # family mismatch, not a search bug — decline, the lint repeats
    # the check with findings for persisted artifacts
    from flexflow_tpu_torch.runtime.prefill import prefill_weight_bridge

    try:
        prefill_weight_bridge(prefill_graph, decode_graph)
    except ValueError:
        return None

    block_graph = base_graph if base_graph is not None else decode_graph
    serve_sim = Simulator.for_config(config, calibration=calibration,
                                     serving=spec)

    _solve_memo = {}

    def _block_search(graph, cfg, devices, serving_armed):
        """One phase placed on a ``devices``-wide block: the FULL
        search (substitution rewrites included) at that width — each
        block is a real deployment on its submesh, so it earns
        whatever rewrites its mesh admits, exactly like the colocated
        baseline earned its own.  Returns (cost_s, block_graph,
        strategy) — the possibly-rewritten block graph the strategy
        maps — or (inf, None, None)."""
        key = (id(graph), devices, serving_armed)
        if key in _solve_memo:
            return _solve_memo[key]
        from flexflow_tpu_torch.search.driver import optimize_strategy

        cfg_blk = dataclasses.replace(
            cfg, num_devices=devices, search_num_devices=0,
            export_strategy_file=None, import_strategy_file=None,
            serve_disaggregation="off")
        try:
            g_blk, s_blk = optimize_strategy(graph, cfg_blk,
                                             return_graph=True)
        except Exception:
            _solve_memo[key] = (math.inf, None, None)
            return _solve_memo[key]
        if not s_blk:
            _solve_memo[key] = (math.inf, None, None)
            return _solve_memo[key]
        sim_blk = Simulator.for_config(
            cfg_blk, calibration=calibration,
            serving=spec if serving_armed else None)
        _solve_memo[key] = (sim_blk.simulate(g_blk, s_blk), g_blk,
                            s_blk)
        return _solve_memo[key]

    # colocated: the searched decode strategy on the full mesh, plus
    # the arriving prompts' share of a full-mesh prefill pass per frame
    t_dec_full = serve_sim.simulate(decode_graph, decode_strategy)
    t_pre_full, _, _ = _block_search(prefill_graph, prefill_config, n,
                                     serving_armed=False)
    if not (math.isfinite(t_dec_full) and math.isfinite(t_pre_full)):
        return None
    colocated = t_dec_full + load_pre * (t_pre_full / L)

    bytes_pf = kv_handoff_bytes(decode_graph, load_pre)
    machine = serve_sim.machine
    dph = getattr(machine, "devices_per_host", 0) or n
    best = None
    for a, b in _budget_pairs(n):
        t_pre, g_pre, s_pre = _block_search(
            prefill_graph, prefill_config, a, serving_armed=False)
        if not math.isfinite(t_pre):
            continue
        t_dec, g_dec, s_dec = _block_search(
            block_graph, config, b, serving_armed=True)
        if not math.isfinite(t_dec):
            continue
        # the handoff crosses DCN when block B extends past block A's
        # hosts — the same spans rule the placed executor's move cost
        # applies.  The whole frame's admission payload is priced as
        # one serial boundary transfer: conservative for sharded
        # receivers, honest for the single-link worst case.
        spans_dcn = (a + b - 1) // dph > (a - 1) // dph
        if spans_dcn:
            handoff = (bytes_pf / machine.dcn_bandwidth
                       + machine.dcn_latency)
        else:
            handoff = (bytes_pf / machine.ici_bandwidth
                       + machine.ici_latency)
        # disaggregated phases OVERLAP (disjoint devices): the frame
        # rate is gated by the slower phase, plus the handoff wire
        disagg = max(t_dec, load_pre * (t_pre / L)) + handoff
        if best is None or disagg < best[0]:
            best = (disagg, a, b, g_pre, s_pre, g_dec, s_dec, handoff,
                    spans_dcn)

    if best is None:
        return None
    (disagg, a, b, g_pre, s_pre, g_dec, s_dec, handoff,
     spans_dcn) = best
    margin = max(0.0, config.search_improvement_margin)
    adopted = disagg < colocated * (1.0 - margin)
    proposal = DisaggregationProposal(
        num_devices=n, prefill_devices=a, decode_devices=b,
        chunk=int(getattr(config, "prefill_chunk", 32)),
        prefill_seq_len=L, max_seqs=spec.max_seqs,
        page_size=spec.page_size, pages_per_seq=spec.pages_per_seq,
        colocated_step_s=colocated, disagg_step_s=disagg,
        handoff_s=handoff, prefill_tokens_per_frame=load_pre,
        spans_dcn=spans_dcn, adopted=adopted,
        slo_classes=tuple(getattr(config, "serve_slo_classes", None)
                          or ()),
        prefill_strategy=s_pre, decode_strategy=s_dec,
    )
    if adopted:
        # always-on legality gate, the same discipline as every other
        # proposal class the search emits (SHD164/165 + per-block flat
        # lint): an adopted winner that fails is a search bug
        from flexflow_tpu_torch.analysis import (
            AnalysisError,
            emit_findings,
            errors_only,
            lint_disaggregation,
        )

        bad = errors_only(lint_disaggregation(
            g_dec, proposal.to_meta(), config,
            prefill_graph=g_pre,
            prefill_strategy=s_pre, decode_strategy=s_dec))
        if bad:
            emit_findings(bad)
            raise AnalysisError(
                "disaggregation search produced an illegal two-block "
                "placement", bad)
    BUS.emit(
        "search.disagg", adopted=adopted,
        colocated_ms=round(colocated * 1e3, 6),
        disagg_ms=round(disagg * 1e3, 6),
        handoff_ms=round(handoff * 1e3, 6),
        prefill_devices=a, decode_devices=b, spans_dcn=spans_dcn,
        prefill_tokens_per_frame=round(load_pre, 3),
    )
    from flexflow_tpu_torch.utils.logging import SEARCH_LOG as log

    log.log(
        f"disaggregation search: prefill[0:{a}) + decode[{a}:{a + b}) "
        f"modeled {disagg * 1e3:.4f} ms/frame vs colocated "
        f"{colocated * 1e3:.4f} ms/frame (handoff "
        f"{handoff * 1e3:.4f} ms) — "
        f"{'ADOPTED' if adopted else 'colocated stays optimal'}"
    )
    return proposal
