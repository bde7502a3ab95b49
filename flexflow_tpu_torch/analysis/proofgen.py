"""Generative equivalence proofs — the port of
flexflow_tpu/analysis/proofgen.py: proof graphs derived from the
rewrite matchers themselves.  The graphs, their seeds and the sweep are
the reference's; the proofs run through the port's
``equivalence.verify_rewrite`` (the port's op forwards, on the card
unless ``device`` names the CPU).

The hand-curated proof-graph zoo (``equivalence._proof_graphs``) proved
the registry but left one hole class: a newly registered rewrite whose
anchor shape the zoo misses was only *reported* as an EQV305 coverage
warning, never proven.  TASO (SysML'19) verifies every substitution
against generated witnesses rather than a fixed suite; this module
brings that property here: for each registered rewrite the declared
``anchor_types`` (the op types its matcher can provably anchor on —
the same contract the per-op-type seed index keys on) drive a per-op-
family graph synthesizer, and the generated graphs feed the SAME
executable numeric proof (``equivalence.verify_rewrite``) the zoo
does.  Factory xfers therefore cannot have an EQV305 hole by
construction — every anchor type they declare has a generated witness
family — and the zoo stays as a regression anchor.

Synthesis is deterministic under a fixed seed and sweeps three axes:

* **degree sweep** — anchor dims sized so every divisor degree of the
  device count divides them (sizes ``n``-multiples at x1 and x2), so
  every generated ``partition_*``/``replicate_*`` degree anchors;
* **dtype variants** — a float32 and a bfloat16 input lane for float
  families (embedding ids are int32 by construction);
* **randomized context padding** — seeded draws of shape-preserving
  compute ops (relu/identity/dense) around the anchor.  Pads are
  never parallel ops: a pad must not trip a matcher's
  no-REPARTITION-predecessor guard.

Each rewrite is proven once per (lane x size x padding) CELL that
yields a match, so every sweep axis is executed as a proof — a
rewrite sound on the bare motif but unsound in a padded or
x2-degree context cannot hide behind a single bare-motif proof.

Finding codes (extending ``equivalence``'s EQV3xx range):

* **EQV305** (error) — a *factory* rewrite (``GraphXfer`` /
  ``BatchEmbeddingsXfer``) anchored on NO generated graph: a
  synthesizer coverage hole, loud by design.
* **EQV306** (warn) — a non-factory rewrite (JSON
  ``substitution_loader`` rule, or anything without a usable anchor
  contract) matched neither a generated graph nor the hand zoo: it is
  explicitly reported as un-proven instead of silently skipped.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from flexflow_tpu_torch.analysis.findings import Finding


def _f(code: str, message: str, **kw) -> Finding:
    return Finding(code=code, pass_name="equivalence", message=message, **kw)


# dtype lanes for float anchor families; embedding id feeds are int32
# by construction (the integer lane is not optional there)
FLOAT_LANES = ("float32", "bfloat16")
# padding-pattern draws per (motif, size, lane) cell
PAD_VARIANTS = 2


def _sizes(num_devices: int, mult: int) -> Tuple[int, int, int]:
    """(batch, width, seq/heads) such that every divisor degree of
    ``num_devices`` divides batch, width and seq — the degree-sweep
    guarantee (same rule as the hand zoo's ``_proof_graphs``)."""
    n = max(2, num_devices)
    b = max(8, n)
    if b % n:
        b = n
    return b * mult, 2 * n * mult, n


def _namer(tag: str):
    counter = [0]

    def nm(base: str) -> str:
        counter[0] += 1
        return f"pg_{tag}_{base}_{counter[0]}"

    return nm


def _pads(m, t, rng, nm, width: Optional[int] = None):
    """0-2 shape-preserving compute pads around the anchor.  Only
    compute ops (relu/identity/dense): a parallel-op pad would trip the
    matchers' no-REPARTITION-predecessor guards and turn padding into
    match suppression."""
    for _ in range(int(rng.integers(0, 3))):
        k = int(rng.integers(0, 3))
        if k == 0:
            t = m.relu(t, name=nm("pad_relu"))
        elif k == 1:
            t = m.identity(t, name=nm("pad_id"))
        elif width is not None:
            t = m.dense(t, width, name=nm("pad_fc"))
        else:
            t = m.identity(t, name=nm("pad_id"))
    return t


def synthesize_anchor_graphs(op_type, num_devices: int,
                             seed: int = 0,
                             ) -> List[Tuple[str, int, int, object]]:
    """Deterministic ``(dtype lane, size mult, pad variant, Graph)``
    proof-graph family anchored on ``op_type``: every structural motif
    a factory matcher anchoring on that type needs (plain op,
    linear+sole-activation, parallel-op pairs/chains,
    combine-before-concat, unary-fanout-to-repartitions, twin
    embeddings), swept over sizes x dtype lanes x padding draws.  The
    (lane, mult, pad) cell key is part of the return so the verifier
    can prove one graph PER CELL — every sweep axis is executed as a
    proof, not just generated.  Returns [] for op types without a
    motif family — the caller turns that into a loud EQV305/EQV306,
    never silence."""
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.core.optype import OperatorType as T

    unary_fns = {
        T.RELU: "relu", T.SIGMOID: "sigmoid", T.TANH: "tanh",
        T.GELU: "gelu", T.EXP: "exp", T.IDENTITY: "identity",
    }
    binary_fns = {
        T.EW_ADD: "add", T.EW_MUL: "multiply", T.EW_SUB: "subtract",
        T.EW_DIV: "divide", T.EW_MAX: "max", T.EW_MIN: "min",
    }

    out: List[Tuple[str, int, int, object]] = []
    n_dev = max(2, num_devices)
    for mult in (1, 2):
        b, w, n = _sizes(num_devices, mult)
        d_b = next((d for d in (4, 3, 2) if b % d == 0), b)
        lanes = ("int32",) if op_type is T.EMBEDDING else FLOAT_LANES
        for li, lane in enumerate(lanes):
            for pv in range(PAD_VARIANTS):
                rng = np.random.default_rng(
                    seed * 1_000_003 + mult * 10_007 + li * 101 + pv)
                for motif in _motif_builders(
                        op_type, unary_fns, binary_fns):
                    nm = _namer(op_type.value)
                    cfg = ff.FFConfig(
                        batch_size=b, num_devices=n_dev,
                        only_data_parallel=True, device="cpu")
                    m = ff.FFModel(cfg)
                    ok = motif(m, b, w, n, d_b, lane, rng, nm)
                    if ok:
                        out.append((lane, mult, pv, m.graph))
    return out


def _motif_builders(op_type, unary_fns, binary_fns):
    """Motif callables for one anchor op family.  Each builds a full
    model into ``m`` and returns True, or False when the family cannot
    express the motif (the caller simply skips it)."""
    from flexflow_tpu_torch.core.optype import OperatorType as T

    def head(m, t, nm):
        m.dense(t, 4, name=nm("head"))

    def plain(m, b, w, n, d_b, lane, rng, nm):
        if op_type in unary_fns or op_type in (
                T.LINEAR, T.SOFTMAX, T.LAYERNORM, T.CONCAT) or (
                op_type in binary_fns):
            x = m.create_tensor([b, w], dtype=lane, name=nm("in"))
            x = _pads(m, x, rng, nm, width=w)
            if op_type is T.LINEAR:
                y = m.dense(x, w, name=nm("anchor"))
            elif op_type is T.SOFTMAX:
                y = m.softmax(x, name=nm("anchor"))
            elif op_type is T.LAYERNORM:
                y = m.layer_norm(x, name=nm("anchor"))
            elif op_type is T.CONCAT:
                y = m.concat(
                    [m.dense(x, w, name=nm("br0")),
                     m.dense(x, w, name=nm("br1"))],
                    axis=1, name=nm("anchor"))
            elif op_type in binary_fns:
                y = getattr(m, binary_fns[op_type])(
                    m.dense(x, w, name=nm("ba")),
                    m.dense(x, w, name=nm("bb")), name=nm("anchor"))
            else:
                y = getattr(m, unary_fns[op_type])(x, name=nm("anchor"))
            y = _pads(m, y, rng, nm, width=None)
            head(m, y, nm)
            return True
        if op_type is T.MULTIHEAD_ATTENTION:
            x = m.create_tensor([b, n, w], dtype=lane, name=nm("in"))
            x = _pads(m, x, rng, nm)
            y = m.multihead_attention(x, x, x, w, n, name=nm("anchor"))
            head(m, y, nm)
            return True
        if op_type in (T.CONV2D, T.POOL2D, T.FLAT):
            x = m.create_tensor([b, 8, 8, 8], dtype=lane, name=nm("img"))
            x = _pads(m, x, rng, nm)
            if op_type is T.CONV2D:
                y = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name=nm("anchor"))
            elif op_type is T.POOL2D:
                y = m.pool2d(x, 2, 2, stride_h=2, stride_w=2,
                             name=nm("anchor"))
            else:
                y = x
            y = m.flat(y, name=nm("anchor") if op_type is T.FLAT
                       else nm("flat"))
            head(m, y, nm)
            return True
        if op_type is T.EMBEDDING:
            ids = m.create_tensor([b, 2], dtype="int32", name=nm("ids"))
            y = m.embedding(ids, 4 * n, n, aggr="sum", name=nm("anchor"))
            y = _pads(m, y, rng, nm, width=None)
            head(m, y, nm)
            return True
        if op_type is T.REPARTITION:
            x = m.create_tensor([b, w], dtype=lane, name=nm("in"))
            x = _pads(m, x, rng, nm, width=w)
            t = m.repartition(x, dim=0, degree=d_b, name=nm("anchor"))
            t = m.combine(t, dim=0, degree=1, name=nm("comb"))
            head(m, t, nm)
            return True
        if op_type is T.COMBINE:
            x = m.create_tensor([b, w], dtype=lane, name=nm("in"))
            x = _pads(m, x, rng, nm, width=w)
            t = m.combine(x, dim=0, degree=1, name=nm("anchor"))
            t = m.repartition(t, dim=0, degree=d_b, name=nm("rep"))
            head(m, t, nm)
            return True
        if op_type is T.REPLICATE:
            x = m.create_tensor([b, w], dtype=lane, name=nm("in"))
            x = _pads(m, x, rng, nm, width=w)
            t = m.replicate(x, degree=2, name=nm("anchor"))
            t = m.reduction(t, degree=2, name=nm("red"))
            head(m, t, nm)
            return True
        return False

    motifs = [plain]

    if op_type is T.LINEAR:
        # linear with a SOLE-consumer activation: fuse_linear_activation
        def act_follow(m, b, w, n, d_b, lane, rng, nm):
            x = m.create_tensor([b, w], dtype=lane, name=nm("in"))
            x = _pads(m, x, rng, nm, width=w)
            t = m.dense(x, w, name=nm("anchor"))
            t = m.relu(t, name=nm("act"))
            t = _pads(m, t, rng, nm, width=None)
            head(m, t, nm)
            return True

        motifs.append(act_follow)

    if op_type in unary_fns:
        # unary fanning out to k same-(dim, degree) repartitions:
        # hoist_partition_above_unary
        def fanout(m, b, w, n, d_b, lane, rng, nm):
            x = m.create_tensor([b, w], dtype=lane, name=nm("in"))
            x = _pads(m, x, rng, nm, width=w)
            t = getattr(m, unary_fns[op_type])(x, name=nm("anchor"))
            outs = []
            for i in range(3):
                p = m.repartition(t, dim=0, degree=d_b, name=nm(f"p{i}"))
                outs.append(m.dense(p, w, name=nm(f"fc{i}")))
            y = m.concat(outs, axis=1, name=nm("cat"))
            head(m, y, nm)
            return True

        motifs.append(fanout)

    if op_type is T.CONCAT:
        # k branches each ending Combine feeding the concat:
        # sink_combine_through_concat
        def sink(m, b, w, n, d_b, lane, rng, nm):
            x = m.create_tensor([b, w], dtype=lane, name=nm("in"))
            x = _pads(m, x, rng, nm, width=w)
            outs = []
            for i in range(3):
                t = m.dense(x, w, name=nm(f"br{i}"))
                outs.append(m.combine(t, dim=0, degree=1, name=nm(f"c{i}")))
            y = m.concat(outs, axis=1, name=nm("anchor"))
            head(m, y, nm)
            return True

        motifs.append(sink)

    if op_type is T.REPARTITION:
        # adjacent repartitions: fuse_parallel_op_chain
        def chain(m, b, w, n, d_b, lane, rng, nm):
            x = m.create_tensor([b, w], dtype=lane, name=nm("in"))
            x = _pads(m, x, rng, nm, width=w)
            t = m.repartition(x, dim=0, degree=2, name=nm("anchor"))
            t = m.repartition(t, dim=1, degree=2, name=nm("rep2"))
            head(m, t, nm)
            return True

        motifs.append(chain)

    if op_type is T.EMBEDDING:
        # two same-signature embeddings: BatchEmbeddingsXfer
        def twin(m, b, w, n, d_b, lane, rng, nm):
            outs = []
            for i in range(2):
                ids = m.create_tensor([b, 2], dtype="int32",
                                      name=nm(f"ids{i}"))
                outs.append(m.embedding(ids, 4 * n, n, aggr="sum",
                                        name=nm(f"emb{i}")))
            t = m.concat(outs, axis=1, name=nm("cat"))
            t = _pads(m, t, rng, nm, width=None)
            head(m, t, nm)
            return True

        motifs.append(twin)

    return motifs


def instantiate_pattern_graph(rule, num_devices: int):
    """Build a ``PatternRule``'s SOURCE pattern directly as a PCG — the
    multi-node-JSON proof instantiator: a rule
    whose source pattern spans several ops rarely anchors on the
    single-motif synthesizer graphs or the hand zoo, so it used to be
    EQV306-reported un-proven.  Here the pattern ops themselves become
    model calls (externals -> input tensors, weight-slot externals ->
    the op's own weight, parallel ops from their PM_* params, compute
    ops from the donor-less construction families), a dense head is
    added on every MAPPED output (mapped outputs are the tensors the
    matcher allows to escape), and the result feeds the SAME
    ``verify_rewrite`` numeric proof as everything else.  Returns None
    when the pattern uses an op family outside the supported subset or
    a weight-sharing external our ops cannot express — those rules
    stay honestly EQV306."""
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.core.optype import OperatorType as T
    from flexflow_tpu_torch.search.substitution_loader import (
        _ACTI_MAP,
        _PARALLEL_TYPES,
        _logical_dim,
    )

    unary_calls = {T.RELU: "relu", T.SIGMOID: "sigmoid", T.TANH: "tanh",
                   T.ELU: "elu", T.IDENTITY: "identity"}
    binary_calls = {T.EW_ADD: "add", T.EW_MUL: "multiply",
                    T.EW_SUB: "subtract", T.EW_DIV: "divide",
                    T.EW_MAX: "max", T.EW_MIN: "min"}
    # data-input arity per op family: pattern slots past it are the
    # reference corpus' explicit weight tensors, which our ops OWN —
    # they bind to the matched op's own weight at match time, so the
    # instantiated graph simply omits them
    data_arity = {T.LINEAR: 1, T.SOFTMAX: 1, T.LAYERNORM: 1}
    data_arity.update({t: 1 for t in unary_calls})
    data_arity.update({t: 2 for t in binary_calls})
    data_arity.update({t: 1 for t in _PARALLEL_TYPES})

    n = max(2, num_devices)
    b = max(8, n)
    if b % n:
        b = n
    w = 2 * n
    cfg = ff.FFConfig(batch_size=b, num_devices=n,
                      only_data_parallel=True, device="cpu")
    m = ff.FFModel(cfg)
    nm = _namer("pat")
    ext: Dict[int, object] = {}
    outs: Dict[Tuple[int, int], object] = {}
    # weight-sharing externals (one negative id feeding two ops'
    # weight slots) cannot be expressed with op-owned weights — the
    # matcher could never bind them anyway, so decline
    weight_ext_owner: Dict[int, int] = {}
    for i, pat in enumerate(rule.src_ops):
        t_type = pat.type
        if t_type is T.CONCAT:
            arity = len(pat.inputs)
        else:
            arity = data_arity.get(t_type)
            if arity is None:
                return None
        ins = []
        for slot, (src_id, ts_id) in enumerate(pat.inputs):
            if slot >= arity:
                if src_id >= 0:
                    return None  # an internal tensor in a weight slot
                if src_id in weight_ext_owner or src_id in ext:
                    return None  # shared weight external
                weight_ext_owner[src_id] = i
                continue
            if src_id >= 0:
                t = outs.get((src_id, ts_id))
                if t is None:
                    return None
            else:
                if src_id in weight_ext_owner:
                    return None
                if src_id not in ext:
                    ext[src_id] = m.create_tensor(
                        [b, w], name=nm(f"ext{-src_id}"))
                t = ext[src_id]
            ins.append(t)
        if len(ins) < arity:
            return None  # pattern op missing a data input
        try:
            if t_type is T.LINEAR:
                act = _ACTI_MAP.get(pat.params.get("PM_ACTI", 0))
                y = m.dense(ins[0], w, activation=act, name=nm("lin"))
            elif t_type is T.SOFTMAX:
                y = m.softmax(ins[0], name=nm("sm"))
            elif t_type is T.LAYERNORM:
                y = m.layer_norm(ins[0], name=nm("ln"))
            elif t_type is T.CONCAT:
                y = m.concat(ins, axis=1, name=nm("cat"))
            elif t_type in unary_calls:
                y = getattr(m, unary_calls[t_type])(ins[0], name=nm("un"))
            elif t_type in binary_calls:
                y = getattr(m, binary_calls[t_type])(
                    ins[0], ins[1], name=nm("bin"))
            elif t_type in _PARALLEL_TYPES:
                dim, deg = pat.parallel_dim_degree()
                if deg is None:
                    return None
                if t_type is T.REPARTITION:
                    ld = _logical_dim(dim or 0, 2)
                    if (b, w)[ld] % deg:
                        return None
                    y = m.repartition(ins[0], dim=ld, degree=deg,
                                      name=nm("rep"))
                elif t_type is T.COMBINE:
                    ld = _logical_dim(dim or 0, 2)
                    y = m.combine(ins[0], dim=ld, degree=deg,
                                  name=nm("comb"))
                elif t_type is T.REPLICATE:
                    y = m.replicate(ins[0], degree=deg, name=nm("repl"))
                else:
                    y = m.reduction(ins[0], degree=deg, name=nm("red"))
            else:
                return None
        except Exception:
            return None  # shape/param mismatch: the family declines
        outs[(i, 0)] = y
    # heads on MAPPED outputs only — the matcher's escape check rejects
    # any other internal tensor leaving the pattern
    headed = set()
    for s_op, s_ts, _d_op, _d_ts in rule.mapped_outputs:
        t = outs.get((s_op, s_ts))
        if t is None:
            return None
        if (s_op, s_ts) not in headed:
            headed.add((s_op, s_ts))
            try:
                m.dense(t, 4, name=nm("head"))
            except Exception:
                return None
    return m.graph


def verify_registry_generated(
    num_devices: int = 8, seed: int = 0, xfers=None, device="cuda",
) -> Tuple[List[Finding], Dict[str, object]]:
    """Generative proof of a rewrite registry: every xfer must anchor
    on a graph synthesized FROM ITS OWN ``anchor_types`` and pass
    ``verify_rewrite`` there, once per (dtype lane x size mult x pad
    variant) CELL that yields a match — so the degree sweep and the
    padded contexts are executed as proofs, not merely generated (a
    matcher-sound-but-apply-unsound rewrite in a padded or x2-degree
    context cannot hide behind a bare-motif proof).  Returns
    ``(findings, stats)``; findings == [] means every rewrite is
    generatively proven.  Non-factory rewrites (JSON rules) that
    anchor nowhere — generated graphs or the zoo fallback — are
    reported as EQV306 (warn), factory holes as EQV305 (error).  Every
proof evaluates on ``device``."""
    from flexflow_tpu_torch.analysis.equivalence import (
        _proof_graphs,
        verify_rewrite,
    )
    from flexflow_tpu_torch.search.substitution import (
        BatchEmbeddingsXfer,
        GraphXfer,
        generate_all_pcg_xfers,
    )

    if xfers is None:
        xfers = generate_all_pcg_xfers(num_devices)
    bank: Dict[object, List[Tuple[str, object]]] = {}
    zoo = None  # lazy: only built when a rule needs the fallback
    findings: List[Finding] = []
    stats: Dict[str, object] = {
        "xfers": len(xfers), "graphs_generated": 0, "proofs": 0,
        "lanes": {}, "zoo_fallbacks": 0, "unproven": 0,
    }
    for xf in xfers:
        name = getattr(xf, "name", type(xf).__name__)
        anchors = getattr(xf, "anchor_types", None)
        factory = isinstance(xf, (GraphXfer, BatchEmbeddingsXfer))
        proven_lanes: List[str] = []
        proven_cells: set = set()  # (lane, mult, pad) across anchor types
        if anchors:
            for t in sorted(anchors, key=lambda a: a.value):
                if t not in bank:
                    bank[t] = synthesize_anchor_graphs(
                        t, num_devices, seed=seed)
                    stats["graphs_generated"] += len(bank[t])
                for lane, mult, pv, g in bank[t]:
                    cell = (lane, mult, pv)
                    if cell in proven_cells:
                        continue
                    matches = xf.find_matches(g)
                    if not matches:
                        continue
                    findings += verify_rewrite(g, xf, matches[0],
                                               seed=seed, device=device)
                    proven_cells.add(cell)
                    if lane not in proven_lanes:
                        proven_lanes.append(lane)
                    stats["proofs"] += 1
                    stats["lanes"][lane] = stats["lanes"].get(lane, 0) + 1
        if not proven_lanes and not factory:
            # non-factory rules: multi-node JSON patterns rarely anchor
            # on the single-motif bank — instantiate the rule's OWN
            # source pattern as a PCG and prove there (closes the
            # EQV306 hole for every rule the instantiator can express)
            from flexflow_tpu_torch.search.substitution_loader import (
                PatternRule,
            )

            if isinstance(xf, PatternRule):
                g = instantiate_pattern_graph(xf, num_devices)
                if g is not None:
                    matches = xf.find_matches(g)
                    if matches:
                        findings += verify_rewrite(g, xf, matches[0],
                                                   seed=seed, device=device)
                        proven_lanes.append("pattern")
                        stats["proofs"] += 1
                        stats["pattern_proofs"] = stats.get(
                            "pattern_proofs", 0) + 1
            # the hand zoo stays as the regression anchor / last resort
            if not proven_lanes:
                if zoo is None:
                    zoo = _proof_graphs(num_devices)
                for g in zoo:
                    matches = xf.find_matches(g)
                    if matches:
                        findings += verify_rewrite(g, xf, matches[0],
                                                   seed=seed, device=device)
                        proven_lanes.append("zoo")
                        stats["proofs"] += 1
                        stats["zoo_fallbacks"] += 1
                        break
        if not proven_lanes:
            stats["unproven"] += 1
            if factory:
                findings.append(_f(
                    "EQV305",
                    f"factory rewrite {name!r} anchored on no GENERATED "
                    f"proof graph (anchor_types="
                    f"{sorted(t.value for t in anchors) if anchors else None}"
                    f") — the synthesizer has a motif hole for this "
                    f"family"))
            else:
                findings.append(_f(
                    "EQV306",
                    f"rewrite {name!r} matched no generated or zoo proof "
                    f"graph — it carries no executable soundness proof "
                    f"(multi-node JSON patterns outside the synthesizer's "
                    f"motif families are reported here, never silently "
                    f"skipped)", severity="warn"))
    return findings, stats
