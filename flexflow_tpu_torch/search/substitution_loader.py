"""Substitution-rule JSON loader + multi-node pattern engine — a copy of
flexflow_tpu/search/substitution_loader.py.

Loads rule collections in the reference's format (reference:
include/flexflow/substitution_loader.h:15-60, substitutions/
graph_subst_3_v2.json: 640 TASO-derived rules, each a source pattern
graph srcOp[], a destination graph dstOp[], and output tensor mappings)
and compiles the expressible subset into rewrites over our PCG.

Pattern ops reference each other by (opId, tsId); opId == -1 denotes an
external input tensor.  Matching is backtracking subgraph isomorphism in
pattern topological order; a match is rejected when an unmapped internal
tensor escapes the pattern (the reference rejects the same way in
GraphXfer::create_new_graph, substitution.cc:576-760).

Supported destination ops: the four parallel ops (constructed from
PM_* parameters) and compute ops that clone a same-typed source op's
attributes (the reference's matchOpX convention, substitution.h:156).
Rules outside this subset are skipped and counted — the loader reports
``skipped`` so callers can see coverage honestly.  Concat and split
destinations (the batched-communication rules) build the port's
``ConcatOp`` and ``SplitOp``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.core.graph import Edge, Graph, Node
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.parallel.parallel_ops import (
    CombineOp,
    ReductionOp,
    RepartitionOp,
    ReplicateOp,
)

# reference op-type spellings -> our enum (substitution_loader.h
# NLOHMANN_JSON_SERIALIZE_ENUM(OperatorType, ...))
_OP_TYPES: Dict[str, OperatorType] = {
    "OP_NOOP": OperatorType.NOOP,
    "OP_CONV2D": OperatorType.CONV2D,
    "OP_DROPOUT": OperatorType.DROPOUT,
    "OP_LINEAR": OperatorType.LINEAR,
    "OP_BATCHMATMUL": OperatorType.BATCH_MATMUL,
    "OP_POOL2D_MAX": OperatorType.POOL2D,
    "OP_RELU": OperatorType.RELU,
    "OP_IDENTITY": OperatorType.IDENTITY,
    "OP_SIGMOID": OperatorType.SIGMOID,
    "OP_TANH": OperatorType.TANH,
    "OP_ELU": OperatorType.ELU,
    "OP_FLAT": OperatorType.FLAT,
    "OP_SOFTMAX": OperatorType.SOFTMAX,
    "OP_BATCHNORM": OperatorType.BATCHNORM,
    "OP_CONCAT": OperatorType.CONCAT,
    "OP_SPLIT": OperatorType.SPLIT,
    "OP_EMBEDDING": OperatorType.EMBEDDING,
    "OP_CACHE": OperatorType.CACHE,
    "OP_RESHAPE": OperatorType.RESHAPE,
    "OP_REVERSE": OperatorType.REVERSE,
    "OP_TRANSPOSE": OperatorType.TRANSPOSE,
    "OP_EW_ADD": OperatorType.EW_ADD,
    "OP_EW_MUL": OperatorType.EW_MUL,
    "OP_EW_SUB": OperatorType.EW_SUB,
    "OP_EW_DIV": OperatorType.EW_DIV,
    "OP_EW_MAX": OperatorType.EW_MAX,
    "OP_EW_MIN": OperatorType.EW_MIN,
    "OP_MULTIHEAD_ATTENTION": OperatorType.MULTIHEAD_ATTENTION,
    # MoE + scalar subset (reference enum substitution_loader.h:52-71)
    "OP_GROUP_BY": OperatorType.GROUP_BY,
    "OP_AGGREGATE": OperatorType.AGGREGATE,
    "OP_AGG_SPEC": OperatorType.AGGREGATE_SPEC,
    "OP_TOPK": OperatorType.TOPK,
    "OP_SCALAR_MULTIPLY": OperatorType.SCALAR_MUL,
    "OP_SCALAR_ADD": OperatorType.SCALAR_ADD,
    "OP_SCALAR_SUB": OperatorType.SCALAR_SUB,
    "OP_SCALAR_TRUE_DIV": OperatorType.SCALAR_TRUE_DIV,
    "OP_PARTITION": OperatorType.REPARTITION,
    "OP_REPARTITION": OperatorType.REPARTITION,
    "OP_COMBINE": OperatorType.COMBINE,
    "OP_REPLICATE": OperatorType.REPLICATE,
    "OP_REDUCE": OperatorType.REDUCTION,
    "OP_REDUCTION": OperatorType.REDUCTION,
}

_PARALLEL_TYPES = {
    OperatorType.REPARTITION,
    OperatorType.COMBINE,
    OperatorType.REPLICATE,
    OperatorType.REDUCTION,
}

# TASO ActiMode encoding used by the corpus' PM_ACTI values
_ACTI_MAP = {0: None, 1: "sigmoid", 2: "relu", 3: "tanh"}

# dst op types constructible from input shapes + pattern params alone —
# no same-typed source op ("donor") needed (e.g. TASO rules whose dst
# introduces a Concat/activation the source pattern lacks)
_DONORLESS_TYPES = {
    OperatorType.CONCAT,
    OperatorType.SPLIT,
    OperatorType.RELU,
    OperatorType.SIGMOID,
    OperatorType.TANH,
    OperatorType.ELU,
    OperatorType.IDENTITY,
    OperatorType.EW_ADD,
    OperatorType.EW_MUL,
    OperatorType.EW_SUB,
    OperatorType.EW_DIV,
    OperatorType.EW_MAX,
    OperatorType.EW_MIN,
}

_EW_BINARY_TYPES = {
    OperatorType.EW_ADD,
    OperatorType.EW_MUL,
    OperatorType.EW_SUB,
    OperatorType.EW_DIV,
    OperatorType.EW_MAX,
    OperatorType.EW_MIN,
}

_UNARY_TYPES = {
    OperatorType.RELU,
    OperatorType.SIGMOID,
    OperatorType.TANH,
    OperatorType.ELU,
    OperatorType.IDENTITY,
}


@dataclass
class PatternOp:
    """One node of a rule's source or destination pattern."""

    type: OperatorType
    inputs: List[Tuple[int, int]]  # (opId | -1 external, tsId)
    params: Dict[str, int] = field(default_factory=dict)

    def parallel_dim_degree(self) -> Tuple[Optional[int], Optional[int]]:
        p = self.params
        dim = p.get("PM_PARALLEL_DIM",
                    p.get("PM_REPARTITION_DIM",
                          p.get("PM_COMBINE_DIM",
                                p.get("PM_REPLICATE_DIM",
                                      p.get("PM_REDUCTION_DIM")))))
        deg = p.get("PM_PARALLEL_DEGREE",
                    p.get("PM_REPARTITION_DEGREE",
                          p.get("PM_COMBINE_DEGREE",
                                p.get("PM_REPLICATE_DEGREE",
                                      p.get("PM_REDUCTION_DEGREE")))))
        return dim, deg


def _logical_dim(pm_dim: int, ndim: int) -> int:
    """Reference dims are Legion-ordered (innermost first); ours are
    logical (outermost first) — mirror the index."""
    return max(0, min(ndim - 1, ndim - 1 - pm_dim))


@dataclass
class PatternRule:
    """A loaded rule, usable as a GraphXfer (same find_matches/apply
    duck type as search.substitution.GraphXfer).

    ``anchor_types`` follows the GraphXfer contract (the
    per-op-type seed index): the rule's ROOT pattern op — matched
    first by the backtracking engine — can only bind nodes of its own
    declared type, so ``find_matches`` consults the per-op-type index
    for every pattern position instead of sweeping ``graph.nodes``
    per position.  Identity with the unindexed full scan (as a match
    SET — the index enumerates candidates in topo order, the full
    scan in node-dict order) is asserted under
    ``FLEXFLOW_TPU_DELTA_CHECK``."""

    name: str
    src_ops: List[PatternOp]
    dst_ops: List[PatternOp]
    mapped_outputs: List[Tuple[int, int, int, int]]  # (srcOp, srcTs, dstOp, dstTs)
    anchor_types: Optional[frozenset] = None

    # -- matching ----------------------------------------------------------
    def find_matches(self, graph: Graph) -> List[Dict[int, int]]:
        """All bindings {pattern_op_index: node_guid}."""
        from flexflow_tpu_torch.search.substitution import (
            DELTA_MATCH_CHECK,
            _INDEX_SKIPS,
            _op_type_index,
        )

        matches: List[Dict[int, int]] = []
        if self.anchor_types is None:
            self._extend(graph, {}, {}, 0, matches, limit=16)
            return matches
        idx, pos = _op_type_index(graph)
        root = self.src_ops[0].type
        _INDEX_SKIPS.inc(len(pos) - len(idx.get(root, ())))
        self._extend(graph, {}, {}, 0, matches, limit=16, index=idx)
        if DELTA_MATCH_CHECK:
            full: List[Dict[int, int]] = []
            self._extend(graph, {}, {}, 0, full, limit=16)
            if len(matches) < 16 and len(full) < 16:
                # un-truncated scans must find the same binding SET;
                # at the limit the two enumeration orders may keep
                # different 16, which is not a divergence
                a = sorted(tuple(sorted(m.items())) for m in matches)
                b = sorted(tuple(sorted(m.items())) for m in full)
                assert a == b, (
                    f"indexed find_matches diverged from the full scan "
                    f"for {self.name}: the root pattern type "
                    f"{root.value!r} does not cover the matcher")
        return matches

    def _extend(self, graph, binding, ext_inputs, i, out, limit,
                index=None):
        if len(out) >= limit:
            return
        if i == len(self.src_ops):
            if self._escape_check(graph, binding):
                out.append(dict(binding))
            return
        pat = self.src_ops[i]
        if index is None:
            cands = graph.nodes.items()
        else:
            # per-type topo-ordered candidates: every non-pat.type node
            # fails the type test below anyway — skip the sweep
            cands = ((n.guid, n) for n in index.get(pat.type, ()))
        for guid, node in cands:
            if guid in binding.values():
                continue
            if node.op.op_type is not pat.type:
                continue
            if not self._node_params_ok(node, pat):
                continue
            ok = True
            new_ext = dict(ext_inputs)
            in_edges = graph.in_edges[guid]
            for slot, (src_id, ts_id) in enumerate(pat.inputs):
                e = next((e for e in in_edges if e.dst_idx == slot), None)
                if e is None:
                    # no tensor edge at this slot.  The TASO corpus wires
                    # weights as explicit pattern inputs (linear = (x, w));
                    # our ops OWN their weights, so an external ref with no
                    # edge binds the op's own weight tensor instead.
                    # Externals are identified by their negative opId —
                    # tsId is 0 throughout the corpus: keying by tsId
                    # would conflate distinct externals (-1 vs -2) and
                    # only ever match rules whose externals coincide.
                    if src_id < 0 and node.op._weight_specs:
                        srcref = ("w", guid, slot)
                        if src_id in new_ext and new_ext[src_id] != srcref:
                            ok = False
                            break
                        new_ext[src_id] = srcref
                        continue
                    ok = False
                    break
                if src_id >= 0:
                    # must come from the already-bound pattern op
                    bound = binding.get(src_id)
                    if bound is None or e.src != bound or e.src_idx != ts_id:
                        ok = False
                        break
                else:
                    srcref = (e.src, e.src_idx)
                    if src_id in new_ext and new_ext[src_id] != srcref:
                        ok = False
                        break
                    new_ext[src_id] = srcref
            if not ok:
                continue
            binding[i] = guid
            self._extend(graph, binding, new_ext, i + 1, out, limit,
                         index=index)
            del binding[i]

    def _node_params_ok(self, node: Node, pat: PatternOp) -> bool:
        if pat.type in _PARALLEL_TYPES:
            dim, deg = pat.parallel_dim_degree()
            if deg is not None and node.op.attrs.get("degree") != deg:
                return False
            if (
                dim is not None
                and pat.type in (OperatorType.REPARTITION, OperatorType.COMBINE)
            ):
                ndim = node.op.output_shapes[0].ndim
                if node.op.attrs.get("dim") != _logical_dim(dim, ndim):
                    return False
        if "PM_ACTI" in pat.params and pat.type is OperatorType.LINEAR:
            # TASO rules distinguish fused-activation linears (e.g.
            # taso_rule_257 rewrites a relu twin differently); matching
            # a none-activation node with a relu pattern would rewrite
            # to a semantically different graph
            want = _ACTI_MAP.get(pat.params["PM_ACTI"], "?")
            if node.op.attrs.get("activation") != want:
                return False
        return True

    def _escape_check(self, graph, binding) -> bool:
        """Every tensor produced inside the pattern and consumed outside
        must be a mapped output."""
        mapped = {(s_op, s_ts) for s_op, s_ts, _, _ in self.mapped_outputs}
        bound_guids = set(binding.values())
        for p_idx, guid in binding.items():
            for e in graph.out_edges[guid]:
                if e.dst in bound_guids:
                    continue
                if (p_idx, e.src_idx) not in mapped:
                    return False
        return True

    # -- application -------------------------------------------------------
    def apply(self, graph: Graph, match: Dict[int, int]) -> Optional[Graph]:
        g = graph.copy()
        # resolve external inputs from the matched source ops; externals
        # with no tensor edge are the matched op's OWN weights (see
        # _extend) and resolve to their owner for donor lookup
        ext: Dict[int, Tuple[int, int]] = {}  # external opId -> tensor ref
        w_ext: Dict[int, int] = {}  # external opId -> owning node guid
        for p_idx, guid in match.items():
            pat = self.src_ops[p_idx]
            for slot, (src_id, ts_id) in enumerate(pat.inputs):
                if src_id < 0:
                    e = next(
                        (e for e in g.in_edges[guid] if e.dst_idx == slot), None
                    )
                    if e is None:
                        if graph.nodes[guid].op._weight_specs:
                            w_ext[src_id] = guid
                            continue
                        return None
                    ext[src_id] = (e.src, e.src_idx)

        # collect external consumers of mapped outputs before deletion,
        # remembering the shape each consumer expects
        rewires: List[Tuple[Edge, int, int, Tuple[int, ...]]] = []
        bound = set(match.values())
        for s_op, s_ts, d_op, d_ts in self.mapped_outputs:
            guid = match.get(s_op)
            if guid is None:
                return None
            old_shape = tuple(g.nodes[guid].op.output_shapes[s_ts].sizes)
            for e in list(g.out_edges[guid]):
                if e.dst not in bound and e.src_idx == s_ts:
                    rewires.append((e, d_op, d_ts, old_shape))

        # instantiate destination ops in index order (inputs may only
        # reference lower indices or externals, which holds for the
        # reference corpus)
        new_nodes: Dict[int, Node] = {}
        for d_idx, dpat in enumerate(self.dst_ops):
            in_refs = []
            donor_hint: Optional[int] = None
            for (src_id, ts_id) in dpat.inputs:
                if src_id < 0:
                    if src_id in ext:
                        in_refs.append(ext[src_id])
                    elif src_id in w_ext:
                        # weight slot: our dst op owns its weight — no
                        # edge; the weight's owner is the attr donor
                        donor_hint = w_ext[src_id]
                    else:
                        return None
                else:
                    dn = new_nodes.get(src_id)
                    if dn is None:
                        return None
                    in_refs.append((dn.guid, ts_id))
            in_shapes = []
            for (src_guid, src_idx) in in_refs:
                src_node = g.nodes.get(src_guid)  # includes new nodes
                if src_node is None or src_idx >= len(src_node.op.output_shapes):
                    return None
                in_shapes.append(src_node.op.output_shapes[src_idx])
            op = self._make_dst_op(dpat, in_shapes, match, graph, donor_hint,
                                   work_graph=g, in_refs=in_refs)
            if op is None:
                return None
            node = Node(g._next_guid, op)
            g._next_guid += 1
            g.add_node(node)
            for slot, (src_guid, src_idx) in enumerate(in_refs):
                e = Edge(src_guid, node.guid, src_idx, slot)
                g.out_edges[src_guid].append(e)
                g.in_edges[node.guid].append(e)
            new_nodes[d_idx] = node

        # delete matched source ops, then rewire external consumers
        for guid in match.values():
            g.remove_node(guid)
        for old_e, d_op, d_ts, old_shape in rewires:
            dn = new_nodes.get(d_op)
            if dn is None:
                return None
            if (d_ts >= len(dn.op.output_shapes)
                    or tuple(dn.op.output_shapes[d_ts].sizes) != old_shape):
                # the instantiated dst graph does not reproduce the
                # tensor this consumer was reading — reject instead of
                # silently corrupting downstream shapes
                return None
            ne = Edge(dn.guid, old_e.dst, d_ts, old_e.dst_idx)
            g.out_edges[dn.guid].append(ne)
            g.in_edges[old_e.dst].append(ne)
        g._invalidate()
        try:
            g.topo_order()
        except ValueError:
            return None
        return g

    def _donor_pattern_idx(self, dpat: PatternOp) -> Optional[int]:
        """Which source-pattern op donates attrs to ``dpat``: the unique
        same-typed param-consistent src op, or — with several
        candidates — the one sharing an external input id (the corpus
        wires each op's weight as a distinct external tensor ``-k``, so
        sharing the id identifies the pre-rewrite twin, the reference's
        matchOpX convention)."""

        # PM_ACTI is overridden from dpat at instantiation (see
        # _make_dst_op), so donors may legitimately differ on it (the
        # relu-fusion family, e.g. taso_rule_257's dst relu-linear
        # donates from the plain src linear)
        overridable = (
            {"PM_ACTI"} if dpat.type is OperatorType.LINEAR else set()
        )

        def params_consistent(s: PatternOp) -> bool:
            shared = (set(s.params) & set(dpat.params)) - overridable
            return all(s.params[k] == dpat.params[k] for k in shared)

        cands = [
            i for i, s in enumerate(self.src_ops)
            if s.type is dpat.type and params_consistent(s)
        ]
        if len(cands) == 1:
            return cands[0]
        # several candidates: the pre-rewrite twin is the one sharing an
        # external tensor id — externals are identified by their
        # (negative) opId; tsId is 0 throughout the corpus and
        # identifies nothing
        d_ext = {sid for (sid, ts) in dpat.inputs if sid < 0}
        ext_matches = [
            i for i in cands
            if d_ext & {sid for (sid, ts) in self.src_ops[i].inputs
                        if sid < 0}
        ]
        if len(ext_matches) == 1:
            return ext_matches[0]
        pool = ext_matches or cands
        if not pool:
            return None
        # still ambiguous: prefer an exact-param twin (e.g. the same
        # PM_ACTI); otherwise any candidate works IF the pool is
        # mutually param-identical modulo overridable keys (rule 257:
        # two linears sharing weight -4, differing only in fused acti) —
        # apply-time shape re-propagation rejects bad instantiations
        exact = [
            i for i in pool
            if self.src_ops[i].params == dpat.params
        ]
        if len(exact) == 1:
            return exact[0]
        first = self.src_ops[pool[0]]
        if all(
            {k: v for k, v in self.src_ops[i].params.items()
             if k not in overridable}
            == {k: v for k, v in first.params.items() if k not in overridable}
            for i in pool[1:]
        ):
            return pool[0]
        return None

    def _make_dst_op(self, dpat: PatternOp, in_shapes, match, src_graph,
                     donor_hint: Optional[int] = None,
                     work_graph=None, in_refs=None):
        if dpat.type in _PARALLEL_TYPES:
            dim, deg = dpat.parallel_dim_degree()
            if deg is None:
                return None
            shape = in_shapes[0]
            if dpat.type is OperatorType.REPARTITION:
                ld = _logical_dim(dim or 0, shape.ndim)
                if shape.sizes[ld] % deg != 0:
                    return None
                return RepartitionOp(_un("repartition"), [shape], dim=ld, degree=deg)
            if dpat.type is OperatorType.COMBINE:
                ld = _logical_dim(dim or 0, shape.ndim)
                return CombineOp(_un("combine"), [shape], dim=ld, degree=1)
            if dpat.type is OperatorType.REPLICATE:
                return ReplicateOp(_un("replicate"), [shape], degree=deg)
            return ReductionOp(_un("reduction"), [shape], degree=deg)
        # compute op: clone a source op's attributes.  Donor priority:
        # the weight owner bound to this dst op's weight slot, then the
        # external-id-matched pattern twin, then the unique same-typed
        # source; some types need no donor at all (shapes + params
        # suffice).
        donor = None
        if donor_hint is not None and (
            src_graph.nodes[donor_hint].op.op_type is dpat.type
        ):
            donor = src_graph.nodes[donor_hint].op
        if donor is None:
            di = self._donor_pattern_idx(dpat)
            if di is not None and di in match:
                donor = src_graph.nodes[match[di]].op
        if donor is not None:
            try:
                attrs = dict(donor.attrs)
                if "PM_ACTI" in dpat.params and dpat.type is OperatorType.LINEAR:
                    # the dst op's own declared activation wins over the
                    # donor's (e.g. taso_rule_257 fuses the src relu
                    # INTO the rewritten linear)
                    attrs["activation"] = _ACTI_MAP.get(
                        dpat.params["PM_ACTI"])
                return type(donor)(
                    _un(donor.name), list(in_shapes), **attrs
                )
            except Exception:
                return None
        if dpat.type not in _DONORLESS_TYPES or not in_shapes:
            return None
        try:
            if dpat.type is OperatorType.CONCAT:
                nd = dpat.params.get("PM_NUMDIM", in_shapes[0].ndim)
                ax = _logical_dim(dpat.params.get("PM_AXIS", 0), nd)
                from flexflow_tpu_torch.ops.shape_ops import ConcatOp

                return ConcatOp(_un("concat"), list(in_shapes), axis=ax)
            if dpat.type is OperatorType.SPLIT:
                # batched-communication rules (taso_rule_419 family):
                # split sizes come from the upstream dst Concat this
                # Split undoes — trace through intervening parallel ops
                n_out = dpat.params.get("PM_NUM_OUTPUTS")
                if not n_out:
                    return None
                ax = _logical_dim(dpat.params.get("PM_AXIS", 0),
                                  in_shapes[0].ndim)
                from flexflow_tpu_torch.ops.shape_ops import (
                    ConcatOp,
                    SplitOp,
                )

                sizes = None
                if work_graph is not None and in_refs:
                    node = work_graph.nodes.get(in_refs[0][0])
                    for _ in range(8):
                        if node is None:
                            break
                        if isinstance(node.op, ConcatOp):
                            if node.op.attrs.get("axis") == ax and len(
                                    node.op.input_shapes) == n_out:
                                sizes = [s.sizes[ax]
                                         for s in node.op.input_shapes]
                            break
                        if node.op.op_type not in _PARALLEL_TYPES:
                            break
                        e = next((e for e in work_graph.in_edges[node.guid]
                                  if e.dst_idx == 0), None)
                        node = work_graph.nodes.get(e.src) if e else None
                if sizes is None:
                    if in_shapes[0].sizes[ax] % n_out != 0:
                        return None
                    sizes = [in_shapes[0].sizes[ax] // n_out] * n_out
                if sum(sizes) != in_shapes[0].sizes[ax]:
                    return None
                return SplitOp(_un("split"), [in_shapes[0]],
                               sizes=tuple(sizes), axis=ax)
            from flexflow_tpu_torch.ops.elementwise import (
                ElementBinaryOp,
                ElementUnaryOp,
            )

            if dpat.type in _EW_BINARY_TYPES:
                if len(in_shapes) != 2:
                    return None
                return ElementBinaryOp(
                    _un(dpat.type.value), list(in_shapes),
                    binary_type=dpat.type,
                )
            if dpat.type in _UNARY_TYPES:
                return ElementUnaryOp(
                    _un(dpat.type.value), [in_shapes[0]],
                    unary_type=dpat.type,
                )
        except Exception:
            return None
        return None


def _un(base: str) -> str:
    from flexflow_tpu_torch.search.substitution import _uname

    return _uname(base)


# ---------------------------------------------------------------------------
def load_rule_collection(path: str) -> Tuple[List[PatternRule], int]:
    """Parse a reference-format rule JSON.  Returns (usable rules,
    skipped count)."""
    with open(path) as f:
        data = json.load(f)
    raw_rules = data["rule"] if isinstance(data, dict) else data
    rules: List[PatternRule] = []
    skipped = 0
    for r in raw_rules:
        rule = _parse_rule(r)
        if rule is None:
            skipped += 1
        else:
            rules.append(rule)
    return rules, skipped


def _parse_rule(r: dict) -> Optional[PatternRule]:
    def parse_ops(lst) -> Optional[List[PatternOp]]:
        out = []
        for o in lst:
            t = _OP_TYPES.get(o.get("type"))
            if t is None:
                return None
            inputs = [(i["opId"], i["tsId"]) for i in o.get("input", [])]
            params = {p["key"]: p["value"] for p in o.get("para", [])}
            out.append(PatternOp(type=t, inputs=inputs, params=params))
        return out

    src = parse_ops(r.get("srcOp", []))
    dst = parse_ops(r.get("dstOp", []))
    if not src or dst is None:
        return None
    # dst wiring must be forward-referencing for one-pass instantiation
    for i, d in enumerate(dst):
        for (src_id, _) in d.inputs:
            if src_id >= i:
                return None
    # dst compute ops need an attr donor (unique same-type src op, or
    # an external-id-matched twin) unless the type is constructible
    # from shapes + params alone
    rule_probe = PatternRule(name="", src_ops=src, dst_ops=dst,
                             mapped_outputs=[])
    for d in dst:
        if d.type in _PARALLEL_TYPES or d.type in _DONORLESS_TYPES:
            continue
        if rule_probe._donor_pattern_idx(d) is None:
            return None
    mapped = [
        (m["srcOpId"], m["srcTsId"], m["dstOpId"], m["dstTsId"])
        for m in r.get("mappedOutput", [])
    ]
    if not mapped:
        return None
    return PatternRule(
        name=r.get("name", "json_rule"),
        src_ops=src,
        dst_ops=dst,
        mapped_outputs=mapped,
        # the root pattern op is matched FIRST by the backtracking
        # engine, so its type is a sound anchor: no match can exist in
        # a graph with no node of this type (per-op-type seed index;
        # identity asserted under FLEXFLOW_TPU_DELTA_CHECK)
        anchor_types=frozenset({src[0].type}),
    )


def load_substitution_json(path: str, max_rules: int = 0) -> List[PatternRule]:
    """Public entry: rules usable as GraphXfers (find_matches/apply).
    ``max_rules`` > 0 truncates (search-time control)."""
    rules, skipped = load_rule_collection(path)
    from flexflow_tpu_torch.utils.logging import SEARCH_LOG as log

    log.log(
        f"substitution json {path}: loaded {len(rules)} rules, "
        f"skipped {skipped} outside the supported subset"
    )
    if max_rules > 0:
        rules = rules[:max_rules]
    return rules
