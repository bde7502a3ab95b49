"""The port's rewrite proofs (``analysis/equivalence.py``,
``analysis/proofgen.py``) and its hot-swap lint (``analysis/swap.py``)
against the JAX package's.

The tests mirror the reference's proof tests in tests/test_analysis.py.
Each builds the same graph in both packages (the same op names, so the
same guids), runs the same proof with the same seed, and holds the
port's findings to the reference's: the same codes, nodes, ops and
severities, and the numbers in the messages (the unsound rewrite's max
abs diff) within 1e-6 relative.  The port draws the reference's
weights (its numpy threefry, checked here against ``jax.random``
directly) and evaluates with its own op forwards in fp32 on the CPU.
The whole registry is proven by the port alone (about 3 s); the
reference's generated proof of the whole registry takes about 30 s,
so the two packages' findings and stats are held equal on one rewrite
of each generated family.
"""

from __future__ import annotations

import functools
import re
import zlib

import jax
import numpy as np
import pytest

import flexflow_tpu as ff
import flexflow_tpu_torch as tff
from flexflow_tpu.compiler.lowering import (
    data_parallel_strategy as jax_dp_strategy,
)
from flexflow_tpu_torch.analysis import (
    GraphInvariantError,
    check_graph,
    set_verify,
    verification_enabled,
)
from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
from flexflow_tpu_torch.core.machine import MachineView

_NUM = re.compile(r"[-+]?\d+\.\d+e[-+]\d+")


def codes(findings):
    return {f.code for f in findings}


def _key(f):
    return (f.code, f.node, f.op, f.severity, _NUM.sub("#", f.message))


def assert_same_findings(got, ref):
    """Codes, nodes, ops and severities equal; each number within 1e-6
    relative."""
    assert sorted(map(_key, got)) == sorted(map(_key, ref)), (
        [str(f) for f in got], [str(f) for f in ref])
    by = {_key(f): f for f in ref}
    for f in got:
        a = [float(x) for x in _NUM.findall(f.message)]
        b = [float(x) for x in _NUM.findall(by[_key(f)].message)]
        np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=f.message)


# ---------------------------------------------------------------------------
def test_make_weights_draws_the_reference_weights():
    """The port's threefry-2x32 keys and uniform draws are
    ``jax.random``'s bit for bit; its normal draws within 3e-6 (the
    inverse error function's float32 rounding); ``make_weights`` on a
    graph gives the reference's weights."""
    from flexflow_tpu.analysis.equivalence import make_weights as jax_weights
    from flexflow_tpu_torch.analysis import equivalence as E

    for seed in (0, 5):
        for name in ("pf_fc1/kernel", "pg_emb/table"):
            d = zlib.crc32(name.encode()) & 0x7FFFFFFF
            k = jax.random.fold_in(jax.random.key(seed), d)
            mine = E._fold_in(E._key(seed), d)
            assert tuple(int(v) for v in np.asarray(
                jax.random.key_data(k))) == mine
            for shape in ((16, 16), (3, 5, 7)):
                np.testing.assert_array_equal(
                    E._uniform(mine, shape, -0.3, 0.3),
                    np.asarray(jax.random.uniform(k, shape, np.float32,
                                                  -0.3, 0.3)))
                np.testing.assert_allclose(
                    E._normal(mine, shape),
                    np.asarray(jax.random.normal(k, shape, np.float32)),
                    atol=3e-6)

    def graph(pkg):
        m = pkg.FFModel(_cfg(pkg))
        ids = m.create_tensor([8, 2], dtype="int32", name="w_ids")
        t = m.embedding(ids, 16, 8, aggr="sum", name="w_emb")
        m.dense(t, 4, name="w_head")
        return m.graph

    ref, got = jax_weights(graph(ff), 3), E.make_weights(graph(tff), 3)
    assert ref.keys() == got.keys()
    for g, ws in ref.items():
        for w, v in ws.items():
            np.testing.assert_allclose(got[g][w], np.asarray(v), atol=3e-7)


def _cfg(pkg):
    kw = {"device": "cpu"} if pkg is tff else {}
    return pkg.FFConfig(batch_size=8, num_devices=8,
                        only_data_parallel=True, **kw)


def test_registry_equivalence_proof():
    """Every registered rewrite matches a hand-zoo proof graph, rewrites
    it into a well-formed graph and preserves every surviving node's
    value, in the port as in the reference."""
    from flexflow_tpu.analysis.equivalence import (
        verify_registry as jax_verify,
    )
    from flexflow_tpu_torch.analysis.equivalence import verify_registry

    findings = verify_registry(num_devices=8, device="cpu")
    assert findings == [], [str(f) for f in findings]
    assert_same_findings(findings, jax_verify(num_devices=8))


def _drop_relu(pkg):
    """The reference's seeded unsound rewrite: splice out a relu."""
    T = pkg.core.optype.OperatorType
    sub = pkg.search.substitution

    def matcher(graph, node):
        return (node.op.op_type is T.RELU and graph.in_edges[node.guid]
                and graph.out_edges[node.guid])

    def apply_fn(graph, node):
        g = graph.copy()
        if sub._bypass_node(g, node.guid) is None:
            return None
        return g

    return sub.GraphXfer(name="drop_relu_unsound", matcher=matcher,
                         apply_fn=apply_fn)


def _eq_model(pkg):
    m = pkg.FFModel(_cfg(pkg))
    x = m.create_tensor([8, 16], name="eq_x")
    t = m.dense(x, 16, name="eq_fc")
    t = m.relu(t, name="eq_act")
    m.dense(t, 4, name="eq_head")
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_equivalence_catches_semantics_change(seed):
    """A rewrite that splices out a relu fails the numeric proof with
    EQV301 on the head, with the reference's max abs diff."""
    import flexflow_tpu.search.substitution  # noqa: F401
    import flexflow_tpu_torch.search.substitution  # noqa: F401
    from flexflow_tpu.analysis.equivalence import verify_rewrite as jax_vr
    from flexflow_tpu_torch.analysis.equivalence import verify_rewrite

    out = {}
    port_vr = functools.partial(verify_rewrite, device="cpu")
    for pkg, vr in ((ff, jax_vr), (tff, port_vr)):
        m = _eq_model(pkg)
        bad = _drop_relu(pkg)
        matches = bad.find_matches(m.graph)
        assert matches
        out[pkg.__name__] = vr(m.graph, bad, matches[0], seed=seed)
    got = out["flexflow_tpu_torch"]
    assert "EQV301" in codes(got), [str(f) for f in got]
    assert_same_findings(got, out["flexflow_tpu"])


def test_verify_hook_catches_corrupting_rewrite():
    """With verification armed, ``GraphXfer.apply`` runs the invariant
    checker and a splice that leaves a consumer reading a deleted guid
    raises PCG003 at the rewrite; unarmed, the corrupt graph comes back
    and the checker flags it."""
    from flexflow_tpu_torch.core.optype import OperatorType
    from flexflow_tpu_torch.search.substitution import GraphXfer

    def matcher(graph, node):
        return node.op.op_type is OperatorType.RELU

    def apply_fn(graph, node):
        g = graph.copy()
        for e in list(g.in_edges[node.guid]):
            g.out_edges[e.src] = [x for x in g.out_edges[e.src]
                                  if x is not e]
        g.in_edges.pop(node.guid)
        g.out_edges.pop(node.guid)
        g.nodes.pop(node.guid)
        g._invalidate()
        return g

    corrupt = GraphXfer(name="corrupting_rewrite", matcher=matcher,
                        apply_fn=apply_fn)
    m = tff.FFModel(_cfg(tff))
    x = m.create_tensor([8, 16], name="vh_x")
    t = m.relu(x, name="vh_act")
    m.dense(t, 4, name="vh_head")
    match = corrupt.find_matches(m.graph)[0]
    was = verification_enabled()
    set_verify(True)
    try:
        with pytest.raises(GraphInvariantError) as ei:
            corrupt.apply(m.graph, match)
        assert "PCG003" in {f.code for f in ei.value.findings}
    finally:
        set_verify(was)
    g_bad = corrupt.apply(m.graph, match)
    assert g_bad is not None and "PCG003" in codes(check_graph(g_bad))


def test_registry_generated_proof_zero_eqv305():
    """Every factory rewrite of the port's registry anchors on generated
    graphs and passes the proof there, on both float lanes and the
    int32 lane, with no EQV3xx finding."""
    from flexflow_tpu_torch.analysis.proofgen import verify_registry_generated

    findings, stats = verify_registry_generated(num_devices=8, seed=0,
                                                device="cpu")
    assert findings == [], [str(f) for f in findings]
    assert stats["unproven"] == 0
    assert stats["lanes"]["float32"] == stats["lanes"]["bfloat16"] > 0
    assert stats["lanes"]["int32"] > 0
    assert stats["graphs_generated"] > 0


def _family_sample(pkg):
    """One rewrite of each generated family, by name."""
    xfers = pkg.search.substitution.generate_all_pcg_xfers(8)
    seen, out = set(), []
    for xf in xfers:
        anchors = tuple(sorted(t.value for t in (xf.anchor_types or ())))
        if anchors not in seen:
            seen.add(anchors)
            out.append(xf)
    return out


def test_generated_proofs_equal_the_references_per_family():
    """The generated proofs of one rewrite per anchor family: the same
    (empty) findings and the same stats as the reference's."""
    import flexflow_tpu.search.substitution  # noqa: F401
    import flexflow_tpu_torch.search.substitution  # noqa: F401
    from flexflow_tpu.analysis.proofgen import (
        verify_registry_generated as jax_gen,
    )
    from flexflow_tpu_torch.analysis.proofgen import verify_registry_generated

    mine, ref = _family_sample(tff), _family_sample(ff)
    assert [x.name for x in mine] == [x.name for x in ref]
    got, got_stats = verify_registry_generated(8, seed=0, xfers=mine,
                                               device="cpu")
    want, want_stats = jax_gen(8, seed=0, xfers=ref)
    assert_same_findings(got, want)
    assert got_stats == want_stats


def test_proofgen_generation_is_deterministic():
    """A fixed seed synthesizes the same graphs, and the reference's."""
    from flexflow_tpu.analysis.proofgen import (
        synthesize_anchor_graphs as jax_synth,
    )
    from flexflow_tpu.core.optype import OperatorType as JT
    from flexflow_tpu_torch.analysis.proofgen import synthesize_anchor_graphs
    from flexflow_tpu_torch.core.optype import OperatorType

    def sig(graphs):
        return [(lane, mult, pv, tuple(
            (n.op.op_type.value, tuple(n.op.output_shapes[0].sizes))
            for n in g.topo_order())) for lane, mult, pv, g in graphs]

    for t in ("linear", "embedding", "repartition"):
        a = synthesize_anchor_graphs(OperatorType(t), 8, seed=3)
        b = synthesize_anchor_graphs(OperatorType(t), 8, seed=3)
        assert a and sig(a) == sig(b)
        assert sig(a) == sig(jax_synth(JT(t), 8, seed=3))


def test_proofgen_factory_hole_is_eqv305():
    """A factory rewrite whose anchor type has no motif family is a loud
    EQV305 (error)."""
    from flexflow_tpu_torch.analysis.proofgen import verify_registry_generated
    from flexflow_tpu_torch.core.optype import OperatorType
    from flexflow_tpu_torch.search.substitution import GraphXfer

    bogus = GraphXfer(name="bogus_bmm_xfer", matcher=lambda g, n: False,
                      apply_fn=lambda g, n: None,
                      anchor_types=frozenset({OperatorType.BATCH_MATMUL}))
    findings, stats = verify_registry_generated(num_devices=8, xfers=[bogus],
                                                device="cpu")
    assert codes(findings) == {"EQV305"}
    assert all(f.severity == "error" for f in findings)
    assert stats["unproven"] == 1


def test_proofgen_unproven_json_rule_is_eqv306():
    """A multi-node JSON pattern outside the synthesizer's motif families
    is reported (EQV306, warn), as in the reference."""
    from flexflow_tpu_torch.analysis.proofgen import verify_registry_generated
    from flexflow_tpu_torch.core.optype import OperatorType
    from flexflow_tpu_torch.search.substitution_loader import (
        PatternOp,
        PatternRule,
    )

    rule = PatternRule(
        name="taso_like_double_conv",
        src_ops=[
            PatternOp(type=OperatorType.CONV2D, inputs=[(-1, 0), (-2, 0)]),
            PatternOp(type=OperatorType.CONV2D, inputs=[(0, 0), (-3, 0)]),
        ],
        dst_ops=[
            PatternOp(type=OperatorType.CONV2D, inputs=[(-1, 0), (-2, 0)]),
        ],
        mapped_outputs=[(1, 0, 0, 0)],
        anchor_types=frozenset({OperatorType.CONV2D}),
    )
    findings, stats = verify_registry_generated(num_devices=8, xfers=[rule],
                                                device="cpu")
    assert codes(findings) == {"EQV306"}
    assert all(f.severity == "warn" for f in findings)
    assert stats["unproven"] == 1


# ---------------------------------------------------------------------------
def _small(pkg):
    m = pkg.FFModel(_cfg(pkg))
    x = m.create_tensor([8, 16], name="x")
    t = m.dense(x, 32, activation="relu", name="fc1")
    m.dense(t, 4, name="fc2")
    return m


def test_lint_swap_codes_and_clean_pass():
    """SHD170-172: a clean swap has no findings; a reshaped weight, new op
    state and an uncovered node each report their code, and a bad view
    reports the flat SHD1xx lint's; the same findings as the
    reference's, and one more for the cache op's score (below)."""
    from flexflow_tpu.analysis import lint_swap as jax_lint
    from flexflow_tpu_torch.analysis import lint_swap

    def cases(pkg, dp, view):
        m = _small(pkg)
        strat = dp(m.graph, 8)
        other = pkg.FFModel(_cfg(pkg))
        x = other.create_tensor([8, 16], name="x")
        t = other.dense(x, 32, activation="relu", name="fc1")
        t = other.cache(t, name="c0")
        other.dense(t, 8, name="fc2")
        bad = dict(strat)
        bad[m.graph.topo_order()[1].guid] = view((3, 3))
        hole = dict(strat)
        del hole[next(g for g in hole
                      if m.graph.nodes[g].op._weight_specs)]
        return [(m.graph, m.graph, strat), (m.graph, m.graph, bad),
                (m.graph, m.graph, hole),
                (m.graph, other.graph, dp(other.graph, 8))]

    from flexflow_tpu.core.machine import MachineView as JView

    mine = cases(tff, data_parallel_strategy,
                 lambda d: MachineView(dim_degrees=d))
    ref = cases(ff, jax_dp_strategy, lambda d: JView(dim_degrees=d))
    results = []
    for (a, b, s), (ja, jb, js) in zip(mine, ref):
        got = lint_swap(a, b, s, 8)
        # the port's cache op declares its score as op state (a captured
        # step needs the buffer before its first step, ops/moe.py); the
        # reference's score joins the state after the first step, so
        # only the port's lint names it
        score = [f for f in got if "c0/score" in f.message]
        assert [f.code for f in score] == (
            ["SHD171"] if b is not a else [])
        assert_same_findings([f for f in got if f not in score],
                             jax_lint(ja, jb, js, 8))
        results.append(codes(got))
    assert results[0] == set()
    assert any(c.startswith("SHD1") and c < "SHD170" for c in results[1])
    assert "SHD172" in results[2]
    assert {"SHD170", "SHD171"} <= results[3]
