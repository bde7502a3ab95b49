"""The port's sharding hooks against the JAX package's.

``build_gpt``, ``build_transformer``, ``build_gpt_decode`` and the
models of ``__graft_entry__.py``'s dp x tp, sp and Ulysses legs are
built at tiny widths in both packages, plus one of each parallel op.
For every node, every view that its ``splittable_output_dims()`` and
``max_replica_degree()`` allow, with degrees dividing 8 and at most 8
parts, is checked:

* ``propagate(mv)`` equal field for field (degrees, replica, partial,
  idx of every input, weight and output annotation);
* ``view_slot_axes`` equal on mesh pools of 2, 4 and 8 ranks (or both
  refusing the view);
* ``ParallelTensorShape``'s parallel methods equal on the op's output
  shapes laid out by that view;
* and per op ``signature()``, ``splittable_output_dims()``,
  ``max_replica_degree()`` and ``fixed_machine_view()``.

One parametrised test per op family, so each family counts.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu.core.machine import MachineView as JView
from flexflow_tpu.core.ptensor import ParallelTensorShape as JShape
from flexflow_tpu.models import build_gpt as j_build_gpt
from flexflow_tpu.models import build_gpt_decode as j_build_gpt_decode
from flexflow_tpu.models import build_transformer as j_build_transformer
from flexflow_tpu.parallel import mesh as jmesh

import flexflow_tpu_torch as tff
from flexflow_tpu_torch.core.machine import MachineView as TView
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape as TShape
from flexflow_tpu_torch.models import build_gpt as t_build_gpt
from flexflow_tpu_torch.models import build_gpt_decode as t_build_gpt_decode
from flexflow_tpu_torch.models import build_transformer as t_build_transformer
from flexflow_tpu_torch.parallel import mesh as tmesh

DEGREES = (1, 2, 4, 8)
POOLS = (2, 4, 8)


def _cfgs(batch):
    return (ff.FFConfig(batch_size=batch, num_devices=1, cost_cache_file=""),
            tff.FFConfig(batch_size=batch, device="cpu"))


def _ulysses_leg(pkg, cfg):
    """__graft_entry__.py:192-199: one Ulysses MHA and a dense head."""
    m = pkg.FFModel(cfg)
    x = m.create_tensor([cfg.batch_size, 8, 32], name="tok")
    t = m.multihead_attention(x, x, x, embed_dim=32, num_heads=4,
                              causal=True, sp_mode="ulysses", name="umha")
    m.dense(t, 32, name="uhead")
    return m


def _parallel_ops(pkg, cfg):
    """One of each parallel op on a [B, S, E] stream."""
    m = pkg.FFModel(cfg)
    x = m.create_tensor([cfg.batch_size, 8, 32], name="x")
    t = m.repartition(x, dim=1, degree=2, name="rep")
    t = m.combine(t, dim=1, degree=1, name="comb")
    t = m.replicate(t, degree=2, name="repl")
    m.reduction(t, degree=2, name="red")
    return m


def _model_pairs():
    """(name, reference model, port model) at tiny widths."""
    pairs = []
    jc, tc = _cfgs(4)
    gpt = dict(vocab=64, num_layers=1, hidden=32, num_heads=4, ff_dim=64,
               seq_len=16)
    pairs.append(("gpt", j_build_gpt(jc, **gpt), t_build_gpt(tc, **gpt)))
    tr = dict(num_layers=1, hidden=32, num_heads=4, ff_dim=64, seq_len=8)
    pairs.append(("transformer", j_build_transformer(jc, **tr),
                  t_build_transformer(tc, **tr)))
    pairs.append(("sp_leg", j_build_transformer(jc, causal=True, **tr),
                  t_build_transformer(tc, causal=True, **tr)))
    dec = dict(vocab=64, num_layers=1, hidden=32, num_heads=4, ff_dim=64,
               page_size=4, pages_per_seq=4)
    pairs.append(("gpt_decode", j_build_gpt_decode(jc, **dec),
                  t_build_gpt_decode(tc, **dec)))
    pairs.append(("ulysses_leg", _ulysses_leg(ff, jc),
                  _ulysses_leg(tff, tc)))
    pairs.append(("parallel_ops", _parallel_ops(ff, jc),
                  _parallel_ops(tff, tc)))
    return pairs


@pytest.fixture(scope="module")
def node_pairs():
    """Every (reference op, port op) pair, matched by op name."""
    out = []
    for name, jm, tm in _model_pairs():
        tops = {n.op.name: n.op for n in tm.graph.topo_order()}
        jops = [n.op for n in jm.graph.topo_order()]
        assert sorted(tops) == sorted(o.name for o in jops), name
        out += [(jo, tops[jo.name]) for jo in jops]
    return out


def _views(op):
    """Every view the op's hooks allow with degrees dividing 8 and at
    most 8 parts."""
    out = op.output_shapes[0]
    split = set(op.splittable_output_dims())
    per_dim = [[d for d in DEGREES if (i in split or d == 1)
                and out.sizes[i] % d == 0] for i in range(out.ndim)]
    reps = [r for r in DEGREES if r <= op.max_replica_degree()]
    for degs in itertools.product(*per_dim):
        for r in reps:
            if int(np.prod(degs)) * r <= 8:
                yield degs, r


def _annot(a):
    return None if a is None else (tuple(a.degrees), a.replica, a.partial,
                                   tuple(a.parallel_idx()))


def _sharding(osh):
    return ([_annot(a) for a in osh.inputs], [_annot(a) for a in osh.weights],
            [_annot(a) for a in osh.outputs])


def _propagate(op, view):
    try:
        return _sharding(op.propagate(view))
    except AssertionError as e:  # a view the op's rule refuses
        return ("refused", type(e).__name__)


def _slot_axes(fn, view, pool):
    try:
        return fn(view, pool)
    except ValueError:
        return "refused"


def _shape_methods(cls, shape, degrees, axes):
    """Every parallel method of ``cls`` on ``shape`` laid out by
    ``degrees`` over ``axes``."""
    s = cls.make(shape.sizes, shape.dtype.value, degrees=degrees, axes=axes)
    used = s.used_axes()
    rep = s.with_replica(2, ("r0",))
    d0 = s.with_dim_degree(0, 1)
    return (s.sizes, s.degrees, s.num_elements, s.num_bytes, s.total_degree,
            s.replica_degree, s.shard_sizes, s.shard_bytes, used,
            rep.replica_degree, rep.total_degree, rep.used_axes(),
            rep.with_replica(1).replica_degree, d0.degrees, d0.used_axes(),
            s.drop_parallelism().degrees, s.drop_parallelism().logical_eq(s),
            str(s), str(rep))


def _signature(op):
    """``signature()``; an input's last entry is its frontend tensor's
    guid, a per-process counter, so it is left out."""
    sig = op.signature()
    return sig[:3] if op.op_type.value == "input" else sig


def _check_family(node_pairs, family):
    pairs = [(j, t) for j, t in node_pairs if j.op_type.value in family]
    assert pairs, family
    checked = 0
    for jop, top in pairs:
        assert _signature(top) == _signature(jop), jop.name
        assert top.splittable_output_dims() == jop.splittable_output_dims()
        assert top.max_replica_degree() == jop.max_replica_degree()
        jf, tf_ = jop.fixed_machine_view(), top.fixed_machine_view()
        assert (jf is None) == (tf_ is None)
        if jf is not None:
            assert (tf_.dim_degrees, tf_.replica_degree) == (
                jf.dim_degrees, jf.replica_degree)
        for degs, r in _views(jop):
            jv, tv = JView(degs, replica_degree=r), TView(degs,
                                                          replica_degree=r)
            assert str(tv) == str(jv)
            assert (tv.num_parts, tv.is_trivial) == (jv.num_parts,
                                                     jv.is_trivial)
            assert _propagate(top, tv) == _propagate(jop, jv), (
                jop.name, degs, r)
            for n in POOLS:
                pool = jmesh.mesh_axis_sizes(n)
                assert tmesh.mesh_axis_sizes(n) == pool
                slots = _slot_axes(jmesh.view_slot_axes, jv, pool)
                assert _slot_axes(tmesh.view_slot_axes, tv, pool) == slots
                if slots == "refused":
                    continue
                for js, ts in zip(jop.output_shapes, top.output_shapes):
                    axes = [slots[i] if degs[i] > 1 else ()
                            for i in range(len(degs))]
                    assert (_shape_methods(TShape, ts, degs, axes)
                            == _shape_methods(JShape, js, degs, axes))
            checked += 1
    return checked


FAMILIES = {
    "linear": ("linear",),
    "attention": ("multihead_attention",),
    "embedding": ("embedding",),
    "layernorm": ("layernorm",),
    "elementwise": ("ew_add",),
    "input": ("input",),
    "constant": ("constant",),
    "reshape": ("reshape",),
    "decode_attention": ("decode_attention",),
    "parallel_ops": ("repartition", "combine", "replicate", "reduction"),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_propagates_as_the_reference(node_pairs, family):
    assert _check_family(node_pairs, FAMILIES[family]) > 0


def test_megatron_views_share_axes():
    """MHA (dp, 1, 1) r tp, ff1 (dp, 1, tp) and ff2 (dp, 1, 1) r tp
    compose with no data movement: ff1's out-dim slot and ff2's replica
    slot take the same axis, and so do MHA's and ff2's replica slots."""
    for n, dp, tp in ((4, 2, 2), (8, 2, 4), (8, 4, 2)):
        pool = tmesh.mesh_axis_sizes(n)
        mha = tmesh.view_slot_axes(TView((dp, 1, 1), tp), pool)
        ff1 = tmesh.view_slot_axes(TView((dp, 1, tp)), pool)
        ff2 = tmesh.view_slot_axes(TView((dp, 1, 1), tp), pool)
        assert ff1[2] == ff2[-2] == mha[-2]
        assert ff1[0] == ff2[0] == mha[0]
