"""The port's MoE ops (``flexflow_tpu_torch/ops/moe.py``) and dispatch
(``kernels/moe_dispatch.py``) against the JAX package's.

* ``dispatch_indices`` and ``moe_dispatch``: positions, validity and
  the slot table integer-exact, the grouped rows bit-equal, including
  capacity overflow (a small ``alpha``) and expert ids out of range
  (negative and >= E), and the rows' gradient.
* ``GroupByOp`` (cap = ceil(alpha K B / E)), ``AggregateOp`` with its
  ``{name}/aux_loss`` balance term, ``AggregateSpecOp`` and ``CacheOp``
  (``{name}/score`` and ``use_cached``): outputs, state and the
  gradients of the float inputs, fp32 within 1e-6 of the largest
  reference value (a gather and a weighted sum: no product order to
  differ); ``propagate`` and the cost hooks under split views equal the
  JAX op's.
* ``build_moe`` (tests/test_models.py's tiny config) with weights
  copied: 3 SGD steps, each step's loss and the aux-loss state within
  1e-5 relative, the weights after them within 1e-5; the gates' top-k
  has no ties (``torch.topk`` and ``jax.lax.top_k`` may order ties
  differently), which the test asserts.  With ``use_cache=True`` the
  cache's score follows the reference's.

The ep-MoE leg (the expert split over 4 ranks) runs in the shared world
of tests/test_torch_zoo.py.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.core.machine import MachineView as JView
from flexflow_tpu.core.ptensor import ParallelTensorShape as JShape
from flexflow_tpu.kernels import moe_dispatch as jdispatch
from flexflow_tpu.models import build_moe as jbuild_moe
from flexflow_tpu.ops.base import LoweringContext as JContext
from flexflow_tpu.ops.moe import AggregateOp as JAggregate
from flexflow_tpu.ops.moe import AggregateSpecOp as JAggregateSpec
from flexflow_tpu.ops.moe import CacheOp as JCache
from flexflow_tpu.ops.moe import GroupByOp as JGroupBy
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.kernels import moe_dispatch
from flexflow_tpu_torch.models import build_moe
from flexflow_tpu_torch.ops import (
    AggregateOp,
    AggregateSpecOp,
    CacheOp,
    GroupByOp,
)
from flexflow_tpu_torch.ops.base import LoweringContext

TOL = 1e-6
STEP_TOL = 1e-5
MOE_KW = dict(in_dim=32, num_classes=4, num_exp=4, num_select=2, hidden=16)
B = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, err


DISPATCH = [  # (tokens, experts, capacity, id range)
    (24, 4, 6, (0, 4)),      # room for every token on average
    (24, 4, 2, (0, 4)),      # overflow: most tokens dropped
    (32, 5, 3, (-2, 7)),     # out-of-range ids, both sides
    (7, 3, 1, (0, 3)),       # capacity 1
    (1, 2, 1, (0, 2)),
]


@pytest.mark.parametrize("t,e,cap,ids", DISPATCH)
def test_dispatch_equals_the_reference_exactly(t, e, cap, ids):
    rng = np.random.default_rng(t * 31 + e)
    flat = rng.integers(ids[0], ids[1], size=t).astype(np.int32)
    src = rng.normal(size=(t, 5)).astype(np.float32)
    pos, valid, table = moe_dispatch.dispatch_indices(
        torch.from_numpy(flat), e, cap)
    jpos, jvalid, jtable = jdispatch.dispatch_indices(jnp.asarray(flat), e,
                                                      cap)
    assert pos.dtype == torch.int32 and table.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    ts = torch.from_numpy(src).requires_grad_(True)
    grouped, pos2, valid2 = moe_dispatch.moe_dispatch(
        ts, torch.from_numpy(flat), e, cap)
    jgrouped, _, _ = jdispatch.moe_dispatch(jnp.asarray(src),
                                            jnp.asarray(flat), e, cap)
    np.testing.assert_array_equal(grouped.detach().numpy(),
                                  np.asarray(jgrouped))
    np.testing.assert_array_equal(pos2.numpy(), np.asarray(jpos))
    g = rng.normal(size=grouped.shape).astype(np.float32)
    grouped.backward(torch.from_numpy(g))
    jg = jax.grad(lambda s: jnp.sum(jdispatch.moe_dispatch(
        s, jnp.asarray(flat), e, cap)[0] * g))(jnp.asarray(src))
    np.testing.assert_array_equal(ts.grad.numpy(), np.asarray(jg))
    if ids[0] < 0 or ids[1] > e:  # out-of-range tokens never take a slot
        bad = (flat < 0) | (flat >= e)
        assert bad.any() and not valid.numpy()[bad].any()


def _moe_shapes(b=8, k=2, d=6, e=4, alpha=1.0, dtype="float32"):
    shapes = [(b, d), (b, k)]
    g = GroupByOp("g", [ParallelTensorShape.make(shapes[0], dtype),
                        ParallelTensorShape.make(shapes[1], "int32")],
                  n_experts=e, alpha=alpha)
    jg = JGroupBy("g", [JShape.make(shapes[0], dtype),
                        JShape.make(shapes[1], "int32")], n_experts=e,
                  alpha=alpha)
    return g, jg


@pytest.mark.parametrize("alpha", [2.0, 1.0, 0.5])
def test_group_by_equals_the_reference(alpha):
    b, k, d, e = 8, 2, 6, 4
    g, jg = _moe_shapes(b, k, d, e, alpha)
    assert g.capacity == jg.capacity == max(1, math.ceil(alpha * k * b / e))
    assert [s.sizes for s in g.output_shapes] == [
        s.sizes for s in jg.output_shapes]
    rng = np.random.default_rng(3)
    data = rng.normal(size=(b, d)).astype(np.float32)
    assign = rng.integers(0, e, size=(b, k)).astype(np.int32)
    td = torch.from_numpy(data).requires_grad_(True)
    outs = g.forward(LoweringContext(), [td, torch.from_numpy(assign)], {})
    jouts = jg.forward(JContext(train=False), [jnp.asarray(data),
                                               jnp.asarray(assign)], {})
    for o, jo in zip(outs, jouts):
        assert str(o.dtype) == f"torch.{jo.dtype}"
        np.testing.assert_array_equal(o.detach().numpy(), np.asarray(jo))
    dy = rng.normal(size=outs[0].shape).astype(np.float32)
    outs[0].backward(torch.from_numpy(dy))
    jgrad = jax.grad(lambda x: jnp.sum(jg.forward(
        JContext(train=False), [x, jnp.asarray(assign)], {})[0] * dy))(
        jnp.asarray(data))
    _close(td.grad, jgrad)


def _combine_inputs(rng, b=8, k=2, d=6, e=4, cap=4, drop=True):
    gates = rng.random(size=(b, k)).astype(np.float32)
    idx = rng.integers(0, e, size=(b, k)).astype(np.int32)
    if drop:
        idx[0, 0] = e + 1  # an out-of-range id: a dropped token
    pos = rng.integers(0, cap, size=(b, k)).astype(np.int32)
    valid = (rng.random(size=(b, k)) > 0.25).astype(np.float32)
    valid[0, 0] = 0.0
    expert_out = rng.normal(size=(e, cap, d)).astype(np.float32)
    return [gates, idx, pos, valid, expert_out]


@pytest.mark.parametrize("spec", [False, True])
@pytest.mark.parametrize("lambda_bal", [0.0, 0.04])
def test_aggregate_equals_the_reference(lambda_bal, spec):
    rng = np.random.default_rng(4)
    xs = _combine_inputs(rng)
    shapes = [ParallelTensorShape.make(x.shape, str(x.dtype)) for x in xs]
    jshapes = [JShape.make(x.shape, str(x.dtype)) for x in xs]
    cls, jcls = ((AggregateSpecOp, JAggregateSpec) if spec
                 else (AggregateOp, JAggregate))
    op = cls("agg", shapes, lambda_bal=lambda_bal)
    jop = jcls("agg", jshapes, lambda_bal=lambda_bal)
    assert hasattr(op, "state_specs") == (lambda_bal > 0)
    tx = [torch.from_numpy(x) for x in xs]
    for i in (0, 4):
        tx[i].requires_grad_(True)
    ctx, jctx = LoweringContext(), JContext(train=False)
    y = op.forward(ctx, tx, {})[0]
    jy = jop.forward(jctx, [jnp.asarray(x) for x in xs], {})[0]
    _close(y, jy)
    if lambda_bal > 0:
        _close(ctx.state_out["agg/aux_loss"],
               np.asarray(jctx.state_out["agg/aux_loss"]))
    else:
        assert not ctx.state_out and not jctx.state_out
    dy = rng.normal(size=y.shape).astype(np.float32)
    y.backward(torch.from_numpy(dy))

    def f(gates, expert_out):
        ins = [gates] + [jnp.asarray(x) for x in xs[1:4]] + [expert_out]
        return jnp.sum(jop.forward(JContext(train=False), ins, {})[0] * dy)

    jg = jax.grad(f, argnums=(0, 1))(jnp.asarray(xs[0]), jnp.asarray(xs[4]))
    if spec:
        assert tx[0].grad is None or not tx[0].grad.any()
    else:
        _close(tx[0].grad, jg[0])
    _close(tx[4].grad, jg[1])


@pytest.mark.parametrize("use_cached", [False, True])
def test_cache_equals_the_reference(use_cached):
    shape = (4, 5)
    op = CacheOp("c", [ParallelTensorShape.make(shape, "float32")],
                 use_cached=use_cached)
    jop = JCache("c", [JShape.make(shape, "float32")], use_cached=use_cached)
    rng = np.random.default_rng(5)
    cached = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    ctx = LoweringContext(state_in={"c/cached": torch.from_numpy(cached)})
    jctx = JContext(train=False, state_in={"c/cached": jnp.asarray(cached)})
    y = op.forward(ctx, [torch.from_numpy(x)], {})[0]
    jy = jop.forward(jctx, [jnp.asarray(x)], {})[0]
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    for key in ("c/score", "c/cached"):
        _close(ctx.state_out[key], np.asarray(jctx.state_out[key]))
    names = [s[0] for s in op.state_specs()]
    assert names == ["cached", "score"]
    assert [s[0] for s in jop.state_specs()] == ["cached"]


def test_moe_hooks_equal_the_references():
    g, jg = _moe_shapes(b=8, k=2, d=6, e=4)
    rng = np.random.default_rng(6)
    xs = _combine_inputs(rng)
    a = AggregateOp("a", [ParallelTensorShape.make(x.shape, str(x.dtype))
                          for x in xs], lambda_bal=0.1)
    ja = JAggregate("a", [JShape.make(x.shape, str(x.dtype)) for x in xs],
                    lambda_bal=0.1)
    c = CacheOp("c", [ParallelTensorShape.make((8, 4), "float32")])
    jc = JCache("c", [JShape.make((8, 4), "float32")])
    for op, jop, views in (
            (g, jg, [((4, 1, 1), 1), ((2, 1, 2), 1), ((1, 1, 2), 2)]),
            (a, ja, [((2, 1), 1), ((1, 2), 1), ((2, 2), 1), ((1, 1), 2)]),
            (c, jc, [((2, 1), 1), ((2, 2), 1)])):
        assert op.signature() == jop.signature()
        assert op.flops() == jop.flops()
        assert op.bytes_accessed() == jop.bytes_accessed()
        assert op.splittable_output_dims() == jop.splittable_output_dims()
        assert op.max_replica_degree() == jop.max_replica_degree()
        for degs, r in views:
            assert str(op.propagate(MachineView(degs, replica_degree=r))) \
                == str(jop.propagate(JView(degs, replica_degree=r)))


def _trivial(model):
    return {n.guid: JView.trivial(n.op.output_shapes[0].ndim)
            for n in model.graph.topo_order()}


def moe_pair(use_cache=False, **kw):
    """build_moe in both packages, the port holding the reference's
    weights and state."""
    opts = dict(MOE_KW, use_cache=use_cache, **kw)
    cce = dict(loss_type="sparse_categorical_crossentropy",
               metrics=["accuracy"])
    jm = jbuild_moe(ff.FFConfig(batch_size=B, num_devices=1,
                                compute_dtype="float32", cost_cache_file=""),
                    **opts)
    jm.compile(optimizer=ff.SGDOptimizer(lr=0.05), strategy=_trivial(jm),
               **cce)
    pm = build_moe(tff.FFConfig(batch_size=B, device="cpu",
                                compute_dtype="float32",
                                only_data_parallel=True), **opts)
    pm.compile(optimizer=tff.SGDOptimizer(lr=0.05), **cce)
    pm.params = params_from_numpy({op: {w: np.array(v) for w, v in ws.items()}
                                   for op, ws in jm.params.items()})
    pm.opt_state = pm.optimizer.init_state(pm.params)
    for k, v in jm.state.items():
        pm.set_state_var(k, np.asarray(v))
    return jm, pm


def moe_batches(n=3, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(B, MOE_KW["in_dim"])).astype(np.float32),
             rng.integers(0, MOE_KW["num_classes"], B).astype(np.int32))
            for _ in range(n)]


def gates_have_no_ties(model, x):
    """The gate softmax's k-th and (k+1)-th values differ in every row
    (so both libraries' top-k pick and order the same experts)."""
    w = {k: v.detach().numpy() for k, v in model.params["gate_dense"].items()}
    z = x @ w["kernel"] + w["bias"]
    p = np.exp(z - z.max(1, keepdims=True))
    p = np.sort(p / p.sum(1, keepdims=True), axis=1)[:, ::-1]
    k = MOE_KW["num_select"]
    return bool((np.diff(p[:, :k + 1], axis=1) < 0).all())


@pytest.mark.parametrize("use_cache", [False, True])
def test_build_moe_trains_as_the_reference(use_cache):
    jm, pm = moe_pair(use_cache)
    for step, (x, y) in enumerate(moe_batches(), start=1):
        assert gates_have_no_ties(pm, x)
        jm.params, jm.opt_state, jm.state, jl, _ = jm.compiled.train_step(
            jm.params, jm.opt_state, jm.state, jax.random.key(step),
            [jnp.asarray(x)], jnp.asarray(y))
        pm.params, pm.opt_state, pm.state, pl, _ = pm.compiled.train_step(
            pm.params, pm.opt_state, pm.state, [torch.from_numpy(x)],
            torch.from_numpy(y), seed=step)
        assert abs(float(pl) - float(jl)) <= STEP_TOL * abs(float(jl)), step
        aux = float(np.asarray(jm.state["combine/aux_loss"]))
        assert abs(float(pm.state["combine/aux_loss"]) - aux) <= (
            STEP_TOL * aux)
        if use_cache:
            assert abs(float(pm.state["gate_cache/score"]) - float(
                np.asarray(jm.state["gate_cache/score"]))) <= 1e-6
    got = params_to_numpy(pm.params)
    for op, ws in jm.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(got[op][w], np.asarray(v),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"{op}/{w}")


def test_cache_score_reads_the_cache_op_through_fit():
    from flexflow_tpu_torch.runtime.recompile import cache_score

    _, pm = moe_pair(use_cache=True)
    x, y = moe_batches(1)[0]
    pm.fit(x, y, batch_size=B, epochs=2, shuffle=False, verbose=False)
    s = cache_score(pm, "gate_cache")
    assert math.isfinite(s) and s > 0.0  # the gates moved between epochs
