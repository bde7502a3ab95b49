"""The port's model zoo (``flexflow_tpu_torch/models/``), the rest of the
shape ops and the batched embedding, against the JAX package's.

* Ops: ``Split``, ``Transpose``, ``Reverse``, ``Cast``, ``Stack`` /
  ``Unstack`` and ``BatchedEmbedding`` (aggr none, sum and avg): forward
  and the float inputs' (the table's) gradients within 1e-6 of the
  largest reference value; ``propagate`` and the cost hooks under split
  views equal the JAX op's.
* Builders: AlexNet-CIFAR10, a ResNet with ``layers=(1, 1, 1, 1)`` at a
  32x32 image, DLRM, CANDLE-Uno and the MLP at tests/test_models.py's
  tiny configs (tests/test_torch_moe.py has the MoE), the port holding
  the reference's weights and state: 3 SGD steps (``train_step``, the
  step ``fit`` runs; AlexNet's dropout masks handed in from the
  reference, keyed alike in every interpreter,
  tests/test_torch_dropout.py ``pin_reference_masks``), each step's
  loss within 1e-5
  relative and the weights and batch-norm statistics after them within
  1e-5; the ResNet's steps each start from the reference's weights, and
  its updates are held to a measured bound (``RESNET_UPDATE_TOL`` says
  why).  Every builder the JAX package exports is exported here and
  trains through ``fit`` (finite losses).
* The searched DLRM: ``compile(strategy=None)`` on one device applies
  the batched-embedding rewrite (stack, batched lookup, unstack), and
  with the K tables stacked into its table it trains as the
  unrewritten graph: 3 steps' losses and the weights within 1e-5.
* The zoo's searches: ``optimize_strategy(return_graph=True)`` on
  ``tpu_v5e(4)`` gives the reference's graph digest and views, and the
  trivial and data-parallel strategies' simulated steps equal the
  reference's within 1e-9; where the reference's search refuses its own
  result (DLRM's unstack under a split, SHD107: ROADMAP Queue C), the
  port refuses the same.
* Over ranks, in tests/test_torch_fleet.py's gloo world of 4 (spawned
  once per run, its rank function runs ``zoo_rank_legs`` too): a small
  CNN whose convs and pools are split spatially (H, W and both), over
  the in channels (partial sums, and the grouped conv's gather) and
  over the batch, and ``__graft_entry__.py``'s ep-MoE leg (``build_moe``
  with 4 experts, ``dispatch``, ``expert_fc1`` and ``expert_fc2`` split
  4 ways on dim 0; its cache and combine batch-split), and the batched
  embedding's graph with its stack split over tables and batch and its
  lookup over tables and vocab: each step's loss (the first and the
  second), the cache's score and the aux loss within 1e-5 of one
  process's and the weights after 2 SGD steps within 1e-5 of one
  process's; every weight a rank holds whole bit-equal on every rank.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu.models as jmods
from flexflow_tpu.compiler.lowering import (
    data_parallel_strategy as ref_dp_strategy,
)
from flexflow_tpu.core.machine import MachineSpec as RefSpec
from flexflow_tpu.core.machine import MachineView as JView
from flexflow_tpu.core.ptensor import ParallelTensorShape as JShape
from flexflow_tpu.ops.base import LoweringContext as JContext
from flexflow_tpu.ops.embedding import BatchedEmbeddingOp as JBatched
from flexflow_tpu.ops.shape_ops import CastOp as JCast
from flexflow_tpu.ops.shape_ops import ReverseOp as JReverse
from flexflow_tpu.ops.shape_ops import SplitOp as JSplit
from flexflow_tpu.ops.shape_ops import StackOp as JStack
from flexflow_tpu.ops.shape_ops import TransposeOp as JTranspose
from flexflow_tpu.ops.shape_ops import UnstackOp as JUnstack
from flexflow_tpu.search import driver as ref_driver
from flexflow_tpu.search.cost_cache import stable_graph_digest as ref_digest
from flexflow_tpu.search.simulator import Simulator as RefSim
import flexflow_tpu_torch as tff
import flexflow_tpu_torch.models as tmods
from flexflow_tpu_torch.compiler.lowering import data_parallel_strategy
from flexflow_tpu_torch.core.machine import MachineSpec, MachineView
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.ops import (
    BatchedEmbeddingOp,
    CastOp,
    ReverseOp,
    SplitOp,
    StackOp,
    TransposeOp,
    UnstackOp,
)
from flexflow_tpu_torch.ops.base import LoweringContext
from flexflow_tpu_torch.search import driver
from flexflow_tpu_torch.search.cost_cache import stable_graph_digest
from flexflow_tpu_torch.search.simulator import Simulator

from test_torch_dropout import pin_reference_masks
from test_torch_fleet import fleet_world  # noqa: F401  (the shared world)

TOL = 1e-6
STEP_TOL = 1e-5
REL = 1e-9
MSE = dict(loss_type="mean_squared_error", metrics=["mean_squared_error"])
CCE = dict(loss_type="sparse_categorical_crossentropy",
           metrics=["accuracy"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol=TOL):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(got - ref).max()) <= tol * scale


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
def _pair_op(op, jop, xs, weights=None, views=()):
    """Forward of both ops on ``xs`` (and ``weights``), the gradients of
    every float input and weight of sum(y_i * dy_i), the hooks and
    ``propagate`` under ``views``."""
    assert op.signature() == jop.signature()
    assert [s.sizes for s in op.output_shapes] == [
        s.sizes for s in jop.output_shapes]
    weights = weights or {}
    floats = [x.dtype == np.float32 for x in xs]
    tx = [torch.from_numpy(x).requires_grad_(f) for x, f in zip(xs, floats)]
    tw = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in weights.items()}
    ys = op.forward(LoweringContext(compute_dtype=torch.float32), tx, tw)
    jctx = JContext(compute_dtype=jnp.float32, train=False)
    jys = jop.forward(jctx, [jnp.asarray(x) for x in xs],
                      {k: jnp.asarray(v) for k, v in weights.items()})
    assert len(ys) == len(jys)
    for y, jy in zip(ys, jys):
        assert str(y.dtype) == f"torch.{jy.dtype}"
        _close(y, jy)
    dys = [_np(tuple(y.shape), 50 + i) for i, y in enumerate(ys)]
    grads = [i for i, y in enumerate(ys) if y.is_floating_point()
             and y.requires_grad]
    if grads:
        sum((ys[i] * torch.from_numpy(dys[i])).sum()
            for i in grads).backward()
        fi = [i for i, f in enumerate(floats) if f]

        def f(fxs, ws):
            full = [jnp.asarray(x) for x in xs]
            for i, a in zip(fi, fxs):
                full[i] = a
            out = jop.forward(jctx, full, ws)
            return sum(jnp.sum(out[i] * dys[i]) for i in grads)

        gx, gw = jax.grad(f, argnums=(0, 1))(
            [jnp.asarray(xs[i]) for i in fi],
            {k: jnp.asarray(v) for k, v in weights.items()})
        for i, g in zip(fi, gx):
            _close(tx[i].grad, g)
        for k in weights:
            _close(tw[k].grad, gw[k])
    assert op.flops() == jop.flops()
    assert op.bytes_accessed() == jop.bytes_accessed()
    assert op.splittable_output_dims() == jop.splittable_output_dims()
    assert op.max_replica_degree() == jop.max_replica_degree()
    for degs, r in views:
        assert str(op.propagate(MachineView(degs, replica_degree=r))) == str(
            jop.propagate(JView(degs, replica_degree=r)))


def _shapes(xs):
    return ([ParallelTensorShape.make(x.shape, str(x.dtype)) for x in xs],
            [JShape.make(x.shape, str(x.dtype)) for x in xs])


@pytest.mark.parametrize("sizes,axis", [((2, 3, 1), 1), (2, 2), ((4,), 0)])
def test_split_equals_the_reference(sizes, axis):
    x = _np((4, 6, 4), 1)
    if isinstance(sizes, int):
        sizes = (x.shape[axis] // sizes,) * sizes
    (s,), (js,) = _shapes([x])
    views = [((2, 1, 1), 1), ((1, 2, 1) if axis == 2 else (1, 1, 2), 2)]
    _pair_op(SplitOp("s", [s], sizes=sizes, axis=axis),
             JSplit("s", [js], sizes=sizes, axis=axis), [x],
             views=views if axis else [])


@pytest.mark.parametrize("perm", [(0, 2, 1), (2, 0, 1), (1, 0, 2)])
def test_transpose_equals_the_reference(perm):
    x = _np((2, 3, 4), 2)
    (s,), (js,) = _shapes([x])
    _pair_op(TransposeOp("t", [s], perm=perm),
             JTranspose("t", [js], perm=perm), [x],
             views=[((1, 2, 1), 1), ((2, 1, 2), 1), ((1, 1, 1), 2)])


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_reverse_equals_the_reference(axis):
    x = _np((2, 3, 4), 3)
    (s,), (js,) = _shapes([x])
    _pair_op(ReverseOp("r", [s], axis=axis), JReverse("r", [js], axis=axis),
             [x], views=[((1, 1, 1), 2)])


@pytest.mark.parametrize("dtype", ["bfloat16", "int32", "float32"])
def test_cast_equals_the_reference(dtype):
    x = _np((3, 4), 4) * 4
    (s,), (js,) = _shapes([x])
    op, jop = CastOp("c", [s], dtype=dtype), JCast("c", [js], dtype=dtype)
    assert op.signature() == jop.signature()
    y = op.forward(LoweringContext(), [torch.from_numpy(x)], {})[0]
    jy = jop.forward(JContext(train=False), [jnp.asarray(x)], {})[0]
    assert str(y.dtype) == f"torch.{jy.dtype}"
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(jy.astype(jnp.float32)))
    assert str(op.propagate(MachineView((2, 1)))) == str(
        jop.propagate(JView((2, 1))))


def test_stack_and_unstack_equal_the_reference():
    xs = [_np((4, 5), 10 + i) for i in range(3)]
    shapes, jshapes = _shapes(xs)
    _pair_op(StackOp("st", shapes), JStack("st", jshapes), xs,
             views=[((3, 1, 1), 1), ((1, 2, 1), 1), ((1, 1, 1), 2)])
    y = np.stack(xs)
    (s,), (js,) = _shapes([y])
    _pair_op(UnstackOp("un", [s]), JUnstack("un", [js]), [y],
             views=[((2, 1), 1), ((1, 5), 1)])


@pytest.mark.parametrize("aggr,ids_shape", [("none", (3, 4, 2)),
                                            ("sum", (3, 4, 2)),
                                            ("avg", (3, 4, 3)),
                                            ("sum", (3, 4))])
def test_batched_embedding_equals_the_reference(aggr, ids_shape):
    k, vocab, d = 3, 11, 5
    ids = np.random.default_rng(5).integers(0, vocab, size=ids_shape).astype(
        np.int32)
    (s,), (js,) = _shapes([ids])
    kw = dict(num_tables=k, num_entries=vocab, out_dim=d, aggr=aggr)
    _pair_op(BatchedEmbeddingOp("be", [s], **kw), JBatched("be", [js], **kw),
             [ids], {"table": _np((k, vocab, d), 6)},
             views=[((3, 1, 1), 1), ((1, 2, 1), 1), ((1, 1, 5), 1),
                    ((1, 1, 1), 2)] if len(ids_shape) == 2 or aggr != "none"
             else [((3, 1, 1, 1), 1), ((1, 2, 1, 1), 2)])


# ---------------------------------------------------------------------------
def _trivial(model):
    return {n.guid: JView.trivial(n.op.output_shapes[0].ndim)
            for n in model.graph.topo_order()}


def _candle_kw():
    return dict(feature_shapes={"dose": 1, "cell.rnaseq": 32,
                                "drug.descriptors": 24},
                input_features=["dose1", "cell.rnaseq", "drug1.descriptors"],
                dense_layers=(32, 32), dense_feature_layers=(32,))


def _data(name, batch, rng):
    """(inputs, labels) of one batch of builder ``name``."""
    if name in ("alexnet", "resnet"):
        return ([rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)],
                rng.integers(0, 10, batch).astype(np.int32))
    if name == "dlrm":
        return ([rng.normal(size=(batch, 13)).astype(np.float32)]
                + [rng.integers(0, 1000, size=(batch, 1)).astype(np.int32)
                   for _ in range(2)],
                rng.uniform(0, 1, (batch, 1)).astype(np.float32))
    if name == "candle_uno":
        return ([rng.normal(size=(batch, n)).astype(np.float32)
                 for n in (1, 32, 24)],
                rng.uniform(0, 1, (batch, 1)).astype(np.float32))
    return ([rng.normal(size=(batch, 64)).astype(np.float32)],
            rng.integers(0, 4, batch).astype(np.int32))


# builder, its kwargs (tests/test_models.py's tiny configs), the loss,
# the batch and the SGD rate
RESNET = dict(num_classes=10, image=32, layers=(1, 1, 1, 1))
BUILDERS = {
    "alexnet": ("build_alexnet_cifar10", {}, CCE, 4, 0.01),
    "resnet": ("build_resnet", RESNET, CCE, 8, 0.01),
    "dlrm": ("build_dlrm", dict(embedding_sizes=(1000, 1000),
                                embedding_dim=16, dense_dim=13,
                                bot_mlp=(64, 16), top_mlp=(64, 1)), MSE, 4,
             0.01),
    "candle_uno": ("build_candle_uno", _candle_kw(), MSE, 4, 0.01),
    "mlp": ("build_mlp_unify", dict(in_dim=64, hidden=(64, 64),
                                    num_classes=4), CCE, 4, 0.01),
}
# The ResNet's batch norms turn the two libraries' conv summation orders
# into a measured bound.  A ReLU input within the forward's rounding of
# zero (about 1e-6 of the largest value) passes its gradient on one side
# only, and the batch norm's statistics spread that over its channel:
# on the CPU over 8 batches each step's loss stayed within 1.5e-6, and
# each weight's update within 7.5e-5 relative (L2) without such a flip
# and 2.75e-2 with one; over 3 free-running steps the flips compound
# (the third loss up to 1.7e-2 apart).  So each of its steps starts from
# the reference's weights and state, its loss is held to 1e-5 and each
# update to RESNET_UPDATE_TOL; the batches below include flips.
RESNET_UPDATE_TOL = 5e-2
DATA_SEED = 3


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_trains_as_the_reference(name, monkeypatch):
    build, kw, loss, batch, lr = BUILDERS[name]
    jm = getattr(jmods, build)(ff.FFConfig(
        batch_size=batch, num_devices=1, compute_dtype="float32",
        cost_cache_file=""), **kw)
    jm.compile(optimizer=ff.SGDOptimizer(lr=lr), strategy=_trivial(jm),
               **loss)
    pm = getattr(tmods, build)(tff.FFConfig(
        batch_size=batch, device="cpu", compute_dtype="float32",
        only_data_parallel=True), **kw)
    pm.compile(optimizer=tff.SGDOptimizer(lr=lr), **loss)
    assert [n.op.name for n in pm.graph.topo_order()] == [
        n.op.name for n in jm.graph.topo_order()]
    resync = name == "resnet"

    def take_reference():
        pm.params = params_from_numpy({
            op: {w: np.array(v) for w, v in ws.items()}
            for op, ws in jm.params.items()})
        pm.opt_state = pm.optimizer.init_state(pm.params)
        for k, v in jm.state.items():
            pm.set_state_var(k, np.asarray(v))

    take_reference()
    pin_reference_masks(monkeypatch)  # the same masks in every process
    rng = np.random.default_rng(DATA_SEED)
    for step in (1, 2, 3):
        xs, y = _data(name, batch, rng)
        if resync:
            take_reference()
            before = {op: {w: np.array(v) for w, v in ws.items()}
                      for op, ws in jm.params.items()}
        jm.params, jm.opt_state, jm.state, jl, _ = jm.compiled.train_step(
            jm.params, jm.opt_state, jm.state, jax.random.key(step),
            [jnp.asarray(x) for x in xs], jnp.asarray(y))
        pm.params, pm.opt_state, pm.state, pl, _ = pm.compiled.train_step(
            pm.params, pm.opt_state, pm.state,
            [torch.from_numpy(x) for x in xs], torch.from_numpy(y),
            seed=step)
        assert abs(float(pl) - float(jl)) <= STEP_TOL * abs(float(jl)), (
            step, float(pl), float(jl))
        if resync:
            got = params_to_numpy(pm.params)
            for op, ws in jm.params.items():
                for w, v in ws.items():
                    want = np.asarray(v) - before[op][w]
                    err = np.linalg.norm(got[op][w] - np.asarray(v))
                    assert err <= RESNET_UPDATE_TOL * np.linalg.norm(
                        want), (step, op, w)
    if resync:
        return
    got = params_to_numpy(pm.params)
    for op, ws in jm.params.items():
        for w, v in ws.items():
            np.testing.assert_allclose(got[op][w], np.asarray(v),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"{op}/{w}")
    for k, v in jm.state.items():
        np.testing.assert_allclose(pm.state[k].numpy(), np.asarray(v),
                                   rtol=STEP_TOL, atol=STEP_TOL, err_msg=k)


# every exported builder, at a size the CPU trains in about a second
FIT = {
    "build_alexnet": (dict(num_classes=10, image=67), "image"),
    "build_alexnet_cifar10": ({}, "cifar"),
    "build_resnet": (RESNET, "cifar"),
    "build_resnext50": (dict(num_classes=10, image=32), "cifar"),
    "build_inception_v3": (dict(num_classes=10, image=75), "inception"),
    "build_dlrm": (BUILDERS["dlrm"][1], "dlrm"),
    "build_xdl": (dict(num_tables=3, vocab=100, embedding_dim=8,
                       mlp=(16, 1)), "xdl"),
    "build_candle_uno": (_candle_kw(), "candle"),
    "build_moe": (dict(in_dim=64, num_classes=4, num_exp=4, num_select=2,
                       hidden=16), "vector"),
    "build_mlp_unify": (BUILDERS["mlp"][1], "vector"),
    "build_moe_trunk": (dict(num_blocks=2, hidden=64, num_classes=4),
                        "vector"),
    "build_multibranch": (dict(num_branches=2, depth=2, hidden=64,
                               num_classes=4), "vector"),
    "build_transformer": (dict(num_layers=1, hidden=32, num_heads=2,
                               ff_dim=32, seq_len=8), "sequence"),
    "build_bert": (dict(vocab=64, num_layers=1, hidden=32, num_heads=2,
                        ff_dim=32, seq_len=8, dropout=0.0), "ids"),
    "build_gpt": (dict(vocab=64, num_layers=1, hidden=32, num_heads=2,
                       ff_dim=32, seq_len=8), "lm"),
    "build_gpt_xl": (dict(vocab=64, num_layers=2, hidden=32, num_heads=2,
                          ff_dim=32, seq_len=8), "lm"),
}


def _fit_data(kind, n, rng):
    if kind == "image":
        return (rng.normal(size=(n, 67, 67, 3)).astype(np.float32),
                rng.integers(0, 10, n).astype(np.int32), CCE)
    if kind == "cifar":
        return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, n).astype(np.int32), CCE)
    if kind == "inception":
        return (rng.normal(size=(n, 75, 75, 3)).astype(np.float32),
                rng.integers(0, 10, n).astype(np.int32), CCE)
    if kind in ("dlrm", "candle"):
        xs, y = _data("dlrm" if kind == "dlrm" else "candle_uno", n, rng)
        return xs, y, MSE
    if kind == "xdl":
        return ([rng.integers(0, 100, size=(n, 1)).astype(np.int32)
                 for _ in range(3)],
                rng.uniform(0, 1, (n, 1)).astype(np.float32), MSE)
    if kind == "sequence":
        return (rng.normal(size=(n, 8, 32)).astype(np.float32),
                rng.normal(size=(n, 8, 32)).astype(np.float32), MSE)
    if kind == "ids":
        return (rng.integers(0, 64, size=(n, 8)).astype(np.int32),
                rng.integers(0, 2, n).astype(np.int32), CCE)
    if kind == "lm":
        ids = rng.integers(0, 64, size=(n, 9)).astype(np.int32)
        return ids[:, :-1], ids[:, 1:], CCE
    return (rng.normal(size=(n, 64)).astype(np.float32),
            rng.integers(0, 4, n).astype(np.int32), CCE)


def test_every_reference_builder_is_exported():
    assert set(jmods.__all__) <= set(tmods.__all__)
    for name in jmods.__all__:
        assert getattr(tmods, name) is not None
    assert {n for n in jmods.__all__ if n.startswith("build_")
            and n not in ("build_gpt_decode", "build_gpt_prefill")} == set(
        FIT)


@pytest.mark.parametrize("build", sorted(FIT))
def test_every_builder_trains_through_fit(build):
    kw, kind = FIT[build]
    batch = 2
    m = getattr(tmods, build)(tff.FFConfig(
        batch_size=batch, device="cpu", compute_dtype="float32",
        only_data_parallel=True), **kw)
    x, y, loss = _fit_data(kind, 2 * batch, np.random.default_rng(12))
    m.compile(optimizer=tff.SGDOptimizer(lr=0.01), **loss)
    hist = m.fit(x, y, epochs=1, shuffle=False, verbose=False)
    assert len(m.step_losses) == 2 and hist
    assert all(math.isfinite(v) for v in m.step_losses)


# ---------------------------------------------------------------------------
def _dlrm(cfg, k=4):
    return tmods.build_dlrm(cfg, embedding_sizes=(1000,) * k,
                            embedding_dim=16, dense_dim=13, bot_mlp=(64, 16),
                            top_mlp=(64, 1))


def test_searched_dlrm_trains_the_batched_embedding_rewrite():
    """``compile(strategy=None)`` picks the rewrite; with the K tables
    stacked into its table it trains as the unrewritten graph."""
    common = dict(batch_size=8, device="cpu", compute_dtype="float32",
                  search_timeout_s=0)
    plain = _dlrm(tff.FFConfig(only_data_parallel=True, **common))
    plain.compile(optimizer=tff.SGDOptimizer(lr=0.05), **MSE)
    searched = _dlrm(tff.FFConfig(**common))
    searched.compile(optimizer=tff.SGDOptimizer(lr=0.05), **MSE)
    kinds = {n.op.op_type.value for n in searched.graph.topo_order()}
    assert {"stack", "batched_embedding", "unstack"} <= kinds
    assert "embedding" not in kinds
    be = next(n.op.name for n in searched.graph.topo_order()
              if n.op.op_type.value == "batched_embedding")
    whole = params_to_numpy(plain.params)
    for op, ws in whole.items():
        if op in searched.params:
            for w, v in ws.items():
                searched.set_weight(op, w, v)
    searched.set_weight(be, "table", np.stack(
        [whole[f"embed_{i}"]["table"] for i in range(4)]))
    rng = np.random.default_rng(13)
    for step in range(3):
        xs = ([rng.normal(size=(8, 13)).astype(np.float32)]
              + [rng.integers(0, 1000, size=(8, 1)).astype(np.int32)
                 for _ in range(4)])
        y = torch.from_numpy(rng.uniform(0, 1, (8, 1)).astype(np.float32))
        ins = [torch.from_numpy(x) for x in xs]
        losses = []
        for m in (plain, searched):
            m.params, m.opt_state, m.state, loss, _ = m.compiled.train_step(
                m.params, m.opt_state, m.state, ins, y)
            losses.append(float(loss))
        assert abs(losses[1] - losses[0]) <= STEP_TOL * abs(losses[0]), (
            step, losses)
    got = params_to_numpy(searched.params)
    after = params_to_numpy(plain.params)
    for i in range(4):
        np.testing.assert_allclose(got[be]["table"][i],
                                   after[f"embed_{i}"]["table"],
                                   rtol=STEP_TOL, atol=STEP_TOL)
    for op in ("bot_mlp_0", "top_mlp_0", "top_out"):
        for w, v in after[op].items():
            np.testing.assert_allclose(got[op][w], v, rtol=STEP_TOL,
                                       atol=STEP_TOL, err_msg=f"{op}/{w}")


SEARCH_MODELS = {
    "alexnet": ("build_alexnet_cifar10", {}, 8),
    "resnet": ("build_resnet", RESNET, 8),
    "dlrm": ("build_dlrm", BUILDERS["dlrm"][1], 16),
    "candle_uno": ("build_candle_uno", _candle_kw(), 16),
    "moe": ("build_moe", dict(in_dim=32, num_classes=4, num_exp=4,
                              num_select=2, hidden=16), 16),
    "mlp": ("build_mlp_unify", BUILDERS["mlp"][1], 16),
}


def _views_by_digest(graph, strategy):
    digests = graph.stable_node_digests()
    out = {}
    for guid, v in strategy.items():
        out.setdefault(digests[guid], []).append(
            (tuple(v.dim_degrees), v.replica_degree, v.start_part))
    return {k: sorted(v) for k, v in out.items()}


def _close_rel(a, b):
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= REL * max(abs(a), abs(b))


@pytest.mark.parametrize("name", sorted(SEARCH_MODELS))
def test_zoo_search_equals_the_reference(name):
    build, kw, batch = SEARCH_MODELS[name]
    n = 4
    common = dict(batch_size=batch, num_devices=n, search_timeout_s=0,
                  compute_dtype="float32")
    ref = getattr(jmods, build)(ff.FFConfig(
        machine_spec=RefSpec.tpu_v5e(n), cost_cache_file="", **common), **kw)
    port = getattr(tmods, build)(tff.FFConfig(
        machine_spec=MachineSpec.tpu_v5e(n), device="cpu", **common), **kw)
    assert stable_graph_digest(port.graph) == ref_digest(ref.graph)
    for inference in (False, True):
        rsim = RefSim(RefSpec.tpu_v5e(n), num_devices=n, inference=inference)
        tsim = Simulator(MachineSpec.tpu_v5e(n), num_devices=n,
                         inference=inference)
        for rs, ts in (({}, {}), (ref_dp_strategy(ref.graph, n),
                                  data_parallel_strategy(port.graph, n))):
            got, want = tsim.simulate(port.graph, ts), rsim.simulate(
                ref.graph, rs)
            assert math.isfinite(got) and _close_rel(got, want), (
                inference, got, want)
    try:
        rgraph, rstrat = ref_driver.optimize_strategy(ref.graph, ref.config,
                                                      return_graph=True)
    except Exception as e:  # the reference refuses its own result
        with pytest.raises(type(e)) as got:
            driver.optimize_strategy(port.graph, port.config,
                                     return_graph=True)
        assert str(got.value) .split("(op")[0] == str(e).split("(op")[0]
        return
    graph, strat = driver.optimize_strategy(port.graph, port.config,
                                            return_graph=True)
    assert stable_graph_digest(graph) == ref_digest(rgraph)
    assert _views_by_digest(graph, strat) == _views_by_digest(rgraph, rstrat)


# ---------------------------------------------------------------------------
# over ranks: tests/test_torch_fleet.py's world of 4 runs zoo_rank_legs
CNN_BATCH = 4


def _cnn(cfg):
    """Spatial, in-channel (partial and grouped) and batch splits of
    convs and pools, by name in ``CNN_VIEWS``."""
    m = tff.FFModel(cfg)
    x = m.create_tensor([CNN_BATCH, 8, 8, 3], name="image")
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1, activation="relu", name="c_hw")
    t = m.batch_norm(t, relu=False, name="bn")
    t = m.pool2d(t, 3, 3, 1, 1, 1, 1, name="p_hw")
    t = m.conv2d(t, 8, 3, 3, 2, 2, 1, 1, activation="relu", name="c_in")
    t = m.conv2d(t, 8, 3, 3, 1, 1, 1, 1, groups=4, name="c_grp")
    t = m.conv2d(t, 8, 1, 1, name="c_h", use_bias=False)
    t = m.pool2d(t, 2, 2, 2, 2, pool_type="avg", name="p_w")
    t = m.flat(t, name="flat")
    m.dense(t, 4, name="head")
    return m


CNN_VIEWS = {  # name -> (dim degrees, replica degree)
    "c_hw": ((1, 2, 2, 1), 1),
    "bn": ((1, 2, 2, 1), 1),
    "p_hw": ((2, 2, 1, 1), 1),
    "c_in": ((1, 1, 1, 1), 4),
    "c_grp": ((2, 1, 1, 1), 2),
    "c_h": ((1, 4, 1, 1), 1),
    "p_w": ((1, 1, 2, 2), 1),
}


EP_KW = dict(in_dim=16, num_classes=4, num_exp=4, num_select=2, hidden=8,
             use_cache=True)
EP_BATCH = 8


def ep_views(model, n):
    """The ep-MoE leg (``__graft_entry__.py:115-150``): the expert dim of
    the dispatch and the expert MLP split n ways; the cache and the
    combine under a batch split too (their ``forward_sharded``)."""
    views = {n_.guid: MachineView.trivial(n_.op.output_shapes[0].ndim)
             for n_ in model.graph.topo_order()}
    for name in ("dispatch", "expert_fc1", "expert_fc2", "gate_cache",
                 "combine"):
        node = model.node_by_name(name)
        degs = [1] * node.op.output_shapes[0].ndim
        degs[0] = n
        views[node.guid] = MachineView(tuple(degs))
    return views


EMB_BATCH, EMB_TABLES = 8, 4


def _batched_embedding(cfg):
    """The graph the batched-embedding rewrite builds for a DLRM-style
    model (search/substitution.py ``BatchEmbeddingsXfer``), with fixed
    names: stack the K tables' ids, one batched lookup, unstack."""
    m = tff.FFModel(cfg)
    x = m.create_tensor([EMB_BATCH, 6], name="dense")
    ids = [m.create_tensor([EMB_BATCH, 2], dtype="int32", name=f"ids_{i}")
           for i in range(EMB_TABLES)]
    st = m._add_op(StackOp("stack_ids", [m._shape_of(t) for t in ids]),
                   ids)[0]
    be = m._add_op(BatchedEmbeddingOp(
        "batched_embed", [m._shape_of(st)], num_tables=EMB_TABLES,
        num_entries=64, out_dim=8, aggr="sum"), [st])[0]
    outs = m._add_op(UnstackOp("unstack", [m._shape_of(be)]), [be])
    t = m.concat([m.dense(x, 8, name="bot")] + outs, axis=1, name="cat")
    m.dense(t, 4, name="head")
    return m


EMB_VIEWS = {  # the stack over tables and batch, the lookup over tables
    "stack_ids": ((2, 2, 1), 1),  # and vocab (partial sums)
    "batched_embed": ((2, 1, 1), 2),
}


def views_by_name(model, table):
    views = {}
    for node in model.graph.topo_order():
        degs, r = table.get(node.op.name, (
            (1,) * node.op.output_shapes[0].ndim, 1))
        views[node.guid] = MachineView(degs, replica_degree=r)
    return views


def leg_data(seed=21):
    """Two batches of (inputs, labels) for each leg."""
    rng = np.random.default_rng(seed)
    return {
        "cnn": [([rng.normal(size=(CNN_BATCH, 8, 8, 3)).astype(np.float32)],
                 rng.integers(0, 4, CNN_BATCH).astype(np.int32))
                for _ in range(2)],
        "ep": [([rng.normal(size=(EP_BATCH, 16)).astype(np.float32)],
                rng.integers(0, 4, EP_BATCH).astype(np.int32))
               for _ in range(2)],
        "emb": [([rng.normal(size=(EMB_BATCH, 6)).astype(np.float32)]
                 + [rng.integers(0, 64, size=(EMB_BATCH, 2)).astype(np.int32)
                    for _ in range(EMB_TABLES)],
                 rng.integers(0, 4, EMB_BATCH).astype(np.int32))
                for _ in range(2)]}


def run_leg(model, batches, n):
    """2 SGD steps; (losses, whole weights, this rank's local weights,
    the scores in the model state), numpy: it crosses ranks."""
    losses = []
    c = model.compiled
    for xs, y in batches:
        xs = [torch.from_numpy(x[c.input_slices(i, x.shape)])
              for i, x in enumerate(xs)]
        ys = torch.from_numpy(y[c.label_slices(y.shape)])
        model.params, model.opt_state, model.state, loss, _ = \
            c.train_step(model.params, model.opt_state, model.state, xs, ys)
        losses.append(float(loss))
    local = {op: {w: t.detach().numpy().copy() for w, t in ws.items()}
             for op, ws in model.params.items()}
    scores = {k: float(v) for k, v in model.state.items()
              if k.endswith(("/score", "/aux_loss"))}
    return losses, params_to_numpy(model.params, c), local, scores


def leg_models(n):
    """Each leg's model compiled for ``n`` ranks (one process when n is
    1), seeded alike."""
    cfg = dict(device="cpu", compute_dtype="float32", num_devices=n,
               learning_rate=0.05)
    cnn = _cnn(tff.FFConfig(batch_size=CNN_BATCH, **cfg))
    moe = tmods.build_moe(tff.FFConfig(batch_size=EP_BATCH, **cfg), **EP_KW)
    emb = _batched_embedding(tff.FFConfig(batch_size=EMB_BATCH, **cfg))
    for m, views in ((cnn, lambda: views_by_name(cnn, CNN_VIEWS)),
                     (moe, lambda: ep_views(moe, n)),
                     (emb, lambda: views_by_name(emb, EMB_VIEWS))):
        m.compile(strategy=views() if n > 1 else {}, **CCE)
    return {"cnn": cnn, "ep": moe, "emb": emb}


def zoo_rank_legs():
    """Each leg's 2 steps on this rank of a world of 4 (a rank function
    of tests/test_torch_fleet.py calls it)."""
    from flexflow_tpu_torch.runtime import distributed

    n = distributed.world_size()
    data = leg_data()
    return {k: run_leg(m, data[k], n) for k, m in leg_models(n).items()}


@pytest.fixture(scope="module")
def one_process_legs():
    data = leg_data()
    return {k: run_leg(m, data[k], 1) for k, m in leg_models(1).items()}


LEGS = ["cnn", "ep", "emb"]


@pytest.mark.parametrize("leg", LEGS)
def test_split_legs_match_one_process(fleet_world,  # noqa: F811
                                      one_process_legs, leg):
    ranks, _ = fleet_world
    losses, whole, _, scores = one_process_legs[leg]
    for r in ranks:
        got_losses, got_whole, _, got_scores = r["zoo"][leg]
        assert got_scores.keys() == scores.keys()
        for k, v in scores.items():  # the cache's score, the aux loss
            assert abs(got_scores[k] - v) <= STEP_TOL * abs(v), k
        for got, want in zip(got_losses, losses):
            assert abs(got - want) <= STEP_TOL * abs(want), (got_losses,
                                                             losses)
        for op, ws in whole.items():
            for w, v in ws.items():
                np.testing.assert_allclose(got_whole[op][w], v,
                                           rtol=STEP_TOL, atol=STEP_TOL,
                                           err_msg=f"{leg} {op}/{w}")


@pytest.mark.parametrize("leg", LEGS)
def test_split_legs_keep_replicas_bit_equal(fleet_world, leg):  # noqa: F811
    """Every weight a rank holds whole is the same bits on every rank;
    the CNN's split convs and the batched table hold blocks."""
    ranks, _ = fleet_world
    _, whole, first, _ = ranks[0]["zoo"][leg]
    blocks = 0
    for r in ranks[1:]:
        local = r["zoo"][leg][2]
        for op, ws in first.items():
            for w, v in ws.items():
                if tuple(v.shape) != whole[op][w].shape:
                    blocks += 1
                    continue
                assert local[op][w].tobytes() == v.tobytes(), (
                    f"{leg} {op}/{w}")
    assert (blocks > 0) == (leg != "ep")
