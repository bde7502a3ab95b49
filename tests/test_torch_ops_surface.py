"""The ops this slice ports against the JAX package's: the whole unary,
scalar and binary tables of ``ops/elementwise.py``, the linear
activations, ``MeanOp``/``TopKOp``/``GatherOp``, ``BatchMatmulOp`` and
``SoftmaxOp``, forward and (for the differentiable ones) the input
gradients, on the same numpy inputs.

fp32: within 1e-6 of the largest reference value, the ops with a
product (dense, batch matmul) within 1e-5 (the summation order of the
two libraries' products; tests/test_torch_training.py's fp32 limit).
bf16 (the ops keep their input dtype, so the inputs and outputs are
bf16): the gradients within the attention tests' 1e-2
(tests/test_torch_attention.py ``TOLS``); the outputs within the
attention tests' 2e-3 of the largest value or two bf16 ulps of each
element (2**-6 of it), whichever is larger: the port computes an
elementwise op in fp32 and rounds once, the reference's XLA evaluates
some in bf16 steps (its bf16 sigmoid(0.2949) is 0.5703, one of the two
neighbours of 0.5732 further off than the port's 0.5742; rsqrt differs
by one ulp too).  The propagate rules are the
reference's: every op's ``OpSharding`` under a split view equals the
JAX op's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.core.machine import MachineView as JView
from flexflow_tpu.core.optype import OperatorType as JType
from flexflow_tpu.core.ptensor import ParallelTensorShape as JShape
from flexflow_tpu.ops.attention import BatchMatmulOp as JBmm
from flexflow_tpu.ops.base import LoweringContext as JContext
from flexflow_tpu.ops.elementwise import ElementBinaryOp as JBinary
from flexflow_tpu.ops.elementwise import ElementUnaryOp as JUnary
from flexflow_tpu.ops.linear import LinearOp as JLinear
from flexflow_tpu.ops.norm import SoftmaxOp as JSoftmax
from flexflow_tpu.ops.reductions import GatherOp as JGather
from flexflow_tpu.ops.reductions import MeanOp as JMean
from flexflow_tpu.ops.reductions import TopKOp as JTopK
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.ops import (
    BatchMatmulOp,
    ElementBinaryOp,
    ElementUnaryOp,
    GatherOp,
    LinearOp,
    MeanOp,
    SoftmaxOp,
    TopKOp,
)
from flexflow_tpu_torch.ops.base import LoweringContext

TOLS = {"float32": (1e-6, 1e-6), "bfloat16": (2e-3, 1e-2)}
PRODUCT_TOL = 1e-5  # fp32 outputs and gradients of dense and batch matmul
ULPS_BF16 = 2.0 ** -6  # two ulps of a bf16 value
DTYPES = ("float32", "bfloat16")
UNARY = ("relu", "sigmoid", "tanh", "elu", "gelu", "exp", "log",
         "identity", "rsqrt")
SCALAR = (("pow", 2.0), ("scalar_add", 0.5), ("scalar_sub", 1.5),
          ("scalar_mul", -3.0), ("scalar_true_div", 4.0))
BINARY = ("ew_add", "ew_sub", "ew_mul", "ew_div", "ew_max", "ew_min")
ACTIVATIONS = ("relu", "sigmoid", "tanh", "gelu", "softmax", None)


def _np(shape, seed, positive=False):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.abs(x) + 0.5 if positive else x


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


def _close(got, ref, tol):
    """Within ``tol`` of the largest reference value; a bf16 result also
    passes within two ulps of each element."""
    bf16 = got.dtype == torch.bfloat16
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    allowed = np.full(ref.shape, tol * scale, np.float32)
    if bf16:
        allowed = np.maximum(allowed, ULPS_BF16 * np.abs(ref))
    assert bool((np.abs(got - ref) <= allowed).all()), float(
        np.abs(got - ref).max())


def _pair_forward(port_op, jax_op, xs, dtype, grad=True):
    """Forward (and the gradient of sum(y * dy) w.r.t. the float inputs)
    of both ops on the numpy inputs ``xs``."""
    out_tol, grad_tol = TOLS[dtype]
    floats = [x.dtype == np.float32 for x in xs]
    tx = [_torch(x, dtype).requires_grad_(grad) if f else torch.from_numpy(x)
          for x, f in zip(xs, floats)]
    jx = [_jax(x, dtype) if f else jnp.asarray(x)
          for x, f in zip(xs, floats)]
    ys = port_op.forward(LoweringContext(compute_dtype=torch.float32), tx,
                         {})
    jys = jax_op.forward(JContext(compute_dtype=jnp.float32, train=False),
                         jx, {})
    for y, jy in zip(ys, jys):
        assert str(y.dtype) == f"torch.{jy.dtype}"
        _close(y, jy, out_tol)
    if not grad:
        return
    dy = _np(tuple(ys[0].shape), 99)
    ys[0].backward(_torch(dy, dtype))
    fi = [i for i, f in enumerate(floats) if f]

    def f(*args):
        full = list(jx)
        for i, a in zip(fi, args):
            full[i] = a
        y = jax_op.forward(JContext(compute_dtype=jnp.float32, train=False),
                           full, {})[0]
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(dy))

    jg = jax.grad(f, argnums=tuple(range(len(fi))))(*[jx[i] for i in fi])
    for i, g in zip(fi, jg):
        _close(tx[i].grad, g, grad_tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", UNARY)
def test_unary_table_matches_the_reference(kind, dtype):
    shape = (3, 5, 8)
    x = _np(shape, 1, positive=kind in ("log", "rsqrt"))
    op = ElementUnaryOp("u", [ParallelTensorShape.make(shape, dtype)],
                        unary_type=OperatorType(kind))
    jop = JUnary("u", [JShape.make(shape, dtype)], unary_type=JType(kind))
    assert op.signature() == jop.signature()
    _pair_forward(op, jop, [x], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_exact_gelu_matches_the_reference(dtype):
    shape = (4, 8)
    x = _np(shape, 2)
    op = ElementUnaryOp("g", [ParallelTensorShape.make(shape, dtype)],
                        unary_type=OperatorType.GELU, approximate=False)
    jop = JUnary("g", [JShape.make(shape, dtype)], unary_type=JType.GELU,
                 approximate=False)
    assert op.signature() == jop.signature()
    _pair_forward(op, jop, [x], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,scalar", SCALAR)
def test_scalar_table_matches_the_reference(kind, scalar, dtype):
    shape = (3, 5, 8)
    x = _np(shape, 3)
    op = ElementUnaryOp("s", [ParallelTensorShape.make(shape, dtype)],
                        unary_type=OperatorType(kind), scalar=scalar)
    jop = JUnary("s", [JShape.make(shape, dtype)], unary_type=JType(kind),
                 scalar=scalar)
    _pair_forward(op, jop, [x], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", BINARY)
def test_binary_table_matches_the_reference(kind, dtype):
    a_shape, b_shape = (3, 5, 8), (5, 8)  # numpy broadcasting
    a = _np(a_shape, 4)
    b = _np(b_shape, 5, positive=kind == "ew_div")
    shapes = [ParallelTensorShape.make(a_shape, dtype),
              ParallelTensorShape.make(b_shape, dtype)]
    op = ElementBinaryOp("b", shapes, binary_type=OperatorType(kind))
    jop = JBinary("b", [JShape.make(a_shape, dtype),
                        JShape.make(b_shape, dtype)],
                  binary_type=JType(kind))
    assert op.output_shapes[0].sizes == jop.output_shapes[0].sizes
    _pair_forward(op, jop, [a, b], dtype)
    mv, jmv = MachineView((3, 1, 2)), JView((3, 1, 2))
    assert str(op.propagate(mv)) == str(jop.propagate(jmv))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_linear_activations_match_the_reference(activation, dtype):
    shape = (4, 6, 16)
    x = _np(shape, 6)
    w = {"kernel": _np((16, 8), 7) * 0.3, "bias": _np((8,), 8)}
    op = LinearOp("d", [ParallelTensorShape.make(shape, dtype)], out_dim=8,
                  activation=activation)
    jop = JLinear("d", [JShape.make(shape, dtype)], out_dim=8,
                  activation=activation)
    out_tol, grad_tol = (PRODUCT_TOL, PRODUCT_TOL) if (
        dtype == "float32") else TOLS[dtype]
    cd = getattr(torch, dtype)
    tx = _torch(x, dtype).requires_grad_(True)
    tw = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    y = op.forward(LoweringContext(compute_dtype=cd), [tx], tw)[0]
    ctx = JContext(compute_dtype=getattr(jnp, dtype), train=False)
    jy = jop.forward(ctx, [_jax(x, dtype)], {k: jnp.asarray(v)
                                              for k, v in w.items()})[0]
    _close(y, jy, out_tol)
    dy = _np(tuple(y.shape), 9)
    y.backward(_torch(dy, dtype))

    def f(xx, ww):
        out = jop.forward(ctx, [xx], ww)[0]
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dy))

    gx, gw = jax.grad(f, argnums=(0, 1))(
        _jax(x, dtype), {k: jnp.asarray(v) for k, v in w.items()})
    _close(tx.grad, gx, grad_tol)
    for k in w:
        _close(tw[k].grad, gw[k], grad_tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dims,keepdims", [((1,), False), ((0, 2), True),
                                           ((0, 1, 2), False)])
def test_mean_matches_the_reference(dims, keepdims, dtype):
    shape = (4, 6, 8)
    x = _np(shape, 10)
    op = MeanOp("m", [ParallelTensorShape.make(shape, dtype)], dims=dims,
                keepdims=keepdims)
    jop = JMean("m", [JShape.make(shape, dtype)], dims=dims,
                keepdims=keepdims)
    assert op.output_shapes[0].sizes == jop.output_shapes[0].sizes
    _pair_forward(op, jop, [x], dtype)
    nd = op.output_shapes[0].ndim
    degs = (2,) + (1,) * (nd - 1)
    assert str(op.propagate(MachineView(degs))) == str(
        jop.propagate(JView(degs)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_topk_matches_the_reference(dtype):
    shape = (4, 5, 16)
    x = _np(shape, 11)
    op = TopKOp("t", [ParallelTensorShape.make(shape, dtype)], k=3)
    jop = JTopK("t", [JShape.make(shape, dtype)], k=3)
    ys = op.forward(LoweringContext(), [_torch(x, dtype)], {})
    jys = jop.forward(JContext(train=False), [_jax(x, dtype)], {})
    _close(ys[0], jys[0], TOLS[dtype][0])
    assert ys[1].dtype == torch.int32
    np.testing.assert_array_equal(ys[1].numpy(), np.asarray(jys[1]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_gather_matches_the_reference(axis, dtype):
    shape = (5, 6, 7)
    x = _np(shape, 12)
    n = shape[axis]
    idx = np.random.default_rng(13).integers(0, n, size=(2, 3)).astype(
        np.int32)
    shapes = [ParallelTensorShape.make(shape, dtype),
              ParallelTensorShape.make(idx.shape, "int32")]
    op = GatherOp("g", shapes, axis=axis)
    jop = JGather("g", [JShape.make(shape, dtype),
                        JShape.make(idx.shape, "int32")], axis=axis)
    assert op.output_shapes[0].sizes == jop.output_shapes[0].sizes
    _pair_forward(op, jop, [x, idx], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_matmul_matches_the_reference(dtype):
    a_shape, b_shape = (3, 5, 16), (3, 16, 7)
    a, b = _np(a_shape, 14), _np(b_shape, 15)
    op = BatchMatmulOp("bmm", [ParallelTensorShape.make(a_shape, dtype),
                               ParallelTensorShape.make(b_shape, dtype)])
    jop = JBmm("bmm", [JShape.make(a_shape, dtype),
                       JShape.make(b_shape, dtype)])
    cd = getattr(torch, dtype)
    ta = _torch(a, dtype).requires_grad_(True)
    tb = _torch(b, dtype).requires_grad_(True)
    y = op.forward(LoweringContext(compute_dtype=cd), [ta, tb], {})[0]
    ctx = JContext(compute_dtype=getattr(jnp, dtype), train=False)
    jy = jop.forward(ctx, [_jax(a, dtype), _jax(b, dtype)], {})[0]
    out_tol, grad_tol = (PRODUCT_TOL, PRODUCT_TOL) if (
        dtype == "float32") else TOLS[dtype]
    _close(y, jy, out_tol)
    dy = _np(tuple(y.shape), 16)
    y.backward(_torch(dy, dtype))
    ga, gb = jax.grad(lambda p, q: jnp.sum(jop.forward(ctx, [p, q], {})[0]
                                           .astype(jnp.float32)
                                           * jnp.asarray(dy)),
                      argnums=(0, 1))(_jax(a, dtype), _jax(b, dtype))
    _close(ta.grad, ga, grad_tol)
    _close(tb.grad, gb, grad_tol)
    mv, jmv = MachineView((3, 1, 1), replica_degree=2), JView(
        (3, 1, 1), replica_degree=2)
    assert str(op.propagate(mv)) == str(jop.propagate(jmv))
    assert op.flops() == jop.flops()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax_matches_the_reference(axis, dtype):
    shape = (3, 6, 8)
    x = _np(shape, 17)
    op = SoftmaxOp("sm", [ParallelTensorShape.make(shape, dtype)], axis=axis)
    jop = JSoftmax("sm", [JShape.make(shape, dtype)], axis=axis)
    _pair_forward(op, jop, [x], dtype)
    assert op.splittable_output_dims() == jop.splittable_output_dims()
    assert str(op.propagate(MachineView((3, 1, 1)))) == str(
        jop.propagate(JView((3, 1, 1))))
