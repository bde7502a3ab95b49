"""The port's conv and pool (``flexflow_tpu_torch/ops/conv.py``) against
the JAX package's ``Conv2DOp`` and ``Pool2DOp`` on the same numpy
inputs and HWIO kernels, op by op.

* Conv forward and the gradients of x, the kernel and the bias over
  stride 1/2, padding 0/1/3, groups 1/4 and bias on/off (no
  activation), and each of the reference's activations.
* Pool max and avg over stride 1/2, padding 0/1, and a padding above
  half the kernel (which torch's pools refuse; the port pads
  explicitly), forward and input gradient.
* ``propagate`` and the cost hooks (``flops``, ``bytes_accessed``,
  ``max_replica_degree``, ``splittable_output_dims``) equal the JAX
  op's, under batch, spatial, out-channel and in-channel views.

fp32: within 1e-5 of the largest reference value (the two libraries'
convolutions sum in different orders; tests/test_torch_training.py's
fp32 limit).  bf16 (the input and the compute dtype bf16, as
tests/test_torch_ops_surface.py runs the dense op): outputs within 2e-3
of the largest value or two bf16 ulps of each element, gradients within
1e-2 of the largest value (that file's ``TOLS``).  The spatially and
in-channel split convs run over ranks in tests/test_torch_zoo.py's
shared world.
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.core.machine import MachineView as JView
from flexflow_tpu.core.ptensor import ParallelTensorShape as JShape
from flexflow_tpu.ops.base import LoweringContext as JContext
from flexflow_tpu.ops.conv import Conv2DOp as JConv
from flexflow_tpu.ops.conv import Pool2DOp as JPool
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.ops import Conv2DOp, Pool2DOp
from flexflow_tpu_torch.ops.base import LoweringContext

TOLS = {"float32": (1e-5, 1e-5), "bfloat16": (2e-3, 1e-2)}
ULPS_BF16 = 2.0 ** -6  # two ulps of a bf16 value
SHAPE = (2, 9, 9, 8)  # N, H, W, Cin

CONV_CASES = [dict(stride=s, pad=p, groups=g, bias=b, act=None)
              for s, p, g, b in itertools.product((1, 2), (0, 1, 3), (1, 4),
                                                  (True, False))]
CONV_CASES += [dict(stride=1, pad=1, groups=1, bias=True, act=a)
               for a in ("relu", "sigmoid", "tanh", "gelu")]
BF16_CASES = [CONV_CASES[i] for i in (0, 7, 13, 22)] + CONV_CASES[-2:]
POOL_CASES = [dict(kind=k, k=3, stride=s, pad=p)
              for k, s, p in itertools.product(("max", "avg"), (1, 2),
                                               (0, 1))]
# padding above half the kernel: torch's pools refuse it (with k 2 the
# first max window lies wholly in the padding: -inf in both)
POOL_CASES += [dict(kind=k, k=2, stride=2, pad=2) for k in ("max", "avg")]
POOL_CASES += [dict(kind=k, k=3, stride=1, pad=2) for k in ("max", "avg")]


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, ref, tol):
    """Within ``tol`` of the largest finite reference value; a bf16
    result also passes within two ulps of each element.  An infinite
    reference value (a max-pool window wholly in the padding) must be
    met exactly."""
    bf16 = got.dtype == torch.bfloat16
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    inf = np.isinf(ref)
    assert bool((got[inf] == ref[inf]).all())
    got, ref = np.where(inf, 0.0, got), np.where(inf, 0.0, ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    allowed = np.full(ref.shape, tol * scale, np.float32)
    if bf16:
        allowed = np.maximum(allowed, ULPS_BF16 * np.abs(ref))
    assert bool((np.abs(got - ref) <= allowed).all()), float(
        np.abs(got - ref).max())


def _conv_ops(case, dtype, shape=SHAPE, out=8, kernel=3):
    kw = dict(out_channels=out, kernel_h=kernel, kernel_w=kernel,
              stride_h=case["stride"], stride_w=case["stride"],
              padding_h=case["pad"], padding_w=case["pad"],
              groups=case["groups"], activation=case["act"],
              use_bias=case["bias"])
    op = Conv2DOp("c", [ParallelTensorShape.make(shape, dtype)], **kw)
    jop = JConv("c", [JShape.make(shape, dtype)], **kw)
    return op, jop


def _check_conv(case, dtype):
    op, jop = _conv_ops(case, dtype)
    assert op.signature() == jop.signature()
    assert op.output_shapes[0].sizes == jop.output_shapes[0].sizes
    out_tol, grad_tol = TOLS[dtype]
    x = _np(SHAPE, 1)
    w = {"kernel": _np(jop._weight_specs[0].shape, 2, scale=0.3)}
    if case["bias"]:
        w["bias"] = _np((8,), 3)
    td = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(td).requires_grad_(True)
    tw = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    y = op.forward(LoweringContext(compute_dtype=td), [tx], tw)[0]
    ctx = JContext(compute_dtype=getattr(jnp, dtype), train=False)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jy = jop.forward(ctx, [jx], jw)[0]
    assert str(y.dtype) == f"torch.{jy.dtype}"
    _close(y, jy, out_tol)
    dy = _np(tuple(y.shape), 4)
    y.backward(torch.from_numpy(dy).to(td))

    def f(xx, ww):
        out = jop.forward(ctx, [xx], ww)[0]
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dy))

    gx, gw = jax.grad(f, argnums=(0, 1))(jx, jw)
    _close(tx.grad, gx, grad_tol)
    for k in w:
        _close(tw[k].grad, gw[k], grad_tol)


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                c.items()))
def test_conv_forward_and_gradients_fp32(case):
    _check_conv(case, "float32")


@pytest.mark.parametrize("case", BF16_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                c.items()))
def test_conv_forward_and_gradients_bf16(case):
    _check_conv(case, "bfloat16")


@pytest.mark.parametrize("case", POOL_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                c.items()))
def test_pool_forward_and_gradient(case):
    kw = dict(kernel_h=case["k"], kernel_w=case["k"],
              stride_h=case["stride"], stride_w=case["stride"],
              padding_h=case["pad"], padding_w=case["pad"],
              pool_type=case["kind"])
    op = Pool2DOp("p", [ParallelTensorShape.make(SHAPE, "float32")], **kw)
    jop = JPool("p", [JShape.make(SHAPE, "float32")], **kw)
    assert op.output_shapes[0].sizes == jop.output_shapes[0].sizes
    x = _np(SHAPE, 5)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = op.forward(LoweringContext(compute_dtype=torch.float32), [tx], {})[0]
    ctx = JContext(compute_dtype=jnp.float32, train=False)
    jy = jop.forward(ctx, [jnp.asarray(x)], {})[0]
    _close(y, jy, 1e-6)
    dy = _np(tuple(y.shape), 6)
    y.backward(torch.from_numpy(dy))
    gx = jax.grad(lambda xx: jnp.sum(jop.forward(ctx, [xx], {})[0]
                                     * jnp.asarray(dy)))(jnp.asarray(x))
    _close(tx.grad, gx, 1e-6)


def test_pool_activation_matches_the_reference():
    kw = dict(kernel_h=2, kernel_w=2, stride_h=2, stride_w=2,
              pool_type="avg", activation="tanh")
    op = Pool2DOp("p", [ParallelTensorShape.make(SHAPE, "float32")], **kw)
    jop = JPool("p", [JShape.make(SHAPE, "float32")], **kw)
    x = _np(SHAPE, 7)
    y = op.forward(LoweringContext(), [torch.from_numpy(x)], {})[0]
    _close(y, jop.forward(JContext(train=False), [jnp.asarray(x)], {})[0],
           1e-6)


VIEWS = [((2, 1, 1, 1), 1), ((1, 2, 1, 1), 1), ((1, 1, 2, 1), 1),
         ((1, 1, 1, 2), 1), ((1, 1, 1, 1), 2), ((2, 2, 1, 1), 2),
         ((1, 3, 1, 2), 1)]


@pytest.mark.parametrize("groups", [1, 4])
def test_conv_and_pool_hooks_equal_the_references(groups):
    case = dict(stride=2, pad=1, groups=groups, bias=True, act="relu")
    op, jop = _conv_ops(case, "float32", shape=(4, 12, 12, 8))
    kw = dict(kernel_h=3, kernel_w=3, stride_h=2, stride_w=2, padding_h=1,
              padding_w=1, pool_type="max")
    pool = Pool2DOp("p", [ParallelTensorShape.make((4, 12, 12, 8),
                                                   "float32")], **kw)
    jpool = JPool("p", [JShape.make((4, 12, 12, 8), "float32")], **kw)
    for a, b in ((op, jop), (pool, jpool)):
        assert a.flops() == b.flops()
        assert a.bytes_accessed() == b.bytes_accessed()
        assert a.max_replica_degree() == b.max_replica_degree()
        assert a.splittable_output_dims() == b.splittable_output_dims()
        for degs, r in VIEWS:
            assert str(a.propagate(MachineView(degs, replica_degree=r))) == (
                str(b.propagate(JView(degs, replica_degree=r))))
