"""The port's MultiHeadAttention op against the JAX package's.

Both ops are built at the same shapes and called on the same numpy
inputs and copied weights; forward outputs and the gradients of the
input and every weight are compared.  At seq 512 both take the flash
route (the JAX op runs the Pallas kernels in interpret mode, the port
the plain versions the CUDA kernels' wrappers compute for CPU tensors);
at seq 32 both take the compact-residual XLA path (``attn_core``).
fp32 compute at 1e-5 on the output and 1e-4 on the gradients (summation
order differs); bf16 compute at 2e-2 on both (bf16 projections round at
the same places on both sides; the port's output projection is also
rounded to bf16, see ops/attention.py).  Output errors are relative to
the largest output entry, gradient errors to the largest gradient entry
of the op: the key bias's true gradient is zero (it shifts every logit
of a row alike), so its computed value is rounding noise on both sides.
"""

from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.core.ptensor import ParallelTensorShape as JShape
from flexflow_tpu.ops.attention import MultiHeadAttentionOp as JMHA
from flexflow_tpu.ops.base import LoweringContext as JContext
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.ops.attention import (
    MultiHeadAttentionOp,
    flash_route,
)
from flexflow_tpu_torch.ops.base import LoweringContext

jfa = importlib.import_module("flexflow_tpu.kernels.flash_attention")

TOLS = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_err(got: torch.Tensor, ref, scale=None) -> float:
    ref = _f32(ref)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max()) if scale is None else scale
    return float(np.abs(got - ref).max()) / max(1e-6, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq,causal,bias", [
    (512, True, False), (512, False, False), (32, True, False),
    (32, False, True)])
def test_mha_forward_and_grads_match_jax(seq, causal, bias, dtype):
    b, e, h = 1, 32, 2
    kw = dict(embed_dim=e, num_heads=h, causal=causal, use_bias=bias)
    jop = JMHA("mha", [JShape.make((b, seq, e), "float32")] * 3, **kw)
    op = MultiHeadAttentionOp(
        "mha", [ParallelTensorShape.make((b, seq, e), "float32")] * 3, **kw)
    assert [(w.name, w.shape) for w in op._weight_specs] == [
        (w.name, w.shape) for w in jop._weight_specs]
    assert op.uses_flash() == (seq == 512)
    rng = np.random.default_rng(seq + causal)
    x = rng.normal(size=(b, seq, e)).astype(np.float32)
    dy = rng.normal(size=(b, seq, e)).astype(np.float32)
    ws = {w.name: (0.2 * rng.normal(size=w.shape)).astype(np.float32)
          for w in op._weight_specs}

    jctx = JContext(compute_dtype=jnp.dtype(dtype), train=True)
    jy, vjp = jax.vjp(lambda x, w: jop.forward(jctx, [x, x, x], w)[0],
                      jnp.asarray(x),
                      {k: jnp.asarray(v) for k, v in ws.items()})
    jgx, jgw = vjp(jnp.asarray(dy))

    ctx = LoweringContext(compute_dtype=getattr(torch, dtype), train=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = {k: torch.from_numpy(v).requires_grad_(True) for k, v in ws.items()}
    y = op.forward(ctx, [tx, tx, tx], tw)[0]
    y.backward(torch.from_numpy(dy))
    out_tol, grad_tol = TOLS[dtype]
    assert y.dtype == torch.float32
    assert _rel_err(y, jy) <= out_tol
    g_scale = max(float(np.abs(_f32(g)).max())
                  for g in [jgx, *jgw.values()])
    assert _rel_err(tx.grad, jgx, g_scale) <= grad_tol
    for k, t in tw.items():
        assert _rel_err(t.grad, jgw[k], g_scale) <= grad_tol, k


def test_attention_dropout_in_training_raises():
    shape = ParallelTensorShape.make((1, 8, 16), "float32")
    op = MultiHeadAttentionOp("mha", [shape] * 3, embed_dim=16, num_heads=1,
                              dropout=0.1)
    x = torch.zeros(1, 8, 16)
    ws = {w.name: torch.zeros(w.shape) for w in op._weight_specs}
    with pytest.raises(NotImplementedError, match="dropout"):
        op.forward(LoweringContext(compute_dtype=torch.float32, train=True),
                   [x, x, x], ws)
    # dropout is inactive outside training, as in the reference
    y = op.forward(LoweringContext(compute_dtype=torch.float32), [x, x, x], ws)
    assert y[0].shape == (1, 8, 16)


@pytest.mark.parametrize("sq,sk,d,use_flash,want", [
    (512, 512, 64, True, True),      # the threshold: sk >= 512
    (1024, 1024, 64, True, True),    # the training path
    (1024, 1024, 64, False, False),  # use_flash off
    (256, 256, 64, True, False),     # below the threshold
    (4096, 256, 64, True, True),     # sq * sk >= 512 * 2048
    (511, 511, 64, True, False),     # no power-of-two block divides 511
    (1024, 1024, 8, True, False),    # a head dim the kernels refuse
    (1024, 1024, 144, True, False),
])
def test_flash_route_is_a_shape_rule(sq, sk, d, use_flash, want):
    assert flash_route(sq, sk, d, use_flash) is want


def test_flash_route_agrees_with_the_reference_on_kernel_head_dims():
    """For head dims the CUDA kernels take, the port routes to flash
    exactly where the reference's MHA calls its flash entry point and
    that entry point runs the Pallas kernels."""
    for sq in (32, 64, 256, 500, 512, 1024, 2048, 4096):
        for sk in (32, 256, 512, 1000, 1024):
            for d in (16, 64, 128):
                ref = ((sk >= 512 or sq * sk >= 512 * 2048)
                       and jfa._pick_block(sq, 512) is not None
                       and jfa._pick_block(sk, 1024) is not None)
                assert flash_route(sq, sk, d, True) == ref, (sq, sk, d)


def test_mha_flops_match_reference():
    for sq, sk in ((64, 64), (32, 128)):
        shapes = [(2, sq, 48), (2, sk, 48), (2, sk, 48)]
        jop = JMHA("mha", [JShape.make(s, "float32") for s in shapes],
                   embed_dim=48, num_heads=3)
        op = MultiHeadAttentionOp(
            "mha", [ParallelTensorShape.make(s, "float32") for s in shapes],
            embed_dim=48, num_heads=3)
        assert op.flops() == jop.flops()
