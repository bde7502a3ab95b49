"""The port's partial-output flash forward (the unnormalized (acc, m, l)
of ring attention's block step) against the JAX package's.

On the CPU ``flash_forward_partial`` computes its plain version, which
is held against the reference's XLA twin (``_xla_attention_partial``)
and against the Pallas kernel (``flash_attention_partial``, interpret
mode, blocks smaller than the sequence so that several k blocks merge
online).  Errors are over max(1, the largest reference entry).  fp32:
within 2e-6 (summation order and exp's last bit; measured 4.3e-7).
bf16 (p rounded to bf16 before p.v on both sides): acc within 2e-2
against the Pallas kernel, which rounds p against its running row max
rather than the final one (measured 1.9e-3), and within 1e-3 against
the XLA twin (the same roundings; a p whose exp lands on the other side
of a bf16 rounding boundary moves one term by 2^-8; measured 1.1e-7);
m and l within 2e-6 (measured 2.4e-7).  Rows with no live
key (causal, Sq > Sk) are held against the XLA twin only (as are the
lengths of 65 and 127, where the reference's entry point takes the twin
itself): the Pallas
kernel leaves such a row's l equal to the keys of the blocks it ran,
which depends on its block size.

The backward (``FlashAttentionPartial``: the reference's recompute,
chunked over 128 query rows, or one whole-matrix recompute) is held
against ``jax.grad`` through the reference's ``flash_attention_partial``
of the loss of tests/test_kernels.py:266-273, at that test's 1e-3
(measured 1.4e-6).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.flash_attention import (
    _xla_attention_partial,
    flash_attention_partial as jax_flash_attention_partial,
)
from flexflow_tpu_torch.interop import tensor_from_numpy
from flexflow_tpu_torch.kernels import flash_attention as fa

B, H, D = 2, 2, 16
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _operands(sq, sk, dtype, seed, d=D):
    rng = np.random.default_rng(seed)
    j = [jnp.asarray(rng.normal(size=(B, s, H, d)), JDTYPE[dtype])
         for s in (sq, sk, sk)]
    return j, [tensor_from_numpy(np.asarray(a)) for a in j]


def _max_err(got, ref):
    """max |got - ref| over max(1, max |ref|)."""
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,d", [
    pytest.param(64, 64, D, id="64-64"), pytest.param(32, 64, D, id="32-64"),
    # one past or one short of the CUDA kernel's 64-row tiles, head dims
    # that pad to 64 and 128 columns: no power-of-two block divides
    # these lengths, so the reference's entry point takes its XLA twin
    (65, 127, 48), (127, 65, 112), (65, 65, 112), (127, 127, 48)])
def test_partial_matches_xla_twin_and_pallas(dtype, causal, sq, sk, d):
    (jq, jk, jv), (q, k, v) = _operands(sq, sk, dtype, seed=sq + sk, d=d)
    scale = 1.0 / math.sqrt(d)
    before = fa.flash_forward_partial.launches
    acc, m, l = fa.flash_forward_partial(q, k, v, causal, scale)
    assert fa.flash_forward_partial.launches == before  # CPU: plain version
    assert acc.shape == (B, H, sq, d) and m.shape == l.shape == (B, H, sq, 1)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    twin = _xla_attention_partial(jq, jk, jv, causal, scale)
    pallas = jax_flash_attention_partial(jq, jk, jv, causal=causal,
                                         scale=scale, block_q=16,
                                         block_k=32)
    acc_tol = {"float32": (2e-6, 2e-6), "bfloat16": (1e-3, 2e-2)}[dtype]
    for ref, tol in zip((twin, pallas), acc_tol):
        assert _max_err(acc, ref[0]) <= tol
        assert _max_err(m, ref[1]) <= 2e-6
        assert _max_err(l, ref[2]) <= 2e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_with_no_live_key_match_the_xla_twin(dtype):
    """Causal with Sq > Sk: the first Sq - Sk rows see no key; the port
    gives m = -1e30, l = Sk and acc = the sum of v there, as the XLA
    twin does."""
    sq, sk = 48, 16
    (jq, jk, jv), (q, k, v) = _operands(sq, sk, dtype, seed=7)
    acc, m, l = fa.flash_forward_partial(q, k, v, True, 0.25)
    twin = _xla_attention_partial(jq, jk, jv, True, 0.25)
    for got, ref in zip((acc, m, l), twin):
        assert _max_err(got, ref) <= (2e-6 if dtype == "float32" else 1e-3)
    dead = sq - sk
    assert bool((m[:, :, :dead] == fa.NEG_INF).all())
    assert bool((l[:, :, :dead] == sk).all())
    torch.testing.assert_close(
        acc[:, :, :dead], v.float().sum(dim=1)[:, :, None, :].expand(
            B, H, dead, D), rtol=1e-6, atol=1e-5)


def _loss_jax(acc, m, l):
    return jnp.sum(jnp.sin(acc / l)) + 0.01 * jnp.sum(m)


def _loss_port(acc, m, l):
    return torch.sin(acc / l).sum() + 0.01 * m.sum()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [256, 128, 96])
def test_backward_matches_jax_grad(causal, s):
    """Sq 256: two chunks of 128 rows; 128: one chunk covers it, so one
    whole-matrix recompute; 96: three chunks of 32."""
    rng = np.random.default_rng(s)
    qkv = [rng.normal(size=(1, s, H, D)).astype(np.float32)
           for _ in range(3)]
    scale = 1.0 / math.sqrt(D)
    ref = jax.grad(
        lambda q, k, v: _loss_jax(*jax_flash_attention_partial(
            q, k, v, causal=causal, scale=scale)),
        argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in qkv]
    _loss_port(*fa.flash_attention_partial(*ts, causal, scale)).backward()
    for t, g in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-3, atol=1e-3)


def test_wrapper_refuses_bad_operands():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_forward_partial(q[..., :8], q[..., :8], q[..., :8], False,
                                 1.0)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_forward_partial(q, q.bfloat16(), q, False, 1.0)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_forward_partial(q, q[:, :, :1], q[:, :, :1], False, 1.0)
    with pytest.raises(ValueError, match="k and v alike"):
        fa.flash_forward_partial(q, q, q[:, :4], False, 1.0)
