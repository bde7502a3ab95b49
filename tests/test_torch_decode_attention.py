"""The port's DecodeAttentionOp against the JAX package's, on copied
weights and a copied KV pool, over 3 consecutive frames with the state
threaded on both sides.  The outputs and the updated pools must agree:
fp32 compute at 1e-5 abs (same math, different summation order); bf16
compute at 5e-2 abs (the frameworks round bf16 at other places)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.core.ptensor import ParallelTensorShape as JShape
from flexflow_tpu.ops.base import LoweringContext as JContext
from flexflow_tpu.ops.decode_attention import DecodeAttentionOp as JOp
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.interop import tensor_from_numpy
from flexflow_tpu_torch.ops.base import LoweringContext
from flexflow_tpu_torch.ops.decode_attention import DecodeAttentionOp

B, E, H, PS, PPS = 3, 32, 2, 8, 3
NAME = "dec"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from threads; one keeps this file from
    crowding the other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {
    # (compute dtype, pool dtype, tolerance)
    "fp32": ("float32", "fp32", 1e-5),
    "fp32_bf16_pool": ("float32", "bf16", 1e-5),
    "bf16_compute": ("bfloat16", "fp32", 5e-2),
}


def _shapes(mk):
    return [mk((B, 1, E), "float32"), mk((B, PPS), "int32"),
            mk((B,), "int32")]


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_op_matches_jax_over_threaded_frames(case):
    cd, pool, tol = CASES[case]
    kw = dict(embed_dim=E, num_heads=H, page_size=PS, pages_per_seq=PPS,
              kv_dtype=pool)
    jop = JOp(NAME, _shapes(JShape.make), **kw)
    op = DecodeAttentionOp(NAME, _shapes(ParallelTensorShape.make), **kw)
    rng = np.random.default_rng(7)
    weights = {ws.name: (rng.normal(size=ws.shape) * 0.2).astype(np.float32)
               for ws in jop._weight_specs}
    assert {ws.name: ws.shape for ws in op._weight_specs} == {
        k: v.shape for k, v in weights.items()}
    # a pool holding earlier tokens, so the scatter and the reads of
    # already-cached positions are both exercised
    jstate, state = {}, {}
    for name, shape, dtype, _ in jop.state_specs():
        a = np.asarray(jnp.asarray(rng.normal(size=shape), dtype))
        jstate[f"{NAME}/{name}"] = jnp.asarray(a)
        state[f"{NAME}/{name}"] = tensor_from_numpy(a)
    table = rng.permutation(B * PPS).reshape(B, PPS).astype(np.int32)
    start = np.asarray([0, 7, 15], np.int32)  # crosses page boundaries
    jcd = jnp.float32 if cd == "float32" else jnp.bfloat16
    tcd = torch.float32 if cd == "float32" else torch.bfloat16
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    tw = {k: tensor_from_numpy(v) for k, v in weights.items()}
    for t in range(3):
        x = rng.normal(size=(B, 1, E)).astype(np.float32)
        lens = start + t
        jctx = JContext(compute_dtype=jcd, train=False)
        jctx.state_in = jstate
        (jout,) = jop.forward(
            jctx, [jnp.asarray(x), jnp.asarray(table), jnp.asarray(lens)],
            jw)
        jstate = {**jstate, **jctx.state_out}
        ctx = LoweringContext(compute_dtype=tcd, state_in=state)
        (out,) = op.forward(
            ctx, [tensor_from_numpy(x), tensor_from_numpy(table),
                  tensor_from_numpy(lens)], tw)
        state = {**state, **ctx.state_out}
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   rtol=0, atol=tol)
        for key, ref in jstate.items():
            np.testing.assert_allclose(
                state[key].float().numpy(),
                np.asarray(ref, np.float32), rtol=0, atol=tol,
                err_msg=f"{key} after frame {t}")


def test_decode_op_rejects_the_int8_pool_until_ported():
    with pytest.raises(NotImplementedError):
        DecodeAttentionOp(NAME, _shapes(ParallelTensorShape.make),
                          embed_dim=E, num_heads=H, kv_dtype="int8")
