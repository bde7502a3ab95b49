"""The int8 KV lane's kernel and op against the JAX package's.

* ``ragged_paged_attention_quant`` (on CPU tensors: its plain version,
  ``ragged_paged_attention_quant_reference``) against the JAX package's
  Pallas kernel ``_rpa_kernel_quant`` in interpret mode and its XLA
  twin ``_xla_ragged_paged_quant``, at tests/test_kv.py:271's shapes:
  1e-5 abs (fp32 math on both sides, summation order differs); the
  int8-vs-fp32-pool drift stays under the reference's 0.05 contract.
* ``_quantize_kv`` payload and scales equal JAX's exactly (the same
  fp32 operations: amax, the 1e-30 floor, a division by 127, a
  correctly rounded division, round half to even, the clip).
* ``DecodeAttentionOp.forward`` and ``forward_chunk`` over fp32, bf16
  and int8 pools, on copied weights and pools: outputs within 1e-5 abs
  (fp32 compute); the pools written equal (fp32 and bf16 payloads and
  int8 scales within 1e-6 relative, int8 payloads within one code:
  the fresh k/v projection sums in another order, which may move a
  value across a rounding boundary).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.core.ptensor import ParallelTensorShape as JShape
from flexflow_tpu.kernels import ragged_paged_attention as jrpa
from flexflow_tpu.ops.base import LoweringContext as JContext
from flexflow_tpu.ops.decode_attention import DecodeAttentionOp as JOp
from flexflow_tpu.ops.decode_attention import _quantize_kv as jax_quantize
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.interop import tensor_from_numpy, tensor_to_numpy
from flexflow_tpu_torch.kernels.ragged_paged_attention import (
    gather_kv_pages_quant,
    ragged_paged_attention,
    ragged_paged_attention_quant,
    ragged_paged_attention_quant_reference,
)
from flexflow_tpu_torch.ops.base import LoweringContext
from flexflow_tpu_torch.ops.decode_attention import (
    DecodeAttentionOp,
    _quantize_kv,
)

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool_inputs(seed=11, P=16, ps=8, H=4, D=16, B=4, pps=4):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(P, ps, H, D)).astype(np.float32)
    v = rng.normal(size=(P, ps, H, D)).astype(np.float32)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    table = rng.permutation(P)[:B * pps].reshape(B, pps).astype(np.int32)
    lens = rng.integers(ps, ps * pps, size=B).astype(np.int32)
    return q, k, v, table, lens


def test_quant_plain_version_matches_jax_kernel_and_xla():
    q, k, v, table, lens = _pool_inputs()
    kq, ks = (np.asarray(a) for a in jax_quantize(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jax_quantize(jnp.asarray(v)))
    jargs = [jnp.asarray(a) for a in (q, kq, vq, ks, vs, table, lens)]
    pallas = np.asarray(jrpa.ragged_paged_attention_quant(*jargs))
    xla = np.asarray(jrpa._xla_ragged_paged_quant(
        *jargs, 1.0 / np.sqrt(q.shape[-1])))
    targs = [tensor_from_numpy(a) for a in (q, kq, vq, ks, vs, table, lens)]
    got = ragged_paged_attention_quant(*targs).numpy()
    plain = ragged_paged_attention_quant_reference(*targs).numpy()
    np.testing.assert_array_equal(got, plain)  # the CPU wrapper is it
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, xla, rtol=0, atol=TOL)
    # the reference's accuracy contract (test_kv.py:292): int8 against
    # the fp32 pool on the same pages
    fp32 = ragged_paged_attention(*(tensor_from_numpy(a) for a in (
        q, k, v, table, lens))).numpy()
    assert np.abs(got - fp32).max() < 0.05


def test_quant_plain_version_gives_zeros_for_an_empty_sequence():
    q, k, v, table, lens = _pool_inputs(seed=3)
    lens[1] = 0
    kq, ks = _quantize_kv(torch.from_numpy(k))
    vq, vs = _quantize_kv(torch.from_numpy(v))
    out = ragged_paged_attention_quant(
        torch.from_numpy(q), kq, vq, ks, vs, torch.from_numpy(table),
        torch.from_numpy(lens))
    assert out[1].abs().max() == 0 and out[0].abs().max() > 0


def test_quantize_kv_equals_jax_exactly():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, 4, 16)).astype(np.float32) * 3.0
    x[0, 0] = 0.0  # an all-zero token: the 1e-30 floor
    x[1, 2, 0, :4] = (0.5, -0.5, 1.5, 2.5)  # ties, to even after scaling
    jq, js = jax_quantize(jnp.asarray(x))
    q, s = _quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (3, 7)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_gather_kv_pages_quant_equals_jax():
    _, k, _, table, _ = _pool_inputs(seed=4)
    kq, ks = (np.asarray(a) for a in jax_quantize(jnp.asarray(k)))
    ref = np.asarray(jrpa.gather_kv_pages_quant(
        jnp.asarray(kq), jnp.asarray(ks), jnp.asarray(table)))
    got = gather_kv_pages_quant(*(tensor_from_numpy(a) for a in (
        kq, ks, table))).numpy()
    np.testing.assert_array_equal(got, ref)


def test_quant_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v, table, lens = (torch.from_numpy(a) for a in _pool_inputs())
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    with pytest.raises(ValueError, match="pools"):
        ragged_paged_attention_quant(q, k, v, ks, vs, table, lens)
    with pytest.raises(ValueError, match="scales"):
        ragged_paged_attention_quant(q, kq, vq, ks[:, :2], vs, table, lens)
    with pytest.raises(ValueError, match="scales"):
        ragged_paged_attention_quant(q, kq, vq, ks.double(), vs, table,
                                     lens)
    with pytest.raises(ValueError, match="pools"):
        ragged_paged_attention(q, kq, vq, table, lens)


# ---------------------------------------------------------------------------
B, E, H, PS, PPS, C = 3, 32, 2, 4, 4, 5
NAME = "dec"


def _decode_ops(pool):
    """The op pair, built for [B, 1, E] frames; ``forward_chunk`` runs
    the same op at [B, C, E]."""
    kw = dict(embed_dim=E, num_heads=H, page_size=PS, pages_per_seq=PPS,
              kv_dtype=pool)
    jshapes = [JShape.make((B, 1, E), "float32"),
               JShape.make((B, PPS), "int32"), JShape.make((B,), "int32")]
    shapes = [ParallelTensorShape.make((B, 1, E), "float32"),
              ParallelTensorShape.make((B, PPS), "int32"),
              ParallelTensorShape.make((B,), "int32")]
    return JOp(NAME, jshapes, **kw), DecodeAttentionOp(NAME, shapes, **kw)


def _compare_pools(state, jstate, pool):
    for key, ref in jstate.items():
        got = tensor_to_numpy(state[key])
        ref = np.asarray(ref)
        assert got.dtype == ref.dtype, key
        if ref.dtype == np.int8:
            assert np.abs(got.astype(np.int32)
                          - ref.astype(np.int32)).max() <= 1, key
        else:
            np.testing.assert_allclose(
                got.astype(np.float32), ref.astype(np.float32), rtol=1e-6,
                atol=1e-6, err_msg=f"{pool} {key}")


@pytest.mark.parametrize("chunk", [False, True], ids=["forward",
                                                       "forward_chunk"])
@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8"])
def test_decode_op_matches_jax_on_every_pool(pool, chunk):
    jop, op = _decode_ops(pool)
    rng = np.random.default_rng(17)
    weights = {ws.name: (rng.normal(size=ws.shape) * 0.2).astype(np.float32)
               for ws in jop._weight_specs}
    jstate, state = {}, {}
    for name, shape, dtype, _ in jop.state_specs():
        if name.endswith("_scale"):
            a = np.abs(rng.normal(size=shape)).astype(np.float32) * 0.02
        elif dtype == jnp.int8:
            a = rng.integers(-127, 128, size=shape).astype(np.int8)
        else:
            a = np.asarray(jnp.asarray(rng.normal(size=shape), dtype))
        jstate[f"{NAME}/{name}"] = jnp.asarray(a)
        state[f"{NAME}/{name}"] = tensor_from_numpy(a)
    assert sorted(state) == sorted(
        f"{NAME}/{n}" for n, *_ in op.state_specs())
    table = rng.permutation(B * PPS).reshape(B, PPS).astype(np.int32)
    if chunk:
        # chunks starting mid-page, one crossing into the last page and
        # one with a pad tail clamped to the allotment's last slot
        start = np.asarray([0, 3, 10], np.int32)
        pos = np.minimum(start[:, None] + np.arange(C), PS * PPS - 1)
        x = rng.normal(size=(B, C, E)).astype(np.float32)
        third = pos.astype(np.int32)
    else:
        x = rng.normal(size=(B, 1, E)).astype(np.float32)
        third = np.asarray([0, 5, 14], np.int32)
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    tw = {k: tensor_from_numpy(v) for k, v in weights.items()}
    jctx = JContext(compute_dtype=jnp.float32, train=False)
    jctx.state_in = jstate
    jins = [jnp.asarray(x), jnp.asarray(table), jnp.asarray(third)]
    (jout,) = (jop.forward_chunk if chunk else jop.forward)(jctx, jins, jw)
    ctx = LoweringContext(compute_dtype=torch.float32, state_in=state)
    tins = [tensor_from_numpy(a) for a in (x, table, third)]
    (out,) = (op.forward_chunk if chunk else op.forward)(ctx, tins, tw)
    assert tuple(out.shape) == tuple(jout.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=TOL)
    # the pools were updated in place and published under their keys
    assert all(ctx.state_out[k] is state[k] for k in state)
    _compare_pools(state, {**jstate, **jctx.state_out}, pool)
