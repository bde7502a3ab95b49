"""The port's flash attention against the JAX package's.

The plain versions beside the CUDA kernels (``flash_forward_reference``,
``flash_backward_reference``, which the wrappers compute for CPU
tensors) are held against the Pallas kernels run in interpret mode
(``_flash_forward(..., save_lse=True, interpret=True)`` and
``_flash_backward(..., interpret=True)``, as tests/test_kernels.py runs
them), causal and not, Sq = Sk and Sq < Sk, head dims 32 and 64.

Tolerances: fp32 inputs 2e-5 abs on out and lse and 2e-4 abs on the
gradients (the same function; blocking and summation order differ).
bf16 inputs: out within 2 bf16 ulps of its magnitude (8e-3 relative to
the largest |out|), lse 1e-4 abs, gradients 2e-2 relative to the largest
gradient entry: both sides round p and ds to bf16, the Pallas kernel p
relative to its running max per key block, the plain version relative
to the row's final max, so single roundings land differently.

Rows with no live key (causal, Sq > Sk) are held against the XLA path
``_xla_attention`` (uniform attention, zero q/k gradients), where the
Pallas kernel's value depends on its block size.
"""

from __future__ import annotations

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu_torch.kernels import flash_attention as fa

# the module, not the function flexflow_tpu.kernels re-exports by its name
jfa = importlib.import_module("flexflow_tpu.kernels.flash_attention")

FP32_OUT_TOL = 2e-5
FP32_GRAD_TOL = 2e-4
BF16_OUT_RTOL = 8e-3
BF16_LSE_TOL = 1e-4
BF16_GRAD_RTOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, h, d)).astype(np.float32)
    do = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _both(arrays, dtype):
    """The same numpy arrays as jax and torch arrays of one dtype (both
    round fp32 to bf16 to nearest even)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, ref, tol, rel=False, what=""):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if rel else 1.0
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (
        f"{what}: max abs err {err:.3e} > {tol * scale:.3e}")


CASES = [  # (causal, sq, sk, d)
    (False, 64, 64, 32), (True, 64, 64, 32), (False, 32, 64, 64),
    (True, 32, 64, 64), (True, 64, 64, 64), (False, 64, 64, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk,d", CASES)
def test_plain_versions_match_pallas_kernels(causal, sq, sk, d, dtype):
    b, h = 2, 2
    scale = 1.0 / math.sqrt(d)
    (jq, jk, jv, jdo), (q, k, v, do) = _both(_inputs(b, sq, sk, h, d),
                                             dtype)
    jout, jlse = jfa._flash_forward(jq, jk, jv, causal, scale, 32, 32,
                                    interpret=True, save_lse=True)
    jdq, jdk, jdv = jfa._flash_backward(jq, jk, jv, jout, jlse, jdo, causal,
                                        scale, 32, 32, interpret=True)
    out, lse = fa.flash_forward_reference(q, k, v, causal, scale)
    dq, dk, dv = fa.flash_backward_reference(q, k, v, out, lse, do, causal,
                                             scale)
    jlse = np.asarray(jlse).reshape(b, h, sq)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    if dtype == "float32":
        _close(out, jout, FP32_OUT_TOL, what="out")
        _close(lse, jlse, FP32_OUT_TOL, what="lse")
        for name, g, jg in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
            _close(g, jg, FP32_GRAD_TOL, what=name)
    else:
        _close(out, jout, BF16_OUT_RTOL, rel=True, what="out")
        _close(lse, jlse, BF16_LSE_TOL, what="lse")
        for name, g, jg in (("dq", dq, jdq), ("dk", dk, jdk),
                            ("dv", dv, jdv)):
            assert g.dtype == torch.bfloat16
            _close(g, jg, BF16_GRAD_RTOL, rel=True, what=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_autograd_matches_jax_flash_attention(causal):
    """The autograd Function (the wrappers' CPU path) against the JAX
    entry point's custom VJP, which runs the Pallas kernels."""
    (jq, jk, jv, jdo), (q, k, v, do) = _both(_inputs(1, 64, 64, 2, 32, 3),
                                             "float32")
    jout, vjp = jax.vjp(
        lambda q, k, v: jfa.flash_attention(q, k, v, causal=causal),
        jq, jk, jv)
    jgrads = vjp(jdo)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    before = (fa.flash_forward.launches, fa.flash_backward_dq.launches,
              fa.flash_backward_dkv.launches)
    out = fa.flash_attention(q, k, v, causal=causal)
    out.backward(do)
    _close(out, jout, FP32_OUT_TOL, what="out")
    for name, t, jg in zip(("dq", "dk", "dv"), (q, k, v), jgrads):
        _close(t.grad, jg, FP32_GRAD_TOL, what=name)
    # CPU tensors take the plain versions: no kernel was launched
    assert (fa.flash_forward.launches, fa.flash_backward_dq.launches,
            fa.flash_backward_dkv.launches) == before


def test_rows_without_a_live_key_follow_the_xla_path():
    """Causal with Sq > Sk: the first Sq - Sk rows see no key.  The port
    gives them uniform attention over all keys and zero q/k gradients,
    as ``_xla_attention`` does."""
    sq, sk, d = 48, 16, 32
    scale = 1.0 / math.sqrt(d)
    (jq, jk, jv, jdo), (q, k, v, do) = _both(_inputs(2, sq, sk, 2, d, 5),
                                             "float32")
    jout, vjp = jax.vjp(
        lambda q, k, v: jfa._xla_attention(q, k, v, True, scale), jq, jk, jv)
    jdq, jdk, jdv = vjp(jdo)
    out, lse = fa.flash_forward_reference(q, k, v, True, scale)
    _close(out, jout, FP32_OUT_TOL, what="out")
    np.testing.assert_allclose(out[:, :sq - sk].numpy(),
                               v.mean(dim=1, keepdim=True).expand(
                                   -1, sq - sk, -1, -1).numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(lse[:, :, :sq - sk].numpy(), math.log(sk),
                               rtol=1e-6)
    dq, dk, dv = fa.flash_backward_reference(q, k, v, out, lse, do, True,
                                             scale)
    assert float(dq[:, :sq - sk].abs().max()) == 0.0
    for name, g, jg in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        _close(g, jg, FP32_GRAD_TOL, what=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk", [(False, 24, 40), (True, 24, 40),
                                          (True, 40, 24), (True, 32, 32)])
def test_attn_core_matches_jax(causal, sq, sk, dtype):
    """The compact-residual ``attn_core`` (the MHA op's path below the
    flash threshold) against the JAX ``_attn_core``, forward and VJP;
    bf16 at the bf16 tolerances above (the same roundings on both sides,
    summation order differs)."""
    d = 16
    scale = 1.0 / math.sqrt(d)
    (jq, jk, jv, jdo), (q, k, v, do) = _both(_inputs(2, sq, sk, 2, d, 7),
                                             dtype)
    jout, vjp = jax.vjp(lambda q, k, v: jfa._attn_core(q, k, v, causal,
                                                        scale), jq, jk, jv)
    jgrads = vjp(jdo)
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = fa.attn_core(q, k, v, causal, scale)
    out.backward(do)
    fp32 = dtype == "float32"
    _close(out, jout, FP32_OUT_TOL if fp32 else BF16_OUT_RTOL, rel=not fp32,
           what="out")
    for name, t, jg in zip(("dq", "dk", "dv"), (q, k, v), jgrads):
        assert t.grad.dtype == t.dtype
        _close(t.grad, jg, FP32_GRAD_TOL if fp32 else BF16_GRAD_RTOL,
               rel=not fp32, what=name)
    if causal and sq > sk:
        assert float(q.grad[:, :sq - sk].abs().max()) == 0.0


@pytest.mark.parametrize("d", [8, 24, 144])
def test_refused_head_dims_raise(d):
    q = torch.zeros(1, 4, 1, d)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_forward(q, q, q, False, 1.0)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)


def test_mixed_dtypes_and_shapes_raise():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_forward(q, q.bfloat16(), q, False, 1.0)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_forward(q, torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 3, 16),
                         False, 1.0)


def test_pick_block_matches_reference():
    for size in (1, 7, 8, 24, 32, 96, 100, 512, 1000, 1024, 4096):
        for want in (8, 64, 512, 1024):
            assert fa._pick_block(size, want) == jfa._pick_block(size, want)
