"""The port's ragged paged attention (plain version, the path CPU
tensors take) against the JAX package's Pallas kernel in interpret mode
and its dense oracle.  Inputs are made with numpy from a seed and handed
to both packages.  Tolerance 1e-5 abs: both compute in fp32 and differ
only in summation order (online vs plain softmax)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels.ragged_paged_attention import (
    _pallas_ragged_paged,
    _xla_ragged_paged,
    dense_decode_reference as jax_dense_reference,
    gather_kv_pages as jax_gather,
)
from flexflow_tpu_torch.interop import tensor_from_numpy
from flexflow_tpu_torch.kernels.ragged_paged_attention import (
    dense_decode_reference,
    gather_kv_pages,
    ragged_paged_attention,
)

B, H, D, PS, PPS = 4, 2, 8, 8, 4
P = B * PPS + 3  # pool larger than the allotment
SCALE = 1.0 / math.sqrt(D)
TOL = 1e-5

# lengths per sequence: single token, page-exact, page + 1, full
LENS = {
    "one": (1, 1, 1, 1),
    "page_exact": (8, 16, 24, 32),
    "page_plus_one": (9, 17, 25, 1),
    "full": (32, 32, 32, 32),
    "mixed": (1, 8, 9, 32),
}

_pallas = jax.jit(_pallas_ragged_paged, static_argnums=(5, 6))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from threads; one keeps this file from
    crowding the other test workers' CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(pool: str, lens, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(P, PS, H, D)).astype(np.float32)
    v = rng.normal(size=(P, PS, H, D)).astype(np.float32)
    if pool == "bf16":
        k = np.asarray(jnp.asarray(k, jnp.bfloat16))
        v = np.asarray(jnp.asarray(v, jnp.bfloat16))
    # shuffled page tables; rows past each sequence's last live page are
    # padded with a valid id (page 0), as the executor may leave them
    table = rng.permutation(P)[:B * PPS].reshape(B, PPS).astype(np.int32)
    for b, n in enumerate(lens):
        table[b, -(-n // PS):] = 0
    return q, k, v, table, np.asarray(lens, np.int32)


def _port(q, k, v, table, lens):
    return ragged_paged_attention(
        *(tensor_from_numpy(a) for a in (q, k, v, table, lens)), SCALE)


@pytest.mark.parametrize("case", sorted(LENS))
@pytest.mark.parametrize("pool", ["fp32", "bf16"])
def test_plain_version_matches_jax_kernel_and_oracle(pool, case):
    q, k, v, table, lens = _inputs(pool, LENS[case])
    got = _port(q, k, v, table, lens).numpy()
    args = [jnp.asarray(a) for a in (q, k, v, table, lens)]
    pallas = np.asarray(_pallas(*args, SCALE, True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
    oracle = np.asarray(jax_dense_reference(
        args[0], jax_gather(args[1], args[3]), jax_gather(args[2], args[3]),
        args[4], SCALE))
    np.testing.assert_allclose(got, oracle, rtol=0, atol=TOL)


@pytest.mark.parametrize("pool", ["fp32", "bf16"])
def test_zero_length_gives_zeros_like_the_jax_kernel(pool):
    """seq_lens == 0: the Pallas kernel (and the port) give zeros; the
    reference's XLA fallback gives the mean of V over the whole gathered
    row.  The decode op always passes lengths >= 1, so only direct
    callers see the reference's two paths diverge."""
    q, k, v, table, lens = _inputs(pool, (0, 5, 0, 17), seed=3)
    got = _port(q, k, v, table, lens).numpy()
    args = [jnp.asarray(a) for a in (q, k, v, table, lens)]
    pallas = np.asarray(_pallas(*args, SCALE, True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
    assert not got[[0, 2]].any()
    xla = np.asarray(_xla_ragged_paged(*args, SCALE))
    v_dense = np.asarray(jax_gather(args[2], args[3]), np.float32)
    np.testing.assert_allclose(xla[0], v_dense[0].mean(axis=0), atol=TOL)
    np.testing.assert_allclose(got[[1, 3]], xla[[1, 3]], rtol=0, atol=TOL)


def test_oracle_and_gather_match_the_reference():
    q, k, v, table, lens = _inputs("fp32", (0, 3, 12, 32), seed=5)
    kd = gather_kv_pages(tensor_from_numpy(k), tensor_from_numpy(table))
    vd = gather_kv_pages(tensor_from_numpy(v), tensor_from_numpy(table))
    jkd = jax_gather(jnp.asarray(k), jnp.asarray(table))
    np.testing.assert_array_equal(kd.numpy(), np.asarray(jkd))
    got = dense_decode_reference(tensor_from_numpy(q), kd, vd,
                                 tensor_from_numpy(lens), SCALE).numpy()
    ref = np.asarray(jax_dense_reference(
        jnp.asarray(q), jkd, jax_gather(jnp.asarray(v), jnp.asarray(table)),
        jnp.asarray(lens), SCALE))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def _bad(kind):
    q, k, v, table, lens = (tensor_from_numpy(a)
                            for a in _inputs("fp32", LENS["mixed"]))
    if kind == "q_float64":
        q = q.double()
    elif kind == "pools_mixed_dtype":
        v = v.bfloat16()
    elif kind == "pool_float16":
        k, v = k.half(), v.half()
    elif kind == "table_int64":
        table = table.long()
    elif kind == "lens_shape":
        lens = lens[:2]
    elif kind == "pool_head_dim":
        k, v = k[..., :4], v[..., :4]
    elif kind == "table_rows":
        table = table[:3]
    return q, k, v, table, lens


@pytest.mark.parametrize("kind", [
    "q_float64", "pools_mixed_dtype", "pool_float16", "table_int64",
    "lens_shape", "pool_head_dim", "table_rows"])
def test_wrapper_rejects_bad_operands(kind):
    with pytest.raises(ValueError):
        ragged_paged_attention(*_bad(kind))


def test_plain_version_is_what_cpu_tensors_take():
    q, k, v, table, lens = _inputs("fp32", LENS["mixed"])
    before = ragged_paged_attention.launches
    _port(q, k, v, table, lens)
    assert ragged_paged_attention.launches == before
    with pytest.raises(ValueError):  # one operand elsewhere: no guessing
        ragged_paged_attention(
            *(tensor_from_numpy(a) for a in (q, k, v, table)),
            torch.as_tensor(lens).to("meta"))


def test_kernel_library_is_keyed_by_its_source(tmp_path, monkeypatch):
    from flexflow_tpu_torch.kernels import build

    monkeypatch.setattr(build, "CSRC", tmp_path)
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build.library_path("k")
    assert first == build.library_path("k")
    src.write_text("// two\n")
    second = build.library_path("k")
    assert second != first
    assert {first.parent, second.parent} == {build.BUILD_DIR}
    assert first.name.startswith("libk-") and first.suffix == ".so"


def test_kernel_build_without_nvcc_says_so(tmp_path, monkeypatch):
    from flexflow_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["ragged_paged_attention"])
