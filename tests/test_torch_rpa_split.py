"""The split-KV algebra of the card's decode-attention kernels
(``csrc/ragged_paged_attention.cu``), rendered in plain PyTorch here (it
is not on the port's path) and held against the port's plain versions
and the JAX package's Pallas kernels in interpret mode.

The rendering follows the kernel's order of work: a sequence's tokens
are cut into splits of ``SPLIT`` tokens; inside a split, ``GROUPS`` row
groups take rows g, g + GROUPS, ... one per tile, each with its own
running (m, l, acc) rescaled once per row it takes; the groups merge in
group order, and the splits' partials in split order, each merge
weighting a partial by exp(m_part - max m).  Lengths sit at the split
edges (0, 1, split - 1, split, split + 1, the same around two splits,
the cap - 1 and the cap), with a page size that does not divide the
split.  Tolerance 1e-5 abs: fp32 math on every side, summation orders
differ.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import ragged_paged_attention as jrpa
from flexflow_tpu.ops.decode_attention import _quantize_kv as jax_quantize
from flexflow_tpu_torch.interop import tensor_from_numpy
from flexflow_tpu_torch.kernels.ragged_paged_attention import (
    NEG_INF,
    ragged_paged_attention_quant_reference,
    ragged_paged_attention_reference,
)

H, D, PS, PPS = 2, 8, 3, 8
CAP = PS * PPS  # 24
SPLIT, GROUPS = 8, 4
LENS = (0, 1, SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT - 1, 2 * SPLIT,
        2 * SPLIT + 1, CAP - 1, CAP)
B = len(LENS)
P = B * PPS + 2
TOL = 1e-5

_pallas = jax.jit(jrpa._pallas_ragged_paged, static_argnums=(5, 6))
_pallas_quant = jax.jit(jrpa._pallas_ragged_paged_quant,
                        static_argnums=(7, 8))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def merge(parts):
    """Merge (m, l, acc) partials in their order: weights exp(m - max m);
    an all-empty merge (every m at NEG_INF, l 0) gives (NEG_INF, 0, 0)."""
    m_all = max(m for m, _, _ in parts)
    l_all = torch.zeros(())
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.exp(torch.tensor(m - m_all, dtype=torch.float32))
        l_all = l_all + l * w
        acc = acc + a * w
    return m_all, l_all, acc


def split_partial(q, k_rows, v_rows, scale, k_scales=None, v_scales=None):
    """One split's (m, l, acc): GROUPS groups with running softmaxes, one
    row each per tile, merged in group order."""
    groups = []
    for g in range(GROUPS):
        m, l, acc = NEG_INF, torch.zeros(()), torch.zeros(D)
        for r in range(g, len(k_rows), GROUPS):
            s = float(q @ k_rows[r]) * scale
            pv = 1.0
            if k_scales is not None:
                s *= float(k_scales[r])
                pv = float(v_scales[r])
            m_new = max(m, s)
            alpha = math.exp(m - m_new)
            p = math.exp(s - m_new)
            l = l * alpha + p
            acc = acc * alpha + (p * pv) * v_rows[r]
            m = m_new
        groups.append((m, l, acc))
    return merge(groups)


def split_attention(q, k_pages, v_pages, table, lens, scale, k_scale=None,
                    v_scale=None):
    """The rendering: q [B, H, D] -> [B, H, D], fp32 pools (int8 pools
    with their [P, page_size] scales, the scale kept out of the dot)."""
    out = torch.zeros_like(q)
    for b in range(q.shape[0]):
        n = min(max(int(lens[b]), 0), CAP)
        rows = [int(table[b, t // PS]) * PS + t % PS for t in range(n)]
        flat = lambda pool: pool.reshape(-1, H, D)[rows].float()
        k, v = flat(k_pages), flat(v_pages)
        ks = vs = None
        if k_scale is not None:
            ks, vs = k_scale.reshape(-1)[rows], v_scale.reshape(-1)[rows]
        for h in range(H):
            parts = []
            for start in range(0, max(n, 1), SPLIT):
                sl = slice(start, min(n, start + SPLIT))
                parts.append(split_partial(
                    q[b, h], k[sl, h], v[sl, h], scale,
                    None if ks is None else ks[sl],
                    None if vs is None else vs[sl]))
            _, l, acc = merge(parts)
            out[b, h] = acc / torch.clamp(l, min=1e-30)
    return out


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(P, PS, H, D)).astype(np.float32)
    v = rng.normal(size=(P, PS, H, D)).astype(np.float32)
    table = rng.permutation(P)[:B * PPS].reshape(B, PPS).astype(np.int32)
    return q, k, v, table, np.asarray(LENS, np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_merge_matches_plain_and_jax_kernel(seed):
    q, k, v, table, lens = _inputs(seed)
    scale = 1.0 / math.sqrt(D)
    t = [tensor_from_numpy(a) for a in (q, k, v, table, lens)]
    got = split_attention(*t, scale)
    assert not got[0].any()  # length 0: zeros, not NaN
    plain = ragged_paged_attention_reference(*t, scale)
    torch.testing.assert_close(got, plain, rtol=0, atol=TOL)
    pallas = np.asarray(_pallas(*(jnp.asarray(a) for a in
                                  (q, k, v, table, lens)), scale, True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_merge_int8_matches_plain_and_jax_kernel(seed):
    q, k, v, table, lens = _inputs(seed)
    kq, ks = (np.asarray(a) for a in jax_quantize(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jax_quantize(jnp.asarray(v)))
    scale = 1.0 / math.sqrt(D)
    t = [tensor_from_numpy(a) for a in (q, kq, vq, ks, vs, table, lens)]
    got = split_attention(t[0], t[1], t[2], t[5], t[6], scale, t[3], t[4])
    assert not got[0].any()
    plain = ragged_paged_attention_quant_reference(*t, scale)
    torch.testing.assert_close(got, plain, rtol=0, atol=TOL)
    pallas = np.asarray(_pallas_quant(
        *(jnp.asarray(a) for a in (q, kq, vq, ks, vs, table, lens)), scale,
        True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0, atol=TOL)


def test_all_empty_merge_gives_zeros():
    empty = (NEG_INF, torch.zeros(()), torch.zeros(D))
    m, l, acc = merge([empty] * 3)
    out = acc / torch.clamp(l, min=1e-30)
    assert m == NEG_INF and bool(torch.isfinite(out).all())
    assert not out.any()


def test_a_split_still_at_neg_inf_adds_nothing():
    """A partial whose m is still NEG_INF (a group or split that saw no
    row) gets weight exp(NEG_INF - m) = 0: the merge is bit-equal to the
    merge without it, wherever it stands."""
    gen = torch.Generator().manual_seed(3)
    live = [(float(m), torch.rand((), generator=gen) + 0.5,
             torch.randn(D, generator=gen)) for m in (0.3, -1.2, 2.0)]
    empty = (NEG_INF, torch.zeros(()), torch.zeros(D))
    want = merge(live)
    for at in range(len(live) + 1):
        got = merge(live[:at] + [empty] + live[at:])
        assert got[0] == want[0]
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])

