"""Flash attention — the port of flexflow_tpu/kernels/flash_attention.py.

Four wrappers launch the hand-written CUDA kernels of
``csrc/flash_attention.cu`` for tensors on the card, each replacing one
Pallas TPU kernel:

* ``flash_forward``         — ``_flash_kernel`` with ``save_lse=True``
  (reference ``_flash_forward``): out and the per-row logsumexp;
* ``flash_backward_dq``     — ``_flash_bwd_dq_kernel`` (``_flash_backward``);
* ``flash_backward_dkv``    — ``_flash_bwd_dkv_kernel`` (``_flash_backward``);
* ``flash_forward_partial`` — ``_flash_kernel`` with ``partial_out=True``
  (``_flash_forward_partial``): the unnormalized (acc, m, l) that ring
  attention merges across ranks.

Each counts its launches in ``.launches``.  For tensors on the CPU each
computes its plain PyTorch version instead (``flash_forward_reference``,
``flash_backward_dq_reference``, ``flash_backward_dkv_reference``; the
last two together are ``flash_backward_reference``;
``flash_forward_partial_reference``); on a CUDA tensor it launches the
kernel or raises.  ``flash_attention`` is the ``torch.autograd.Function``
over the first three: the forward kernel saves (q, k, v, out, lse), the
backward forms ``delta = rowsum(dO * out)`` in fp32 as a torch op (the
reference also computes it outside Pallas) and runs the dq and dkv
kernels.  ``flash_attention_partial`` is the one over the partial
forward; its backward is the reference's (``_fap_bwd``): a recompute in
plain torch ops, chunked over at most 128 query rows
(``attention_partial_at`` keeps each chunk's causal diagonal global),
since the reference's is einsum and not Pallas.

In bf16 all four run on Hopper's tensor cores (``wgmma`` products from
TMA-fed shared-memory tiles): the forwards in ``flash_fwd_tc_kernel``,
the backward pair in ``flash_bwd_dq_tc_kernel`` (one block per 64 query
rows, K and V streamed) and ``flash_bwd_dkv_tc_kernel`` (one block per
64 keys, q, dO, lse and delta streamed, the score fragments transposed
so that p^T and ds^T feed the gradient products from registers).  At
the training shape (B 8, S 1024, H 12, D 64, causal) the pair does 19.4
and 25.8 GFLOP against about 64 and 76 MB of operands and gradients:
20 and 26 us of tensor-core time, 19 and 23 us of bytes.  Head dims
pad to 64 or 128 in shared memory; at 128 the dkv block runs two
warpgroups, each owning 64 columns of dk and dv, since one would need
128 registers for them alone.  No atomics: two calls give bit-equal
gradients.  fp32 runs the scalar kernels (no TF32, to keep fp32 parity
with the reference).

Layout: q, k, v, out [B, S, H, D] as the MHA op holds them; the kernels
read that layout through strides, so the reference's transposes to
[B*H, S, D] are gone.  lse and delta are [B, H, Sq] fp32 (the
reference's lse is [B*H, Sq, 1]; reshape to compare).

Causal masking is end-aligned (query i sees keys j <= i + Sk - Sq) and
fills the finite ``NEG_INF``.  Rows with no live key (causal, Sq > Sk)
follow the reference's XLA path (``_xla_attention``): uniform attention
over all Sk keys and zero q/k gradients; in the partials (the XLA twin
``_xla_attention_partial``) m = NEG_INF, l = Sk and acc = the sum of v.
(The Pallas kernel's value on such rows depends on its block size.)

Also here, as in the reference module, is the attention math the MHA op
takes below the flash threshold or with dropout in training:
``attn_logits_probs``, the compact-residual ``attn_core`` and
``attn_core_dropout`` (reference ``_attn_logits_probs``, ``_attn_core``,
``_attn_core_dropout`` and their custom VJPs; the reference computes
dropout attention in einsums outside any Pallas kernel, so the port's
uses ``torch.bmm`` with fp32 accumulation) and ``_pick_block``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

NEG_INF = -1e30

HEAD_DIMS = tuple(range(16, 129, 16))  # head dims the CUDA kernels take

_KERNEL_SOURCE = "flash_attention"


# ---------------------------------------------------------------------------
# plain versions
def _causal_mask(sq: int, sk: int, device, q0: int = 0,
                 sq_total: int | None = None) -> torch.Tensor:
    """[sq, sk] bool: query i sees key j iff j <= i + sk - sq; for the
    rows [q0, q0 + sq) of a ``sq_total``-row query, global row q0 + i
    sees key j iff j <= q0 + i + sk - sq_total."""
    tot = sq if sq_total is None else sq_total
    return torch.ones((sq, sk), dtype=torch.bool,
                      device=device).tril(q0 + sk - tot)


def _dead_rows(sq: int, sk: int, device, q0: int = 0,
               sq_total: int | None = None) -> torch.Tensor:
    """[sq] bool: rows with no live key under the causal mask (sq > sk),
    rows [q0, q0 + sq) of a ``sq_total``-row query."""
    tot = sq if sq_total is None else sq_total
    return torch.arange(q0, q0 + sq, device=device) < tot - sk


def _masked_logits(q, k, causal, scale):
    """fp32 logits [B, H, Sq, Sk], causal entries at NEG_INF, and rows
    with no live key at 0 (so their softmax is uniform over all keys)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        s = s.masked_fill(~_causal_mask(sq, sk, s.device), NEG_INF)
        s = s.masked_fill(_dead_rows(sq, sk, s.device)[:, None], 0.0)
    return s


def flash_forward_reference(q, k, v, causal: bool, scale: float):
    """The plain version of the forward kernel: (out [B, Sq, H, D] in
    q's dtype, lse [B, H, Sq] fp32).  p is rounded to v's dtype before
    p.v, as the TPU kernel does."""
    s = _masked_logits(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l.permute(0, 2, 1, 3)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _delta(out, dout) -> torch.Tensor:
    """rowsum(dO * out) in fp32, [B, H, Sq] (reference 309-311)."""
    return (dout.float() * out.float()).sum(dim=-1).permute(0, 2, 1)


def _probs_and_ds(q, k, v, dout, lse, delta, causal, scale):
    """fp32 (p, ds) [B, H, Sq, Sk] from the saved lse and delta; rows
    with no live key get zero ds."""
    s = _masked_logits(q, k, causal, scale)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    if causal:
        ds = ds.masked_fill(
            _dead_rows(q.shape[1], k.shape[1], ds.device)[:, None], 0.0)
    return p, ds


def flash_backward_dq_reference(q, k, v, dout, lse, delta, causal: bool,
                                scale: float):
    """The plain version of the dq kernel: ds rounded to k's dtype."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_backward_dkv_reference(q, k, v, dout, lse, delta, causal: bool,
                                 scale: float):
    """The plain version of the dkv kernel: ds rounded to q's dtype for
    dk, p to dO's dtype for dv."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_reference(q, k, v, out, lse, dout, causal: bool,
                             scale: float):
    """The plain version of the two backward kernels: (dq, dk, dv) from
    (q, k, v, out, lse, dO), delta formed as the autograd backward forms
    it."""
    dout = dout.to(q.dtype)
    delta = _delta(out, dout)
    dq = flash_backward_dq_reference(q, k, v, dout, lse, delta, causal,
                                     scale)
    return (dq, *flash_backward_dkv_reference(q, k, v, dout, lse, delta,
                                              causal, scale))


def attention_partial_at(q, k, v, causal: bool, scale: float,
                         row_offset: int, sq_total: int):
    """Unnormalized partials (acc [B, H, Sq, D], m and l [B, H, Sq, 1],
    fp32) of a query chunk whose first row is row ``row_offset`` of a
    ``sq_total``-row query sequence: the causal diagonal stays global
    (reference ``_xla_attention_partial_at``).  Differentiable; p is
    rounded to v's dtype before p.v, and the max is ``amax``, whose
    gradient splits among ties as JAX's max does."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sk = s.shape[-1]
        rows = row_offset + torch.arange(s.shape[-2], device=s.device)
        cols = torch.arange(sk, device=s.device)
        s = s.masked_fill(rows[:, None] + (sk - sq_total) < cols[None, :],
                          NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return acc, m, l


def flash_forward_partial_reference(q, k, v, causal: bool, scale: float):
    """The plain version of the partial forward kernel, the reference's
    XLA twin ``_xla_attention_partial``: (acc [B, H, Sq, D], m, l
    [B, H, Sq, 1]), fp32, unnormalized."""
    return attention_partial_at(q, k, v, causal, scale, 0, q.shape[1])


# ---------------------------------------------------------------------------
# the kernels
def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be [B, S, H, D] with k and v alike, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch, heads or head dim")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head dims that are "
                         f"multiples of 16 up to 128, got {d}")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("sequence lengths must be >= 1")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v must be on one device")


@functools.lru_cache(maxsize=None)
def _kernel_entry(name: str):
    """One C entry point of the built kernel library, typed once."""
    from flexflow_tpu_torch.kernels.build import load_library

    fn = getattr(load_library(_KERNEL_SOURCE), name)
    n_ptr = {"ffflash_fwd": 5, "ffflash_fwd_partial": 6,
             "ffflash_bwd_dq": 7, "ffflash_bwd_dkv": 8}[name]
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name, tensors, q, k, causal, scale):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernels take contiguous operands")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"operands on {q.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    b, sq, h, d = q.shape
    err = _kernel_entry(name)(
        *(t.data_ptr() for t in tensors), b, h, sq, k.shape[1], d,
        int(q.dtype == torch.bfloat16), int(causal), float(scale),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} CUDA launch failed: cudaError {err}")


def _device_type(q) -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no flash attention for device {q.device}")
    return q.device.type


def flash_forward(q, k, v, causal: bool, scale: float):
    """q [B, Sq, H, D], k/v [B, Sk, H, D], fp32 or bf16 -> (out like q,
    lse [B, H, Sq] fp32).  On the card: the forward kernel, launched on
    the current stream without synchronising, counted in
    ``flash_forward.launches``.  On the CPU: the plain version."""
    _check(q, k, v)
    if _device_type(q) == "cpu":
        return flash_forward_reference(q, k, v, causal, scale)
    out = torch.empty_like(q)
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]),
                      dtype=torch.float32, device=q.device)
    _launch("ffflash_fwd", (q, k, v, out, lse), q, k, causal, scale)
    flash_forward.launches += 1
    return out, lse


def _check_backward(q, dout, lse, delta):
    b, sq, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dO must match q ({tuple(q.shape)} {q.dtype}), "
                         f"got {tuple(dout.shape)} {dout.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be [{b}, {h}, {sq}] float32, got "
                             f"{tuple(t.shape)} {t.dtype}")


def flash_backward_dq(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """dq like q, from dO (q's dtype), lse and delta ([B, H, Sq] fp32).
    On the card: the dq kernel, counted in ``flash_backward_dq.launches``;
    on the CPU: the plain version."""
    _check(q, k, v)
    _check_backward(q, dout, lse, delta)
    if _device_type(q) == "cpu":
        return flash_backward_dq_reference(q, k, v, dout, lse, delta, causal,
                                           scale)
    dq = torch.empty_like(q)
    _launch("ffflash_bwd_dq", (q, k, v, dout, lse, delta, dq), q, k,
            causal, scale)
    flash_backward_dq.launches += 1
    return dq


def flash_backward_dkv(q, k, v, dout, lse, delta, causal: bool,
                       scale: float):
    """(dk like k, dv like v), operands as ``flash_backward_dq``.  On the
    card: the dkv kernel, counted in ``flash_backward_dkv.launches``; on
    the CPU: the plain version."""
    _check(q, k, v)
    _check_backward(q, dout, lse, delta)
    if _device_type(q) == "cpu":
        return flash_backward_dkv_reference(q, k, v, dout, lse, delta,
                                            causal, scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("ffflash_bwd_dkv", (q, k, v, dout, lse, delta, dk, dv), q, k,
            causal, scale)
    flash_backward_dkv.launches += 1
    return dk, dv


def flash_forward_partial(q, k, v, causal: bool, scale: float):
    """q [B, Sq, H, D], k/v [B, Sk, H, D], fp32 or bf16 -> (acc
    [B, H, Sq, D], m, l [B, H, Sq, 1]), fp32 and unnormalized.  On the
    card: the partial forward kernel, counted in
    ``flash_forward_partial.launches``.  On the CPU: the plain version."""
    _check(q, k, v)
    if _device_type(q) == "cpu":
        return flash_forward_partial_reference(q, k, v, causal, scale)
    b, sq, h, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((b, h, sq, d), **f32)
    m = torch.empty((b, h, sq, 1), **f32)
    l = torch.empty((b, h, sq, 1), **f32)
    _launch("ffflash_fwd_partial", (q, k, v, acc, m, l), q, k, causal, scale)
    flash_forward_partial.launches += 1
    return acc, m, l


flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0
flash_forward_partial.launches = 0


class FlashAttention(torch.autograd.Function):
    """Forward: the forward kernel, saving (q, k, v, out, lse).
    Backward: delta in fp32, then the dq and dkv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dout = g.to(q.dtype).contiguous()
        delta = _delta(out, dout).contiguous()
        dq = flash_backward_dq(q, k, v, dout, lse, delta, ctx.causal,
                               ctx.scale)
        dk, dv = flash_backward_dkv(q, k, v, dout, lse, delta, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale: float | None = None):
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D], differentiable
    in q, k and v through the flash kernels."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, bool(causal), float(scale))


# the reference's recompute backward chunks at most this many query rows
# (``_fap_bwd``: min(block_q, 128) with the default block_q of 512)
PARTIAL_BWD_ROWS = 128


def _partial_backward(q, k, v, dacc, dm, dl, causal, scale):
    """(dq, dk, dv) of the partials by recompute (reference ``_fap_bwd``):
    chunks of ``_pick_block(Sq, 128)`` query rows with dk and dv summed
    in fp32 across them, or one whole-matrix recompute when the chunks do
    not divide Sq or cover it."""
    sq = q.shape[1]
    bq = _pick_block(sq, PARTIAL_BWD_ROWS) or sq
    bounds = ([(0, sq)] if sq % bq or sq == bq
              else [(i, i + bq) for i in range(0, sq, bq)])
    dq, dk, dv = [], 0.0, 0.0
    with torch.enable_grad():
        kd = k.detach().requires_grad_(True)
        vd = v.detach().requires_grad_(True)
        for lo, hi in bounds:
            qc = q[:, lo:hi].detach().requires_grad_(True)
            out = attention_partial_at(qc, kd, vd, causal, scale, lo, sq)
            dqc, dkc, dvc = torch.autograd.grad(
                out, (qc, kd, vd), (dacc[:, :, lo:hi], dm[:, :, lo:hi],
                                    dl[:, :, lo:hi]))
            dq.append(dqc)
            dk = dk + dkc.float()
            dv = dv + dvc.float()
    return torch.cat(dq, dim=1), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionPartial(torch.autograd.Function):
    """Forward: the partial forward kernel, saving (q, k, v).  Backward:
    the reference's chunked recompute in plain torch ops."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        acc, m, l = flash_forward_partial(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return acc, m, l

    @staticmethod
    def backward(ctx, dacc, dm, dl):
        q, k, v = ctx.saved_tensors
        return (*_partial_backward(q, k, v, dacc, dm, dl, ctx.causal,
                                   ctx.scale), None, None)


def flash_attention_partial(q, k, v, causal: bool = False,
                            scale: float | None = None):
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> (acc [B, H, Sq, D], m, l
    [B, H, Sq, 1]), fp32 and unnormalized (out = acc / l after merging),
    differentiable in q, k and v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionPartial.apply(q, k, v, bool(causal), float(scale))


# ---------------------------------------------------------------------------
# the reference's XLA attention path, below the flash threshold
def attn_logits_probs(q, k, causal: bool, scale: float, q0: int = 0,
                      sq_total: int | None = None) -> torch.Tensor:
    """fp32 softmax probabilities [B, H, Sq, Sk]: logits from the inputs'
    dtype with fp32 accumulation, scaled, causal entries at NEG_INF
    (a row with no live key comes out uniform), softmax over keys.  q
    may be the rows [q0, q0 + Sq) of a ``sq_total``-row query (the
    causal diagonal stays global)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = logits.shape[-2:]
        logits = logits.masked_fill(
            ~_causal_mask(sq, sk, logits.device, q0, sq_total), NEG_INF)
    return torch.softmax(logits, dim=-1)


class AttnCore(torch.autograd.Function):
    """Dropout-free attention with the reference's compact residuals
    (``_attn_core``): saves (q, k, v, probs in q's dtype) instead of the
    fp32 logits and probs, and in the backward zeroes the logit
    gradients of rows with no live key (``_softmax_qk_grads``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, q0: int = 0,
                sq_total=None):
        probs = attn_logits_probs(q, k, causal, scale, q0,
                                  sq_total).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        ctx.save_for_backward(q, k, v, probs)
        ctx.causal, ctx.scale, ctx.rows = causal, scale, (q0, sq_total)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, p = ctx.saved_tensors
        pf = p.float()
        gv = torch.einsum("bhqk,bqhd->bkhd", pf, g.to(p.dtype).float())
        gp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
        gs = pf * (gp - (pf * gp).sum(dim=-1, keepdim=True)) * ctx.scale
        if ctx.causal:
            gs = gs.masked_fill(
                _dead_rows(q.shape[1], k.shape[1], gs.device,
                           *ctx.rows)[:, None], 0.0)
        gs = gs.to(q.dtype).float()
        gq = torch.einsum("bhqk,bkhd->bqhd", gs, k.float())
        gk = torch.einsum("bhqk,bqhd->bkhd", gs, q.float())
        return (gq.to(q.dtype), gk.to(k.dtype), gv.to(v.dtype), None, None,
                None, None)


def attn_core(q, k, v, causal: bool, scale: float, q0: int = 0,
              sq_total: int | None = None):
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D] in q's dtype;
    q may be rows [q0, q0 + Sq) of a ``sq_total``-row query."""
    return AttnCore.apply(q, k, v, bool(causal), float(scale), int(q0),
                          sq_total)


def _bmm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, M, K] @ b [N, K, P] -> float32, products of the operands'
    dtype accumulated in fp32 (the reference's
    ``preferred_element_type=jnp.float32``; bf16 on the card's tensor
    cores through ``out_dtype``)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> [B*H, S, D]."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _heads_back(y: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[B*H, S, D] -> [B, S, H, D]."""
    return y.view(b, h, *y.shape[1:]).permute(0, 2, 1, 3)


class AttnCoreDropout(torch.autograd.Function):
    """Attention with post-softmax dropout and the reference's compact
    residuals (``_attn_core_dropout``, flash_attention.py:429-464):
    saves q, k, v, the probabilities rounded to q's dtype BEFORE the
    keep-scaling, and the bool mask.  Every product multiplies operands
    of q's dtype and accumulates in fp32 (``_bmm32``); the logits come
    from ``attn_logits_probs``.  The backward is the reference's: the
    where-VJP of the dropout, then the softmax VJP from the saved
    probabilities, zero logit gradients on rows with no live key."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal: bool, scale: float,
                keep: float, q0: int = 0, sq_total=None):
        b, sq, h, _ = q.shape
        probs = attn_logits_probs(q, k, causal, scale, q0,
                                  sq_total).to(q.dtype)
        dropped = torch.where(mask, probs.float() / keep, 0.0).to(q.dtype)
        out = _bmm32(dropped.view(b * h, sq, -1), _heads_first(v))
        ctx.save_for_backward(q, k, v, probs, mask)
        ctx.causal, ctx.scale, ctx.keep = causal, scale, keep
        ctx.rows = (q0, sq_total)
        return _heads_back(out, b, h).to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, p, mask = ctx.saved_tensors
        b, sq, h, _ = q.shape
        sk = k.shape[1]
        pf = p.float()
        dropped = torch.where(mask, pf / ctx.keep, 0.0).to(q.dtype)
        gh = _heads_first(g.to(q.dtype))
        gv = _bmm32(dropped.view(b * h, sq, sk).transpose(1, 2), gh)
        g_dropped = _bmm32(gh, _heads_first(v).transpose(1, 2)).view(
            b, h, sq, sk)
        gp = torch.where(mask, g_dropped / ctx.keep, 0.0)
        gs = pf * (gp - (pf * gp).sum(dim=-1, keepdim=True)) * ctx.scale
        if ctx.causal:
            gs = gs.masked_fill(
                _dead_rows(sq, sk, gs.device, *ctx.rows)[:, None], 0.0)
        gs = gs.to(q.dtype).view(b * h, sq, sk)
        gq = _bmm32(gs, _heads_first(k))
        gk = _bmm32(gs.transpose(1, 2), _heads_first(q))
        return (_heads_back(gq, b, h).to(q.dtype),
                _heads_back(gk, b, h).to(k.dtype),
                _heads_back(gv, b, h).to(v.dtype), None, None, None, None,
                None, None)


def attn_core_dropout(q, k, v, mask, causal: bool, scale: float,
                      keep: float, q0: int = 0, sq_total: int | None = None):
    """q [B, Sq, H, D], k/v [B, Sk, H, D], mask bool [B, H, Sq, Sk] ->
    [B, Sq, H, D] in q's dtype: softmax(q k^T * scale) with the kept
    probabilities divided by ``keep`` and the rest zeroed, times v; q
    may be rows [q0, q0 + Sq) of a ``sq_total``-row query."""
    return AttnCoreDropout.apply(q, k, v, mask, bool(causal), float(scale),
                                 float(keep), int(q0), sq_total)


def _pick_block(size: int, want: int):
    """Largest power-of-two block <= want that divides size (None if
    size has no power-of-two divisor >= 8 small enough to tile)."""
    b = 1 << (want.bit_length() - 1)
    while b >= 8:
        if b <= size and size % b == 0:
            return b
        b //= 2
    return None
