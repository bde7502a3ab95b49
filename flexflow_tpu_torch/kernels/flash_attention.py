"""Flash attention — the port of flexflow_tpu/kernels/flash_attention.py.

Three wrappers launch the hand-written CUDA kernels of
``csrc/flash_attention.cu`` for tensors on the card, each replacing one
Pallas TPU kernel:

* ``flash_forward``      — ``_flash_kernel`` with ``save_lse=True``
  (reference ``_flash_forward``): out and the per-row logsumexp;
* ``flash_backward_dq``  — ``_flash_bwd_dq_kernel`` (``_flash_backward``);
* ``flash_backward_dkv`` — ``_flash_bwd_dkv_kernel`` (``_flash_backward``).

Each counts its launches in ``.launches``.  For tensors on the CPU each
computes its plain PyTorch version instead (``flash_forward_reference``,
``flash_backward_dq_reference``, ``flash_backward_dkv_reference``; the
last two together are ``flash_backward_reference``); on a CUDA tensor
it launches the kernel or raises.  ``flash_attention`` is the
``torch.autograd.Function`` over them: the forward kernel saves
(q, k, v, out, lse), the backward forms
``delta = rowsum(dO * out)`` in fp32 as a torch op (the reference also
computes it outside Pallas) and runs the dq and dkv kernels.

Layout: q, k, v, out [B, S, H, D] as the MHA op holds them; the kernels
read that layout through strides, so the reference's transposes to
[B*H, S, D] are gone.  lse and delta are [B, H, Sq] fp32 (the
reference's lse is [B*H, Sq, 1]; reshape to compare).

Causal masking is end-aligned (query i sees keys j <= i + Sk - Sq) and
fills the finite ``NEG_INF``.  Rows with no live key (causal, Sq > Sk)
follow the reference's XLA path (``_xla_attention``): uniform attention
over all Sk keys and zero q/k gradients.  (The Pallas kernel's value on
such rows depends on its block size.)

Also here, as in the reference module, is the attention math the MHA op
takes below the flash threshold: ``attn_logits_probs`` and the
compact-residual ``attn_core`` (reference ``_attn_logits_probs``,
``_attn_core`` and its custom VJP), and ``_pick_block``.
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
def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """[sq, sk] bool: query i sees key j iff j <= i + sk - sq."""
    return torch.ones((sq, sk), dtype=torch.bool, device=device).tril(sk - sq)


def _dead_rows(sq: int, sk: int, device) -> torch.Tensor:
    """[sq] bool: rows with no live key under the causal mask (sq > sk)."""
    return torch.arange(sq, device=device) < sq - sk


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
    n_ptr = {"ffflash_fwd": 5, "ffflash_bwd_dq": 7,
             "ffflash_bwd_dkv": 8}[name]
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


flash_forward.launches = 0
flash_backward_dq.launches = 0
flash_backward_dkv.launches = 0


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


# ---------------------------------------------------------------------------
# the reference's XLA attention path, below the flash threshold
def attn_logits_probs(q, k, causal: bool, scale: float) -> torch.Tensor:
    """fp32 softmax probabilities [B, H, Sq, Sk]: logits from the inputs'
    dtype with fp32 accumulation, scaled, causal entries at NEG_INF
    (a row with no live key comes out uniform), softmax over keys."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = logits.shape[-2:]
        logits = logits.masked_fill(~_causal_mask(sq, sk, logits.device),
                                    NEG_INF)
    return torch.softmax(logits, dim=-1)


class AttnCore(torch.autograd.Function):
    """Dropout-free attention with the reference's compact residuals
    (``_attn_core``): saves (q, k, v, probs in q's dtype) instead of the
    fp32 logits and probs, and in the backward zeroes the logit
    gradients of rows with no live key (``_softmax_qk_grads``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        probs = attn_logits_probs(q, k, causal, scale).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        ctx.save_for_backward(q, k, v, probs)
        ctx.causal, ctx.scale = causal, scale
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
                _dead_rows(q.shape[1], k.shape[1], gs.device)[:, None],
                0.0)
        gs = gs.to(q.dtype).float()
        gq = torch.einsum("bhqk,bkhd->bqhd", gs, k.float())
        gk = torch.einsum("bhqk,bqhd->bkhd", gs, q.float())
        return gq.to(q.dtype), gk.to(k.dtype), gv.to(v.dtype), None, None


def attn_core(q, k, v, causal: bool, scale: float):
    """q [B, Sq, H, D], k/v [B, Sk, H, D] -> [B, Sq, H, D] in q's dtype."""
    return AttnCore.apply(q, k, v, bool(causal), float(scale))


def _pick_block(size: int, want: int):
    """Largest power-of-two block <= want that divides size (None if
    size has no power-of-two divisor >= 8 small enough to tile)."""
    b = 1 << (want.bit_length() - 1)
    while b >= 8:
        if b <= size and size % b == 0:
            return b
        b //= 2
    return None
