"""Ragged paged decode attention — the port of
flexflow_tpu/kernels/ragged_paged_attention.py.

One decode step attends a single fresh query per sequence against that
sequence's KV cache, which lives in a PAGED pool shared by every
sequence:

* ``k_pages``/``v_pages`` — [num_pages, page_size, H, D], fp32 or bf16;
* ``page_table`` — [B, pages_per_seq] int32 pool page ids (rows padded
  with any valid id past the sequence's last live page);
* ``seq_lens`` — [B] int32 live token counts.

``ragged_paged_attention`` launches the hand-written CUDA kernel
``csrc/ragged_paged_attention.cu`` (which replaces the Pallas
``_rpa_kernel``) for tensors on the card, and uses the plain PyTorch
version ``ragged_paged_attention_reference`` for tensors on the CPU.
On a CUDA tensor it launches the kernel or raises; nothing falls back.
Both follow the TPU kernel's semantics, including zeros for a sequence
of length 0 (the reference's XLA fallback gives the mean of V there;
the decode op always passes lengths >= 1).

``dense_decode_reference`` and ``gather_kv_pages`` are copies of the
reference's oracle and gather.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

NEG_INF = -1e30

_KERNEL_SOURCE = "ragged_paged_attention"


def dense_decode_reference(q, k_dense, v_dense, seq_lens, scale=None):
    """Single-token decode attention against dense per-sequence KV:
    q [B, H, D], k_dense/v_dense [B, S, H, D], seq_lens [B] -> [B, H, D].
    Positions >= seq_lens[b] are masked at NEG_INF; plain softmax in
    fp32 (a row with no live position gets the mean of V, as the
    reference's oracle does)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhd,bshd->bhs", q.float(), k_dense.float()) * scale
    pos = torch.arange(k_dense.shape[1], device=q.device)
    mask = pos[None, None, :] < seq_lens.to(q.device)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, v_dense.float())
    return out.to(q.dtype)


def gather_kv_pages(pages, page_table):
    """[P, page_size, H, D] pool + [B, pages_per_seq] table -> dense
    [B, pages_per_seq * page_size, H, D] per-sequence KV."""
    g = pages[page_table.long()]  # [B, pages_per_seq, page_size, H, D]
    b, npp, ps, h, d = g.shape
    return g.reshape(b, npp * ps, h, d)


def ragged_paged_attention_reference(q, k_pages, v_pages, page_table,
                                     seq_lens, scale=None):
    """The plain PyTorch version of the kernel: gather the pages, mask
    past ``seq_lens`` at NEG_INF, softmax in fp32 with the TPU kernel's
    l floor of 1e-30 (so a sequence of length 0 gives zeros)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    k = gather_kv_pages(k_pages, page_table).float()
    v = gather_kv_pages(v_pages, page_table).float()
    s = torch.einsum("bhd,bshd->bhs", q.float(), k) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    mask = pos[None, None, :] < seq_lens.to(q.device)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhs,bshd->bhd", p, v) / l
    return out.to(q.dtype)


def _check(q, k_pages, v_pages, page_table, seq_lens):
    if q.dtype != torch.float32 or q.dim() != 3:
        raise ValueError(f"q must be [B, H, D] float32, got "
                         f"{tuple(q.shape)} {q.dtype}")
    b, h, d = q.shape
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"k/v pools must both be float32 or both "
                         f"bfloat16, got {k_pages.dtype}/{v_pages.dtype}")
    if (k_pages.dim() != 4 or k_pages.shape != v_pages.shape
            or tuple(k_pages.shape[2:]) != (h, d)):
        raise ValueError(f"k/v pools must be [P, page_size, {h}, {d}], got "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if (page_table.dtype != torch.int32 or page_table.dim() != 2
            or page_table.shape[0] != b):
        raise ValueError(f"page_table must be [{b}, pages_per_seq] int32, "
                         f"got {tuple(page_table.shape)} {page_table.dtype}")
    if seq_lens.dtype != torch.int32 or tuple(seq_lens.shape) != (b,):
        raise ValueError(f"seq_lens must be [{b}] int32, got "
                         f"{tuple(seq_lens.shape)} {seq_lens.dtype}")
    devices = {t.device for t in (q, k_pages, v_pages, page_table,
                                  seq_lens)}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got "
                         f"{sorted(map(str, devices))}")


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    """The C entry point of the built kernel library, typed once."""
    from flexflow_tpu_torch.kernels.build import load_library

    fn = load_library(_KERNEL_SOURCE).ffrpa_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_pages, v_pages, page_table, seq_lens, scale):
    b, h, d = q.shape
    if d % 32 or not 32 <= d <= 256:
        raise ValueError(f"the CUDA kernel takes head dims that are "
                         f"multiples of 32 up to 256, got {d}")
    tensors = (q, k_pages, v_pages, page_table, seq_lens)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous operands")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"operands on {q.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")
    out = torch.empty_like(q)
    err = _kernel_entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        b, h, d, k_pages.shape[0], k_pages.shape[1], page_table.shape[1],
        int(k_pages.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention CUDA launch failed: "
                           f"cudaError {err}")
    ragged_paged_attention.launches += 1
    return out


def ragged_paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                           scale=None):
    """Paged-KV decode attention: q [B, H, D] fp32 (one fresh token per
    sequence), k_pages/v_pages [P, page_size, H, D] fp32 or bf16,
    page_table [B, pages_per_seq] int32, seq_lens [B] int32 ->
    [B, H, D] fp32.

    On the card this launches the CUDA kernel on the current stream,
    without synchronising, and adds one to
    ``ragged_paged_attention.launches``; it raises on anything the
    kernel does not take.  On the CPU it computes the plain version.
    Page ids must lie in [0, P)."""
    _check(q, k_pages, v_pages, page_table, seq_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch(q, k_pages, v_pages, page_table, seq_lens, scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, k_pages, v_pages, page_table, seq_lens, scale)
    raise ValueError(f"no ragged_paged_attention for device {q.device}")


ragged_paged_attention.launches = 0
