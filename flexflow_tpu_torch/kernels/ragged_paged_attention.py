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
the decode op always passes lengths >= 1).  The kernel cuts each
sequence into fixed runs of tokens (split-KV): the wrapper gives it a
workspace for the splits' partials (``torch.empty`` per call) and
per-(b, h) arrival counters, kept zeroed per device and stream
(``_counters``), by which the last split of each (b, h) to finish
merges the partials in split order.

An INT8 pool carries one fp32 scale per (page, slot), shared across
heads, for k and for v (``k_scale``/``v_scale`` [num_pages,
page_size]).  ``ragged_paged_attention_quant`` launches the CUDA kernel
that replaces ``_rpa_kernel_quant`` (dequantising in registers, so
only int8 bytes and the scales leave device memory), with its own
``.launches`` count, and ``ragged_paged_attention_quant_reference`` is
its plain version: gather, dequantise, the same plain softmax.

``dense_decode_reference``, ``gather_kv_pages`` and
``gather_kv_pages_quant`` are copies of the reference's oracle and
gathers.
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


def gather_kv_pages_quant(pages, scales, page_table):
    """Densify and dequantise an int8 pool: pages [P, page_size, H, D]
    int8, scales [P, page_size] fp32 -> dense fp32
    [B, pages_per_seq * page_size, H, D]."""
    dense = gather_kv_pages(pages, page_table).float()
    s = scales[page_table.long()]  # [B, pages_per_seq, page_size]
    b, npp, ps = s.shape
    return dense * s.reshape(b, npp * ps)[:, :, None, None]


def _attend_dense(q, k, v, seq_lens, scale):
    """Mask past ``seq_lens`` at NEG_INF, softmax in fp32 with the TPU
    kernel's l floor of 1e-30 (so a sequence of length 0 gives zeros):
    q [B, H, D], dense fp32 k/v [B, S, H, D] -> [B, H, D]."""
    s = torch.einsum("bhd,bshd->bhs", q.float(), k) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    mask = pos[None, None, :] < seq_lens.to(q.device)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhs,bshd->bhd", p, v) / l
    return out.to(q.dtype)


def ragged_paged_attention_reference(q, k_pages, v_pages, page_table,
                                     seq_lens, scale=None):
    """The plain PyTorch version of the kernel: gather the pages, then
    the masked fp32 softmax of ``_attend_dense``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _attend_dense(q, gather_kv_pages(k_pages, page_table).float(),
                         gather_kv_pages(v_pages, page_table).float(),
                         seq_lens, scale)


def ragged_paged_attention_quant_reference(q, k_pages, v_pages, k_scale,
                                           v_scale, page_table, seq_lens,
                                           scale=None):
    """The plain PyTorch version of the int8 kernel: gather and
    dequantise the pages, then the masked fp32 softmax of
    ``_attend_dense``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _attend_dense(
        q, gather_kv_pages_quant(k_pages, k_scale, page_table),
        gather_kv_pages_quant(v_pages, v_scale, page_table), seq_lens,
        scale)


def _check(q, k_pages, v_pages, page_table, seq_lens,
           pool_dtypes=(torch.float32, torch.bfloat16), scales=()):
    if q.dtype != torch.float32 or q.dim() != 3:
        raise ValueError(f"q must be [B, H, D] float32, got "
                         f"{tuple(q.shape)} {q.dtype}")
    b, h, d = q.shape
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in pool_dtypes:
        raise ValueError(f"k/v pools must both be one of {pool_dtypes}, "
                         f"got {k_pages.dtype}/{v_pages.dtype}")
    for sc in scales:
        if sc.dtype != torch.float32 or tuple(sc.shape) != tuple(
                k_pages.shape[:2]):
            raise ValueError(f"k/v scales must be [P, page_size] = "
                             f"{tuple(k_pages.shape[:2])} float32, got "
                             f"{tuple(sc.shape)} {sc.dtype}")
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
                                  seq_lens, *scales)}
    if len(devices) != 1:
        raise ValueError(f"all operands must be on one device, got "
                         f"{sorted(map(str, devices))}")


# ctypes types of the library's C entries: (argtypes, restype)
_ENTRY_TYPES = {
    # q, k, v, page_table, seq_lens, out, workspace, counters; B, H, D,
    # num_pages, page_size, pages_per_seq, kv_is_bf16; scale; stream
    "ffrpa_launch": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_void_p]),
    # q, k, v, k_scale, v_scale, page_table, seq_lens, out, workspace,
    # counters; B, H, D, num_pages, page_size, pages_per_seq; scale;
    # stream
    "ffrpa_quant_launch": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                           + [ctypes.c_float, ctypes.c_void_p]),
    "ffrpa_split_tokens": [],
    # pool (0 fp32, 1 bf16, 2 int8), D, int* blocks
    "ffrpa_blocks_per_sm": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


@functools.lru_cache(maxsize=None)
def _kernel_entry(symbol: str = "ffrpa_launch"):
    """A C entry point of the built kernel library, typed once:
    ``ffrpa_launch`` (fp32/bf16 pools), ``ffrpa_quant_launch`` (int8
    pools), ``ffrpa_split_tokens`` (tokens per split) or
    ``ffrpa_blocks_per_sm``."""
    from flexflow_tpu_torch.kernels.build import load_library

    fn = getattr(load_library(_KERNEL_SOURCE), symbol)
    fn.argtypes = _ENTRY_TYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def split_tokens() -> int:
    """Tokens per split of the built kernels (a constant of the source)."""
    return _kernel_entry("ffrpa_split_tokens")()


def blocks_per_sm(pool: str, head_dim: int) -> int:
    """Resident blocks per SM of the card's decode kernel for ``pool``
    ("fp32", "bf16" or "int8") at ``head_dim``, as the CUDA occupancy
    calculator gives it."""
    blocks = ctypes.c_int(0)
    err = _kernel_entry("ffrpa_blocks_per_sm")(
        ("fp32", "bf16", "int8").index(pool), head_dim,
        ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"ffrpa_blocks_per_sm failed: cudaError {err}")
    return blocks.value


# (device index, stream) -> int32 per-(b, h) arrival counters, all zero
# between calls: the kernel's last split of each (b, h) resets its own,
# so a captured launch (compiler/graphs.py) leaves them zero for the
# next replay.  A grown buffer keeps the smaller one alive, since a
# captured graph may hold its address.
_COUNTERS = {}
_OUTGROWN = []


def _counters(q, n: int):
    """At least ``n`` zeroed int32 counters for calls on q's device and
    the current stream (launches on one stream are ordered, so calls
    there share them)."""
    key = (q.device.index, torch.cuda.current_stream().cuda_stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(n, dtype=torch.int32, device=q.device)
        _COUNTERS[key] = buf
    return buf


def _workspace(q, page_size, pages_per_seq):
    """The splits' partials (m, l, acc) in fp32, any contents, and the
    arrival counters."""
    b, h, d = q.shape
    splits = -(-page_size * pages_per_seq // split_tokens())
    ws = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                     device=q.device)
    return ws, _counters(q, b * h)


def _launch_checks(q, k_pages, v_pages, *tensors):
    d = q.shape[-1]
    if d % 32 or not 32 <= d <= 256:
        raise ValueError(f"the CUDA kernel takes head dims that are "
                         f"multiples of 32 up to 256, got {d}")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, *tensors)):
        raise ValueError("the CUDA kernel takes contiguous operands")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes pools aligned to 16 bytes")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"operands on {q.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}")


def _launch(q, k_pages, v_pages, page_table, seq_lens, scale):
    b, h, d = q.shape
    _launch_checks(q, k_pages, v_pages, page_table, seq_lens)
    out = torch.empty_like(q)
    ws, counters = _workspace(q, k_pages.shape[1], page_table.shape[1])
    err = _kernel_entry()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        ws.data_ptr(), counters.data_ptr(),
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


def _launch_quant(q, k_pages, v_pages, k_scale, v_scale, page_table,
                  seq_lens, scale):
    b, h, d = q.shape
    _launch_checks(q, k_pages, v_pages, k_scale, v_scale, page_table,
                   seq_lens)
    out = torch.empty_like(q)
    ws, counters = _workspace(q, k_pages.shape[1], page_table.shape[1])
    err = _kernel_entry("ffrpa_quant_launch")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
        counters.data_ptr(), b, h, d, k_pages.shape[0],
        k_pages.shape[1], page_table.shape[1], float(scale),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ragged_paged_attention_quant CUDA launch "
                           f"failed: cudaError {err}")
    ragged_paged_attention_quant.launches += 1
    return out


def ragged_paged_attention_quant(q, k_pages, v_pages, k_scale, v_scale,
                                 page_table, seq_lens, scale=None):
    """Paged-KV decode attention over an INT8 pool: as
    ``ragged_paged_attention``, with k_pages/v_pages int8 and
    k_scale/v_scale [P, page_size] fp32 each token's symmetric scale
    (shared across heads) -> [B, H, D] fp32.

    On the card this launches the CUDA kernel on the current stream,
    without synchronising, and adds one to
    ``ragged_paged_attention_quant.launches``; it raises on anything
    the kernel does not take.  On the CPU it computes the plain
    version."""
    _check(q, k_pages, v_pages, page_table, seq_lens,
           pool_dtypes=(torch.int8,), scales=(k_scale, v_scale))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch_quant(q, k_pages, v_pages, k_scale, v_scale,
                             page_table, seq_lens, scale)
    if q.device.type == "cpu":
        return ragged_paged_attention_quant_reference(
            q, k_pages, v_pages, k_scale, v_scale, page_table, seq_lens,
            scale)
    raise ValueError(f"no ragged_paged_attention_quant for device "
                     f"{q.device}")


ragged_paged_attention_quant.launches = 0
