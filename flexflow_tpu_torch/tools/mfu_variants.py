"""Card-only experiment (tools/mfu_variants.py on the port): the bench
transformer's step time under three attention routes.

    python -m flexflow_tpu_torch.tools.mfu_variants baseline
    python -m flexflow_tpu_torch.tools.mfu_variants flash
    python -m flexflow_tpu_torch.tools.mfu_variants bf16probs

``baseline``: the port's route at seq 256, below the flash threshold,
so ``attn_core``.  ``flash``: the flash route forced at seq 256 (the
threshold lowered in this process only), so the CUDA flash kernels
(rows 1-3): their recompute backward never keeps the [B, H, Sq, Sk]
probabilities.  ``bf16probs``: the reference's prototype, plain
attention whose backward keeps only a bf16 copy of the probabilities,
as a ``torch.autograd.Function`` over plain torch ops.  Each variant
is chosen here; nothing in ``flexflow_tpu_torch/ops/`` changes.  The
shape, timer and peak are ``mfu_probe``'s.
"""
from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from flexflow_tpu_torch.tools.mfu_probe import (
    BATCH,
    BENCH,
    N,
    bench_model,
    card_config,
    dense_bf16_peak,
    forward_flops,
)

VARIANTS = ("baseline", "flash", "bf16probs")


class _Bf16Probs(torch.autograd.Function):
    """softmax(q k^T * scale) v with only a bf16 residual of the
    probabilities kept for the backward (tools/mfu_variants.py:25-64);
    q, k, v [B, S, H, D], not causal."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        p = torch.softmax(s, dim=-1).to(q.dtype)  # the bf16 residual
        ctx.save_for_backward(q, k, v, p)
        ctx.scale = scale
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v, p = ctx.saved_tensors
        pf = p.float()
        gv = torch.einsum("bhqk,bqhd->bkhd", pf.to(g.dtype), g)
        gp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
        # the softmax vjp from the (bf16-rounded) probabilities
        gs = pf * (gp - (pf * gp).sum(dim=-1, keepdim=True)) * ctx.scale
        gq = torch.einsum("bhqk,bkhd->bqhd", gs.to(q.dtype), k)
        gk = torch.einsum("bhqk,bqhd->bkhd", gs.to(q.dtype), q)
        return gq, gk, gv, None


def _bf16probs(q, k, v, causal, scale, q0=0, sq_total=None):
    assert not causal and q0 == 0
    return _Bf16Probs.apply(q, k, v, scale)


@contextlib.contextmanager
def route(variant: str):
    """This process's attention routed for ``variant`` inside the block,
    and back as it was after."""
    from flexflow_tpu_torch.ops import attention

    if variant not in VARIANTS:
        raise SystemExit(f"unknown variant {variant!r}; one of {VARIANTS}")
    saved = attention.FLASH_MIN_SK, attention.attn_core
    if variant == "flash":
        attention.FLASH_MIN_SK = BENCH["seq_len"]
    elif variant == "bf16probs":
        attention.attn_core = _bf16probs
    try:
        yield
    finally:
        attention.FLASH_MIN_SK, attention.attn_core = saved


def main(argv=None, config=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    variant = argv[0] if argv else "baseline"
    config = card_config(config, "mfu_variants")
    with route(variant):
        return _time_variant(variant, config)


def _time_variant(variant, config) -> dict:
    model, xs, ys = bench_model(config)
    comp = model.compiled

    def block(b):
        for i in range(3 * N):
            model.params, model.opt_state, model.state, _, _ = (
                comp.train_step(model.params, model.opt_state, model.state,
                                [xs[i % N]], ys[i % N], seed=b * 3 * N + i))

    block(0)  # warm, captured
    torch.cuda.synchronize()
    times = []
    for b in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        block(1 + b)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / (3 * N))
    step = float(np.median(times))
    fwd_flops = forward_flops(model)
    mfu = 3 * fwd_flops / step / dense_bf16_peak()
    print(f"{variant}: {step*1e3:.3f} ms/step  "
          f"throughput={BATCH/step:.1f} samples/s  MFU={mfu:.4f}")
    return {"variant": variant, "step_ms": step * 1e3,
            "samples_per_s": BATCH / step, "mfu": mfu}


if __name__ == "__main__":
    main()
