"""Card-only experiment (tools/mfu_probe.py on the port):
decompose the bench transformer's step on the card into forward,
forward + backward, and the full train step.

    python -m flexflow_tpu_torch.tools.mfu_probe

The shape is bench.py's transformer (batch 64, seq 256, hidden 512, 6
layers, 8 heads, ff 2048, bf16 compute, ``only_data_parallel``).  Each
variant runs over N = 10 batches per timed call, timed with CUDA
events (the median of 3 calls after 3 warm-up calls), so the split
tells where the time outside the GEMMs goes.  MFU is against the
detected card's dense bf16 tensor-core peak, the train step counted as
3x the forward's operations.  A config on the CPU is refused: there is
nothing of the card to measure there.
"""
from __future__ import annotations

import numpy as np
import torch

from flexflow_tpu_torch import AdamOptimizer, FFConfig
from flexflow_tpu_torch.core.machine import card_peaks
from flexflow_tpu_torch.models import build_transformer

BENCH = dict(num_layers=6, hidden=512, num_heads=8, ff_dim=2048, seq_len=256)
BATCH = 64
DTYPE = "bfloat16"
N = 10


def card_config(config=None, tool="mfu_probe") -> FFConfig:
    """The bench transformer's config on the card; a CPU config is
    refused with a message."""
    config = config or FFConfig(batch_size=BATCH, epochs=1, num_devices=1,
                                only_data_parallel=True,
                                compute_dtype=DTYPE)
    if torch.device(config.device).type != "cuda":
        raise SystemExit(f"{tool} is a card-only experiment (it times the "
                         f"step on a CUDA card); got a config with "
                         f"device={config.device!r}")
    config.torch_device()  # a card config without CUDA raises here
    return config


def dense_bf16_peak() -> float:
    """The card's published dense bf16 peak (``core.machine.CARD_PEAKS``)."""
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    if peaks is None:
        raise SystemExit(f"no published dense bf16 peak for {name!r}")
    return peaks[2]


def bench_model(config):
    """(model, N stacked input batches, N label batches) on the card."""
    model = build_transformer(config, dtype=DTYPE, **BENCH)
    model.compile(optimizer=AdamOptimizer(alpha=1e-4),
                  loss_type="mean_squared_error",
                  metrics=["mean_squared_error"])
    # the batches are drawn on the card from a seeded generator: the
    # host's normal draw of 2 x 84 M values would take seconds
    dev = model.compiled.device
    gen = torch.Generator(dev).manual_seed(0)
    shape = (N, config.batch_size, BENCH["seq_len"], BENCH["hidden"])
    xs = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    ys = torch.randn(shape, generator=gen, device=dev)
    return model, xs, ys


def forward_flops(model) -> float:
    return float(sum(n.op.flops() for n in model.graph.nodes.values()))


def timeit(fn, reps=3) -> float:
    """Seconds per batch: ``fn`` runs N batches; CUDA events around each
    call, the median of ``reps`` calls after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return float(np.median(times)) / N


def main(argv=None, config=None) -> dict:
    config = card_config(config)
    model, xs, ys = bench_model(config)
    comp = model.compiled
    fwd_flops = forward_flops(model)
    peak = dense_bf16_peak()
    print(f"fwd_flops/step: {fwd_flops/1e9:.2f} GF, train=3x: "
          f"{3*fwd_flops/1e9:.2f} GF")

    # 1) the full train step (captured), update and metrics included
    def full():
        for i in range(N):
            model.params, model.opt_state, model.state, _, _ = (
                comp.train_step(model.params, model.opt_state, model.state,
                                [xs[i]], ys[i], seed=i))

    t_full = timeit(full)
    print(f"full train step: {t_full*1e3:.3f} ms/step  "
          f"MFU(3x)={3*fwd_flops/t_full/peak:.4f}")

    # 2) forward only over the same batches
    @torch.no_grad()
    def fwd():
        for i in range(N):
            comp.apply(model.params, model.state, [xs[i]], train=True)

    t_fwd = timeit(fwd)
    print(f"forward only:    {t_fwd*1e3:.3f} ms/step  "
          f"MFU(1x)={fwd_flops/t_fwd/peak:.4f}")

    # 3) loss + grads, no optimizer update, no metrics
    def grad():
        for i in range(N):
            comp.loss_and_grads(model.params, model.state, [xs[i]], ys[i])

    t_grad = timeit(grad)
    print(f"fwd+bwd (no upd/metrics): {t_grad*1e3:.3f} ms/step  "
          f"MFU(3x)={3*fwd_flops/t_grad/peak:.4f}")
    print(f"update+metrics overhead: {(t_full-t_grad)*1e3:.3f} ms/step")
    print(f"bwd/fwd ratio: {(t_grad-t_fwd)/t_fwd:.2f}")
    return {"full_ms": t_full * 1e3, "forward_ms": t_fwd * 1e3,
            "fwd_bwd_ms": t_grad * 1e3,
            "mfu_full": 3 * fwd_flops / t_full / peak,
            "mfu_forward": fwd_flops / t_fwd / peak,
            "mfu_fwd_bwd": 3 * fwd_flops / t_grad / peak,
            "forward_gflops": fwd_flops / 1e9}


if __name__ == "__main__":
    main()
