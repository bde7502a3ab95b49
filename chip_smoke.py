"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build: compile every CUDA kernel of the path from ``csrc/`` with
   nvcc (sm_90a) and print the build seconds;
3. kernels: call each kernel at the main path's shapes on fp32 and bf16
   pools and hold it against its plain PyTorch version; time the
   kernel, the plain version and one PyTorch library call that computes
   the same function (a yardstick the port never calls), each with CUDA
   events as the median of 25 runs with the L2 cache flushed before
   each; compute the bound from this run's inputs;
4. main path: build the repo's GPT decode model at GPT-2-small widths
   (12 layers, hidden 768, 12 heads, vocab 32000, 32 frame slots, pages
   of 16 tokens, 1024-token sequences) with random weights from the
   seed, compile it on the card and serve 48 seeded requests through
   ``ContinuousBatchingExecutor``; check the kernel ran 12 times per
   frame, hold the first 8 frames' logits against the same path with
   the plain attention, and check batched serving is token-identical
   to serving 2 of the requests alone; then profile 20 steady frames
   (``torch.profiler``): device busy time and idle share, kernels per
   frame, the largest device-time items;
5. print one JSON line listing every ported kernel.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script imports torch and the port, never JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# GPT-2-small widths with the repo's vocab, post-LN/ReLU blocks: the
# defaults of build_gpt (models/transformer.py), served through its
# decode twin
FULL = dict(vocab=32000, num_layers=12, hidden=768, num_heads=12,
            ff_dim=3072, page_size=16, pages_per_seq=64)
FRAME_SLOTS = 32
MAX_SEQ = FULL["page_size"] * FULL["pages_per_seq"]  # 1024

KERNEL_TOL = 1e-4  # fp32 math in both; only the summation order differs
PATH_TOL = 5e-2  # bf16 compute: a bf16 rounding of the attention output
N_REQUESTS = 48
PARITY_FRAMES = 8
TIMING_RUNS = 25
PROFILE_WARM_FRAMES = 300  # past the first admissions: slots full
PROFILE_FRAMES = 20

# published peaks (NVIDIA data sheets): device-memory bytes/s and dense
# fp32 (non-tensor-core) operations/s, by card
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H200", 4.8e12, 67e12),
    ("H100", 3.35e12, 67e12),  # SXM
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_peaks(name: str):
    for key, bw, fp32 in CARD_PEAKS:
        if key in name:
            return bw, fp32
    fail(f"no published peaks for {name!r} in CARD_PEAKS")


# ---------------------------------------------------------------------------
def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    return name


def phase_build():
    from flexflow_tpu_torch.kernels.build import build

    t0 = time.perf_counter()
    paths = build(["ragged_paged_attention"])
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(p.name for p in paths.values())}")


# ---------------------------------------------------------------------------
def time_ms(fn, flush):
    """Median milliseconds of ``fn`` over TIMING_RUNS CUDA-event-timed
    runs, the L2 cache flushed before each (each layer's pool is cold
    when the real decode step reaches it)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMING_RUNS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def rpa_bound_ms(lens, page_size, cap, h, d, kv_bytes, name):
    """Least time for the work this run's inputs need: each live token's
    k and v row read once per head, q read and out written once, the
    live page-table entries and seq_lens read once; against the fp32
    operations (2 per element for q.k, 2 for p.v)."""
    live = np.clip(lens, 0, cap).astype(np.int64)
    b = len(lens)
    nbytes = (live.sum() * h * d * 2 * kv_bytes + 2 * b * h * d * 4
              + (-(-live // page_size)).sum() * 4 + b * 4)
    ops = 4.0 * live.sum() * h * d
    bw, fp32 = card_peaks(name)
    t_bytes, t_ops = nbytes / bw * 1e3, ops / fp32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_kernels(name, seed):
    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        gather_kv_pages,
        ragged_paged_attention,
        ragged_paged_attention_reference,
    )

    b, h = FRAME_SLOTS, FULL["num_heads"]
    d = FULL["hidden"] // h
    ps, pps = FULL["page_size"], FULL["pages_per_seq"]
    num_pages = b * pps
    rng = np.random.default_rng(seed)
    table = rng.permutation(num_pages)[:b * pps].reshape(b, pps)
    lens = rng.integers(1, MAX_SEQ + 1, size=b)
    lens[:6] = (0, 1, 15, 16, 17, MAX_SEQ)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, d), generator=gen, device=dev)
    k32 = torch.randn((num_pages, ps, h, d), generator=gen, device=dev)
    v32 = torch.randn((num_pages, ps, h, d), generator=gen, device=dev)
    pt = torch.as_tensor(table, dtype=torch.int32, device=dev)
    sl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)  # 256 MB
    pos = torch.arange(MAX_SEQ, device=dev)
    mask = (pos[None, :] < sl[:, None])[:, None, None, :]  # [B,1,1,S]
    results = {}
    for pool in ("fp32", "bf16"):
        dt = torch.float32 if pool == "fp32" else torch.bfloat16
        kp, vp = k32.to(dt), v32.to(dt)
        ref = ragged_paged_attention_reference(q, kp, vp, pt, sl)
        got = ragged_paged_attention(q, kp, vp, pt, sl)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()),
              f"kernel gave non-finite values on the {pool} pool")
        err = float((got - ref).abs().max())
        check(bool(got[0].abs().max() == 0),
              "a sequence of length 0 must give zeros")
        check(err <= KERNEL_TOL,
              f"kernel vs plain version on the {pool} pool: max abs err "
              f"{err:.3e} > {KERNEL_TOL}")
        kd = gather_kv_pages(kp, pt).transpose(1, 2).contiguous()
        vd = gather_kv_pages(vp, pt).transpose(1, 2).contiguous()
        qd = q.to(dt)[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        kernel_ms = time_ms(
            lambda: ragged_paged_attention(q, kp, vp, pt, sl), flush)
        plain_ms = time_ms(
            lambda: ragged_paged_attention_reference(q, kp, vp, pt, sl),
            flush)
        library_ms = time_ms(lambda: sdpa(qd, kd, vd, attn_mask=mask), flush)
        bound_ms, bound_by = rpa_bound_ms(lens, ps, MAX_SEQ, h, d,
                                          kp.element_size(), name)
        results[pool] = dict(max_abs_err=err, ms=kernel_ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        print(f"kernel ragged_paged_attention [{pool} pool, B={b} H={h} "
              f"D={d} ps={ps} pps={pps} P={num_pages}, "
              f"{int(np.clip(lens, 0, MAX_SEQ).sum())} live tokens]: "
              + json.dumps(results[pool]))
        del kd, vd
    sweep_kernel_shapes(seed)
    return results


def sweep_kernel_shapes(seed):
    """Every head dim the kernel takes (multiples of 32 up to 256) and
    odd page sizes, on both pool dtypes, against the plain version; a
    head dim it does not take is refused; an out-of-range page id gives
    a NaN row instead of a read outside the pool."""
    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    b, h, pps = 3, 2, 5
    worst = 0.0
    for d in range(32, 257, 32):
        for ps in (1, 5, 16, 32):
            cap = ps * pps
            num_pages = b * pps + 1
            q = torch.randn((b, h, d), generator=gen, device=dev)
            k = torch.randn((num_pages, ps, h, d), generator=gen, device=dev)
            v = torch.randn((num_pages, ps, h, d), generator=gen, device=dev)
            pt = torch.randperm(num_pages, generator=gen, device=dev)[
                :b * pps].reshape(b, pps).to(torch.int32)
            sl = torch.tensor([0, cap // 2 + 1, cap], dtype=torch.int32,
                              device=dev)
            for dt in (torch.float32, torch.bfloat16):
                kp, vp = k.to(dt), v.to(dt)
                got = ragged_paged_attention(q, kp, vp, pt, sl)
                ref = ragged_paged_attention_reference(q, kp, vp, pt, sl)
                err = float((got - ref).abs().max())
                check(err <= KERNEL_TOL, f"D={d} ps={ps} {dt}: max abs err "
                      f"{err:.3e} > {KERNEL_TOL}")
                worst = max(worst, err)
    bad_pt = pt.clone()
    bad_pt[1, 0] = num_pages  # one past the pool
    got = ragged_paged_attention(q, k, v, bad_pt, sl)
    check(bool(got[1].isnan().all()) and bool(torch.isfinite(got[2]).all()),
          "an out-of-range page id must give a NaN row, and only there")
    try:
        ragged_paged_attention(q[..., :48].contiguous(), k[..., :48],
                               v[..., :48], pt, sl)
        fail("head dim 48 was not refused")
    except ValueError:
        pass
    torch.cuda.synchronize()
    print(f"kernel shape sweep: D 32..256 x page sizes 1, 5, 16, 32 x "
          f"fp32/bf16 pools, max abs err {worst:.3e}; bad page id -> NaN "
          f"row; D=48 refused")


# ---------------------------------------------------------------------------
def make_requests(seed, vocab):
    from flexflow_tpu_torch.runtime.decode import DecodeRequest

    rng = np.random.default_rng(seed + 1)
    reqs = []
    for i in range(N_REQUESTS):
        if i == 5:  # one request fills its sequence exactly
            plen, new = MAX_SEQ - 128, 128
        else:
            plen = int(rng.integers(8, 257))
            new = int(rng.integers(16, 129))
        prompt = rng.integers(0, vocab, size=plen).tolist()
        reqs.append(DecodeRequest(rid=f"r{i}", prompt=prompt,
                                  max_new_tokens=new))
    return reqs


def set_use_kernel(model, on: bool):
    from flexflow_tpu_torch.core.optype import OperatorType

    for node in model.graph.topo_order():
        if node.op.op_type == OperatorType.DECODE_ATTENTION:
            node.op.attrs["use_kernel"] = on


def zero_state(model):
    for t in model.state.values():
        t.zero_()


def phase_main_path(seed):
    from flexflow_tpu_torch import FFConfig
    from flexflow_tpu_torch.kernels.ragged_paged_attention import (
        ragged_paged_attention,
    )
    from flexflow_tpu_torch.models import build_gpt_decode
    from flexflow_tpu_torch.runtime.decode import (
        ContinuousBatchingExecutor,
        DecodeRequest,
        compiled_decode_step,
    )

    t0 = time.perf_counter()
    cfg = FFConfig(batch_size=FRAME_SLOTS, compute_dtype="bfloat16",
                   seed=seed)
    model = build_gpt_decode(cfg, **FULL)
    model.compile(comp_mode="inference")
    torch.cuda.synchronize()
    n_params = sum(w.numel() for ws in model.params.values()
                   for w in ws.values())
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in model.state.values())
    print(f"main path: compiled in {time.perf_counter() - t0:.2f} s, "
          f"{n_params} parameters, KV pools {pool_bytes / 1e9:.3f} GB")

    def executor(step):
        return ContinuousBatchingExecutor(
            step, max_seqs=FRAME_SLOTS, page_size=FULL["page_size"],
            pages_per_seq=FULL["pages_per_seq"])

    step = compiled_decode_step(model)
    # warm-up: library handles and allocator pools, off the clock
    executor(step).run([DecodeRequest(rid="warm", prompt=[1, 2, 3],
                                      max_new_tokens=4)])
    zero_state(model)

    recorded = []

    def recording_step(ids, table, lens):
        logits = step(ids, table, lens)
        if len(recorded) < PARITY_FRAMES:
            recorded.append((ids.copy(), table.copy(), lens.copy(),
                             logits.float().clone()))
        return logits

    reqs = make_requests(seed, FULL["vocab"])
    ex = executor(recording_step)
    ragged_paged_attention.launches = 0
    t0 = time.perf_counter()
    out = ex.run(reqs, max_frames=20_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ragged_paged_attention.launches
    frames = ex.frame
    summ = ex.summary()
    tokens = sum(len(v) for v in out.values())
    print("main path: " + json.dumps({
        "frames": frames, "requests_finished": len(out),
        "frame_p50_ms": summ["measured_p50_s"] * 1e3,
        "frame_p99_ms": summ["measured_p99_s"] * 1e3,
        "generated_tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "kernel_launches": launches}))
    check(len(out) == N_REQUESTS,
          f"{len(out)} of {N_REQUESTS} requests finished")
    for r in reqs:
        got = out[r.rid]
        check(len(got) == r.max_new_tokens,
              f"{r.rid}: {len(got)} tokens, wanted {r.max_new_tokens}")
        check(all(0 <= t < FULL["vocab"] for t in got),
              f"{r.rid}: token id outside the vocab")
    check(launches == FULL["num_layers"] * frames,
          f"{launches} kernel launches for {frames} frames of "
          f"{FULL['num_layers']} layers")
    check(len(recorded) == PARITY_FRAMES,
          f"{len(recorded)} frames recorded for the parity replay")
    for *_, logits in recorded:
        check(tuple(logits.shape) == (FRAME_SLOTS, 1, FULL["vocab"]),
              f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "non-finite logits")

    # the same path with the plain attention, replayed over the first
    # frames from an empty cache
    zero_state(model)
    set_use_kernel(model, False)
    plain = compiled_decode_step(model)
    diff = 0.0
    for ids, table, lens, logits in recorded:
        diff = max(diff, float((plain(ids, table, lens).float()
                                - logits).abs().max()))
    set_use_kernel(model, True)
    print(f"main path vs plain attention, first {len(recorded)} frames: "
          f"logits max abs diff {diff:.3e} (tol {PATH_TOL})")
    check(diff <= PATH_TOL, f"logits differ by {diff:.3e} > {PATH_TOL}")

    # batched serving equals serving a request alone
    shortest = sorted(reqs, key=lambda r: len(r.prompt) + r.max_new_tokens)
    for r in shortest[:2]:
        zero_state(model)
        alone = executor(compiled_decode_step(model)).run([r])
        check(alone[r.rid] == out[r.rid],
              f"{r.rid}: served alone gives other tokens than batched")
    print(f"main path: batched == solo for "
          f"{[r.rid for r in shortest[:2]]}")

    zero_state(model)
    print("main path profile: " + json.dumps(
        profile_frames(executor(compiled_decode_step(model)), reqs)))
    return launches


def profile_frames(ex, reqs, warm=PROFILE_WARM_FRAMES,
                   frames=PROFILE_FRAMES):
    """Where a steady decode frame's time goes: ``torch.profiler`` over
    ``frames`` frames after ``warm`` frames of the same traffic.  Reports
    the host wall time of the window, the device busy time (the union
    of kernel and copy intervals) and its share, device kernels per
    frame, and the largest device-time items.  An empty device trace is
    reported as not measured."""
    from torch.profiler import ProfilerActivity, profile

    ex.submit(reqs)
    for _ in range(warm):
        ex.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(frames):
            ex.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"device_time": "not measured (no device events traced)"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "frames": frames,
        "frame_wall_ms": wall_us / frames / 1e3,
        "device_busy_ms_per_frame": busy / frames / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_kernels_per_frame": len(dev) / frames,
        "top_device_ms_per_frame": {
            name[:60]: t / frames / 1e3 for name, t in top},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    name = phase_device()
    phase_build()
    rpa = phase_kernels(name, args.seed)
    launches = phase_main_path(args.seed)
    fp32 = rpa["fp32"]
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "flexflow_tpu/kernels/ragged_paged_attention.py:132",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rpa.values()),
        "ms": fp32["ms"],
        "plain_ms": fp32["plain_ms"],
        "bound_ms": fp32["bound_ms"],
        "bound_by": fp32["bound_by"],
        "library_ms": fp32["library_ms"],
        "bf16_pool": rpa["bf16"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
