"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py [--seed N]

Phases, each of which ends the run with a non-zero exit when it fails:

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them;
2. build: compile every CUDA kernel of both paths from ``csrc/`` with
   nvcc (sm_90a), all sources at once, and print the build seconds;
3. kernels: call each kernel at its main path's shapes (the decode
   kernel on fp32 and bf16 pools; the three flash kernels in bf16, the
   training path's dtype, and in fp32) and hold it against its plain
   PyTorch version on the same inputs; time the kernel, the plain
   version and one PyTorch library call that computes the same function
   (a yardstick the port never calls), each with CUDA events as the
   median of 25 runs with the L2 cache flushed before each; compute the
   bound from this run's inputs; sweep each kernel over odd shapes and
   check that a head dim it does not take is refused;
4. serving path: build the repo's GPT decode model at GPT-2-small widths
   (12 layers, hidden 768, 12 heads, vocab 32000, 32 frame slots, pages
   of 16 tokens, 1024-token sequences) with random weights from the
   seed, compile it on the card and serve 48 seeded requests through
   ``ContinuousBatchingExecutor``; check the kernel ran 12 times per
   frame, hold the first 8 frames' logits against the same path with
   the plain attention, and check batched serving is token-identical
   to serving 2 of the requests alone; then profile 20 steady frames
   (``torch.profiler``): device busy time and idle share, kernels per
   frame, the largest device-time items;
5. training path: free the serving model; build the repo's GPT at its
   full default widths (``build_gpt``: 12 layers, hidden 768, 12 heads,
   ff 3072, vocab 32000, seq 1024) with batch 8, bf16 compute, Adam,
   per-position sparse CCE and accuracy; compare the first batch's loss
   and gradients on the flash route with the ``use_flash=False`` route;
   ``fit`` 2 epochs over 20 seeded batches (40 steps) and check that
   each flash kernel launched 12 times per step, that every step's loss
   is finite and that the loss on the first batch fell; print step time
   p50/p99, tokens/s and MFU (3 x the graph's forward FLOPs against the
   card's dense bf16 peak); profile 3 steady steps;
6. print one JSON line listing every ported kernel.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The script imports torch and the port, never JAX or the JAX package.
It takes 70-130 s on one H100, the kernels' build included.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
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

# the training path: build_gpt at its defaults (models/transformer.py),
# batch 8; token ids drawn from the first TOKEN_RANGE ids of the vocab,
# so that a few dozen steps visibly lower the loss
TRAIN = dict(vocab=32000, num_layers=12, hidden=768, num_heads=12,
             ff_dim=3072, seq_len=1024)
TRAIN_BATCH = 8
TRAIN_BATCHES = 20
TRAIN_EPOCHS = 2
TOKEN_RANGE = 512
ADAM_ALPHA = 3e-4
TIMED_STEPS = 10
PROFILE_STEPS = 3
# flash kernels vs their plain versions, max abs error over
# max(1, max |plain|): fp32 math in both, the order of the sums differs;
# in bf16 the kernel rounds p to bf16 relative to its running row max,
# the plain version relative to the final row max, and bf16 outputs
# round once more (2^-8 relative)
FLASH_TOL = {"fp32": 1e-4, "bf16": 2e-2}
# the flash route vs the use_flash=False route on the training path's
# first batch: loss relative error, and per weight the gradient's error
# norm over the use_flash=False gradient's norm.  fp32 compute: the
# same function, summation order only; but in this post-LN stack at a
# random init the gradients shrink toward the first layers while the
# rounding noise each layer adds does not, so the relative error grows
# with depth (1.4e-3 at layer 0, against round-off at the top).  bf16
# compute: the two routes round p to bf16 at different points (flash:
# unnormalised, before p.v; attn_core: the normalised probs, which its
# backward reuses), and the q/k gradients pass through
# ds = p (dp - delta), a difference of close numbers at a random init's
# near-uniform attention, which magnifies those roundings most in the
# first layer's wq/wk
LOSS_PATH_TOL = {"bf16": 1e-3, "fp32": 1e-5}
GRAD_PATH_TOL = {"bf16": 0.1, "fp32": 1e-2}

# published peaks (NVIDIA data sheets): device-memory bytes/s, dense
# fp32 (non-tensor-core) operations/s and dense bf16 tensor-core
# operations/s, by card
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100", 3.35e12, 67e12, 989e12),  # SXM
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_peaks(name: str):
    """(bytes/s, fp32 operations/s, bf16 tensor-core operations/s)."""
    for key, *peaks in CARD_PEAKS:
        if key in name:
            return peaks
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
    paths = build(["ragged_paged_attention", "flash_attention"])
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
    bw, fp32, _ = card_peaks(name)
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


def set_op_attr(model, op_type: str, attr: str, value) -> None:
    """Set ``attr`` on every op of the model's graph of ``op_type``."""
    from flexflow_tpu_torch.core.optype import OperatorType

    for node in model.graph.topo_order():
        if node.op.op_type == OperatorType(op_type):
            node.op.attrs[attr] = value


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
    set_op_attr(model, "decode_attention", "use_kernel", False)
    plain = compiled_decode_step(model)
    diff = 0.0
    for ids, table, lens, logits in recorded:
        diff = max(diff, float((plain(ids, table, lens).float()
                                - logits).abs().max()))
    set_op_attr(model, "decode_attention", "use_kernel", True)
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
    ``frames`` frames after ``warm`` frames of the same traffic."""
    ex.submit(reqs)
    for _ in range(warm):
        ex.step()
    return profile_window(ex.step, frames, "frame")


def profile_window(step, n, unit):
    """``torch.profiler`` over ``n`` calls of ``step``.  Reports the host
    wall time of the window, the device busy time (the union of kernel
    and copy intervals) and its share, device kernels per ``unit``, and
    the largest device-time items.  An empty device trace is reported as
    not measured."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        f"{unit}s": n,
        f"{unit}_wall_ms": wall_us / n / 1e3,
        f"device_busy_ms_per_{unit}": busy / n / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        f"device_kernels_per_{unit}": len(dev) / n,
        f"top_device_ms_per_{unit}": {
            name[:60]: t / n / 1e3 for name, t in top},
    }


# ---------------------------------------------------------------------------
def rel_err(got, ref) -> float:
    """max |got - ref| over max(1, max |ref|), in fp32."""
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def live_pairs(b, h, sq, sk, causal) -> int:
    """(query, key) pairs the causal end-aligned mask leaves live."""
    if not causal:
        return b * h * sq * sk
    off = sk - sq
    rows = np.clip(np.arange(sq) + off + 1, 0, sk)
    dead = int((np.arange(sq) + off < 0).sum())  # uniform over all keys
    return b * h * (int(rows.sum()) + dead * sk)


def flash_bound_ms(kind, b, h, sq, sk, d, causal, elem_bytes, name):
    """Least time for one kernel's work on this card: each operand read
    once and each output written once (lse and delta fp32 [B, H, Sq]),
    against the peak rate of the inputs' type (dense bf16 tensor cores;
    fp32 outside the tensor cores) for the products over live pairs:
    2D operations per pair and product, 2 products in the forward, 3 in
    dq, 4 in dkv."""
    bw, fp32, bf16 = card_peaks(name)
    peak = bf16 if elem_bytes == 2 else fp32
    q_el, k_el = b * sq * h * d, b * sk * h * d
    rows = b * h * sq * 4
    nbytes, products = {
        "fwd": ((2 * q_el + 2 * k_el) * elem_bytes + rows, 2),
        "dq": ((3 * q_el + 2 * k_el) * elem_bytes + 2 * rows, 3),
        "dkv": ((2 * q_el + 4 * k_el) * elem_bytes + 2 * rows, 4),
    }[kind]
    ops = 2.0 * d * products * live_pairs(b, h, sq, sk, causal)
    t_bytes, t_ops = nbytes / bw * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_operands(b, sq, sk, h, d, dtype, gen):
    dev = torch.device("cuda")
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, sk, h, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, sk, h, d), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
    return q, k, v, do


def flash_errors(q, k, v, do, causal, scale):
    """Each flash kernel against its plain version on the same inputs:
    the backward kernels and their plain versions both take the
    forward kernel's lse and the delta of its output."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    out, lse = fa.flash_forward(q, k, v, causal, scale)
    r_out, r_lse = fa.flash_forward_reference(q, k, v, causal, scale)
    delta = fa._delta(out, do).contiguous()
    args = (q, k, v, do, lse, delta, causal, scale)
    dq = fa.flash_backward_dq(*args)
    dk, dv = fa.flash_backward_dkv(*args)
    r_dq = fa.flash_backward_dq_reference(*args)
    r_dk, r_dv = fa.flash_backward_dkv_reference(*args)
    torch.cuda.synchronize()
    for t in (out, lse, dq, dk, dv):
        check(bool(torch.isfinite(t).all()), "a flash kernel gave "
              "non-finite values")
    return {
        "fwd": max(rel_err(out, r_out), rel_err(lse, r_lse)),
        "dq": rel_err(dq, r_dq),
        "dkv": max(rel_err(dk, r_dk), rel_err(dv, r_dv)),
        "abs": {"fwd": float((out.float() - r_out.float()).abs().max()),
                "dq": float((dq.float() - r_dq.float()).abs().max()),
                "dkv": max(float((dk.float() - r_dk.float()).abs().max()),
                           float((dv.float() - r_dv.float()).abs().max()))},
        "ref_max": {"out": float(r_out.float().abs().max()),
                    "dq": float(r_dq.float().abs().max()),
                    "dk": float(r_dk.float().abs().max()),
                    "dv": float(r_dv.float().abs().max())},
    }


def phase_flash_kernels(name, seed):
    """The three flash kernels at the training path's shape (B 8, S 1024,
    H 12, D 64, causal) in bf16 and fp32: errors against the plain
    versions, and in each dtype the kernel, plain and library times with
    the bound.  Library: ``scaled_dot_product_attention(is_causal=True)``
    forward for the forward kernel; its backward (dq, dk and dv
    together) for the two backward kernels."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    b, s, h = TRAIN_BATCH, TRAIN["seq_len"], TRAIN["num_heads"]
    d = TRAIN["hidden"] // h
    scale = 1.0 / math.sqrt(d)
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        q, k, v, do = flash_operands(b, s, s, h, d, dt, gen)
        errs = flash_errors(q, k, v, do, True, scale)
        for kind in ("fwd", "dq", "dkv"):
            check(errs[kind] <= FLASH_TOL[tag],
                  f"flash {kind} kernel vs plain version ({tag}): error "
                  f"{errs[kind]:.3e} > {FLASH_TOL[tag]}")
        out, lse = fa.flash_forward(q, k, v, True, scale)
        delta = fa._delta(out, do).contiguous()
        args = (q, k, v, do, lse, delta, True, scale)
        # the library call on [B, H, S, D] views; with Sq = Sk its
        # top-left causal mask is the end-aligned one
        ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        lib_out = sdpa(ql, kl, vl, is_causal=True)
        dol = do.transpose(1, 2)
        lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), dol, retain_graph=True), flush)
        timed = {
            "fwd": (lambda: fa.flash_forward(q, k, v, True, scale),
                    lambda: fa.flash_forward_reference(q, k, v, True, scale),
                    time_ms(lambda: sdpa(ql.detach(), kl.detach(),
                                         vl.detach(), is_causal=True),
                            flush)),
            "dq": (lambda: fa.flash_backward_dq(*args),
                   lambda: fa.flash_backward_dq_reference(*args),
                   lib_bwd_ms),
            "dkv": (lambda: fa.flash_backward_dkv(*args),
                    lambda: fa.flash_backward_dkv_reference(*args),
                    lib_bwd_ms),
        }
        for kind, (kernel, plain, library_ms) in timed.items():
            bound_ms, bound_by = flash_bound_ms(kind, b, h, s, s, d, True,
                                                q.element_size(), name)
            results[(kind, tag)] = dict(
                max_abs_err=errs["abs"][kind], rel_err=errs[kind],
                ms=time_ms(kernel, flush), plain_ms=time_ms(plain, flush),
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
            print(f"kernel flash_{kind} [{tag}, B={b} S={s} H={h} D={d} "
                  f"causal, {live_pairs(b, h, s, s, True)} live pairs]: "
                  + json.dumps(results[(kind, tag)]))
        print(f"flash plain-version magnitudes [{tag}]: "
              + json.dumps(errs["ref_max"]))
    results["sweep"] = sweep_flash_shapes(seed)
    return results


def sweep_flash_shapes(seed):
    """Every head dim the flash kernels take (16 to 128 by 16), causal
    and not, Sq = Sk, Sq < Sk and Sq > Sk, ragged lengths, bf16 and
    fp32, against the plain versions; head dims 8 and 144 are refused."""
    from flexflow_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    pairs = ((1, 1), (17, 17), (100, 100), (1000, 1000), (17, 100),
             (100, 17), (1, 1000), (1000, 1), (130, 64))
    worst = {"fp32": 0.0, "bf16": 0.0}
    for tag, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for causal in (False, True):
            for sq, sk in pairs:
                for d in fa.HEAD_DIMS:
                    q, k, v, do = flash_operands(2, sq, sk, 2, d, dt, gen)
                    errs = flash_errors(q, k, v, do, causal,
                                        1.0 / math.sqrt(d))
                    err = max(errs[kind] for kind in ("fwd", "dq", "dkv"))
                    check(err <= FLASH_TOL[tag],
                          f"flash sweep {tag} causal={causal} Sq={sq} "
                          f"Sk={sk} D={d}: error {err:.3e} > "
                          f"{FLASH_TOL[tag]}")
                    worst[tag] = max(worst[tag], err)
    for d in (8, 144):
        q = torch.zeros((1, 4, 1, d), device="cuda")
        try:
            fa.flash_forward(q, q, q, False, 1.0)
            fail(f"flash head dim {d} was not refused")
        except ValueError:
            pass
    print(f"flash shape sweep: D 16..128 x causal/not x (Sq, Sk) in "
          f"{list(pairs)} x fp32/bf16, worst error {json.dumps(worst)}; "
          f"D=8 and D=144 refused")
    return worst


# ---------------------------------------------------------------------------
def path_parity(model, inputs, labels):
    """The first batch's loss and gradients on the flash route against
    the use_flash=False route (``attn_core``), at the same weights, in
    the model's bf16 compute and again in fp32 compute; and each route's
    time for that forward and backward (synchronised, median of 3 after
    one warm-up call)."""
    compiled = model.compiled

    def run(flash):
        set_op_attr(model, "multihead_attention", "use_flash", flash)
        out = compiled.loss_and_grads(model.params, model.state, inputs,
                                      labels)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compiled.loss_and_grads(model.params, model.state, inputs,
                                    labels)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        set_op_attr(model, "multihead_attention", "use_flash", True)
        return out[0], out[3], float(np.median(times)) * 1e3

    report = {}
    for tag, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        compiled.compute_dtype = dt
        loss_f, g_f, ms_f = run(True)
        loss_x, g_x, ms_x = run(False)
        worst, worst_name, by_group = 0.0, "", {}
        for op, ws in g_x.items():
            for w, ref in ws.items():
                err = float((g_f[op][w] - ref).norm()
                            / ref.norm().clamp_min(1e-30))
                group = op.split("_")[0]  # layer<i>, or the op itself
                by_group[group] = max(by_group.get(group, 0.0), err)
                if err > worst:
                    worst, worst_name = err, f"{op}/{w}"
        report[tag] = {
            "loss_flash": float(loss_f), "loss_plain_route": float(loss_x),
            "loss_rel_err": abs(float(loss_f) - float(loss_x))
            / abs(float(loss_x)),
            "grad_worst_rel_norm_err": worst, "grad_worst_weight": worst_name,
            "grad_worst_rel_norm_err_by_op_group": by_group,
            "fwd_bwd_ms_flash": ms_f, "fwd_bwd_ms_plain_route": ms_x}
        del g_f, g_x
    compiled.compute_dtype = model.config.torch_compute_dtype
    return report


def phase_train(seed, name):
    from flexflow_tpu_torch import AdamOptimizer, FFConfig
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.models import build_gpt

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = FFConfig(batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                   seed=seed)
    model = build_gpt(cfg, **TRAIN)
    model.compile(optimizer=AdamOptimizer(alpha=ADAM_ALPHA),
                  loss_type="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    torch.cuda.synchronize()
    n_params = sum(w.numel() for ws in model.params.values()
                   for w in ws.values())
    flops = sum(n.op.flops() for n in model.graph.nodes.values())
    print(f"training path: compiled in {time.perf_counter() - t0:.2f} s, "
          f"{n_params} parameters, forward FLOPs per step {flops:.6e}")

    rng = np.random.default_rng(seed + 3)
    ids = rng.integers(0, TOKEN_RANGE, size=(
        TRAIN_BATCHES * TRAIN_BATCH, TRAIN["seq_len"] + 1)).astype(np.int32)
    x, y = ids[:, :-1], ids[:, 1:]
    dev = model.compiled.device
    first = ([torch.from_numpy(x[:TRAIN_BATCH]).to(dev)],
             torch.from_numpy(y[:TRAIN_BATCH]).to(dev))
    parity = path_parity(model, *first)
    print("training path vs use_flash=False route, first batch: "
          + json.dumps(parity))
    del first

    kernels = (fa.flash_forward, fa.flash_backward_dq,
               fa.flash_backward_dkv)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    history = model.fit(x, y, batch_size=TRAIN_BATCH, epochs=TRAIN_EPOCHS,
                        shuffle=False, verbose=False)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    steps = len(model.step_losses)
    losses = model.step_losses
    final = model.evaluate(x[:TRAIN_BATCH], y[:TRAIN_BATCH])
    tokens_per_s = model.last_throughput * TRAIN["seq_len"]
    bf16_peak = card_peaks(name)[2]
    mfu = 3.0 * flops * model.last_throughput / TRAIN_BATCH / bf16_peak
    print("training path: " + json.dumps({
        "steps": steps, "fit_wall_s": wall,
        "samples_per_s": model.last_throughput,
        "tokens_per_s": tokens_per_s, "mfu_vs_dense_bf16_peak": mfu,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_first_step": losses[0], "loss_last_step": losses[-1],
        "first_batch_loss_after": final["loss"],
        "epoch_history": history, "kernel_launches": launches}))
    print("training path step losses: "
          + json.dumps([round(v, 5) for v in losses]))
    check(steps == TRAIN_EPOCHS * TRAIN_BATCHES, f"{steps} steps ran")
    for kname, n in launches.items():
        check(n == TRAIN["num_layers"] * steps,
              f"{kname}: {n} launches for {steps} steps of "
              f"{TRAIN['num_layers']} layers")
    check(bool(np.isfinite(losses).all()), "a step's loss is not finite")
    check(final["loss"] < losses[0],
          f"first batch's loss did not fall: {losses[0]:.4f} at step 1, "
          f"{final['loss']:.4f} after training")

    # step time: synchronised steps over the first batches
    batches = [([torch.from_numpy(x[i:i + TRAIN_BATCH]).to(dev)],
                torch.from_numpy(y[i:i + TRAIN_BATCH]).to(dev))
               for i in range(0, TIMED_STEPS * TRAIN_BATCH, TRAIN_BATCH)]

    def train_step(batch):
        model.params, model.opt_state, model.state, loss, _ = (
            model.compiled.train_step(model.params, model.opt_state,
                                      model.state, *batch))
        return loss

    times = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print("training path step time (synchronised steps): " + json.dumps({
        "steps": len(times), "p50_ms": float(np.median(times)) * 1e3,
        "p99_ms": float(np.quantile(times, 0.99)) * 1e3}))
    it = iter(batches)
    print("training path profile: " + json.dumps(profile_window(
        lambda: train_step(next(it)), PROFILE_STEPS, "step")))

    for tag, par in parity.items():
        check(par["loss_rel_err"] <= LOSS_PATH_TOL[tag],
              f"{tag}: flash route loss differs from the use_flash=False "
              f"route by {par['loss_rel_err']:.3e} > {LOSS_PATH_TOL[tag]}")
        check(par["grad_worst_rel_norm_err"] <= GRAD_PATH_TOL[tag],
              f"{tag}: flash route gradient of {par['grad_worst_weight']} "
              f"differs by {par['grad_worst_rel_norm_err']:.3e} > "
              f"{GRAD_PATH_TOL[tag]}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    name = phase_device()
    phase_build()
    rpa = phase_kernels(name, args.seed)
    flash = phase_flash_kernels(name, args.seed)
    rpa_launches = phase_main_path(args.seed)
    flash_launches = phase_train(args.seed, name)
    fp32 = rpa["fp32"]
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "flexflow_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "flexflow_tpu/kernels/ragged_paged_attention.py:132",
        "launches": rpa_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rpa.values()),
        "ms": fp32["ms"],
        "plain_ms": fp32["plain_ms"],
        "bound_ms": fp32["bound_ms"],
        "bound_by": fp32["bound_by"],
        "library_ms": fp32["library_ms"],
        "bf16_pool": rpa["bf16"],
    }]
    for kind, wrapper, line in (("fwd", "flash_forward", 66),
                                ("dq", "flash_backward_dq", 194),
                                ("dkv", "flash_backward_dkv", 242)):
        bf16 = flash[(kind, "bf16")]
        kernels.append({
            "name": wrapper,
            "route": "cuda",
            "source": "flexflow_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"flexflow_tpu/kernels/flash_attention.py:{line}",
            "launches": flash_launches[wrapper],
            "max_abs_err": bf16["max_abs_err"],
            "ms": bf16["ms"],
            "plain_ms": bf16["plain_ms"],
            "bound_ms": bf16["bound_ms"],
            "bound_by": bf16["bound_by"],
            "library_ms": bf16["library_ms"],
            "fp32": flash[(kind, "fp32")],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
