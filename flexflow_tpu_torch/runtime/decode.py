"""Continuous-batching decode executor — the port of
flexflow_tpu/runtime/decode.py.

Compose RAGGED requests into FIXED decode frames — the [max_seqs]-slot
shape the decode graph (models/decode.py) was built for:

* a ``PageAllocator`` owns the KV page pool; a request is admitted, in
  FIFO order, only when its full page allotment is free, so an admitted
  sequence can always grow to ``max_seq_len``;
* when the pool covers every slot, slot i always takes pages
  [i*pps, (i+1)*pps) (slot-aligned); an oversubscribed pool allocates
  from the free list and reserves one scratch page for idle rows;
* each ``step`` feeds every live slot's next uncached token through ONE
  step-function call — a prompt is prefilled through decode frames, one
  token per frame — and appends the greedy token once the prompt is
  cached;
* a sequence is evicted at ``max_new_tokens`` or EOS, its pages freed.

The step function returns logits on the device; the executor takes the
argmax there and copies only the [B] token ids to the host.

The reference's SLO classes, preemption, prefix sharing, chunked
prefill lane and telemetry hooks come with a later serving slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclass
class DecodeRequest:
    """One sequence to serve: the prompt's token ids and how many new
    tokens to generate; ``eos_id`` stops generation early when the model
    emits it (None = run to max_new_tokens)."""

    rid: str
    prompt: Sequence[int]
    max_new_tokens: int = 8
    eos_id: Optional[int] = None


@dataclass
class _Live:
    req: DecodeRequest
    pages: List[int]
    tokens: List[int] = field(default_factory=list)  # prompt + generated
    cached: int = 0  # tokens already written into the KV cache
    generated: int = 0


class PageAllocator:
    """Free-list page allocator over the decode graph's pool."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._used: set = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return len(self._used)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._used.update(pages)
        return pages

    def alloc_ids(self, ids: Sequence[int]) -> Optional[List[int]]:
        """Reserve SPECIFIC page ids (the slot-aligned path), or None
        when any is already in use."""
        ids = list(ids)
        if any(p in self._used for p in ids):
            return None
        for p in ids:
            self._free.remove(p)
        self._used.update(ids)
        return ids

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            if p not in self._used:
                raise ValueError(f"page {p} is not in use")
            self._used.remove(p)
            self._free.append(p)


class ContinuousBatchingExecutor:
    """Admit ragged requests into fixed decode frames and drive the step
    function ``step_fn(token_ids [B,1], page_table [B,P], seq_lens [B])
    -> logits [B, 1, V]`` (int32 numpy in, a torch tensor out) until
    every request completes."""

    def __init__(self, step_fn: Callable, *, max_seqs: int, page_size: int,
                 pages_per_seq: int, num_pages: int = 0):
        self.step_fn = step_fn
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.allocator = PageAllocator(num_pages or max_seqs * pages_per_seq)
        self.slot_aligned = (
            self.allocator.num_pages >= max_seqs * pages_per_seq)
        # idle frame rows still scatter one garbage k/v, so they must
        # point at a page no live sequence can own: the idle slot's own
        # range when slot-aligned, else a scratch page reserved up front
        self._scratch_page = None
        if not self.slot_aligned:
            got = self.allocator.alloc(1)
            if not got:
                raise ValueError(
                    "page pool too small to reserve the scratch page")
            self._scratch_page = got[0]
        self.slots: List[Optional[_Live]] = [None] * max_seqs
        self.queue: List[DecodeRequest] = []
        self.finished: Dict[str, List[int]] = {}
        self.frame = 0
        self.frame_seconds: List[float] = []
        self.total_admitted = 0
        self.total_evicted = 0
        self.tokens_generated = 0

    def submit(self, requests: Sequence[DecodeRequest]) -> None:
        cap = self.page_size * self.pages_per_seq
        for r in requests:
            if not r.prompt:
                raise ValueError(f"request {r.rid!r} has an empty prompt")
            need = len(r.prompt) + r.max_new_tokens
            if need > cap:
                raise ValueError(
                    f"request {r.rid!r} wants {need} tokens but a sequence "
                    f"caps at {cap} (page_size x pages_per_seq)")
            self.queue.append(r)

    def _admit(self) -> int:
        """Fill open slots from the queue in FIFO order while the
        allocator can reserve a FULL per-sequence allotment."""
        admitted = 0
        while self.queue:
            open_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not open_slots:
                break
            i = open_slots[0]
            if self.slot_aligned:
                pages = self.allocator.alloc_ids(range(
                    i * self.pages_per_seq, (i + 1) * self.pages_per_seq))
            else:
                pages = self.allocator.alloc(self.pages_per_seq)
            if pages is None:
                break
            req = self.queue.pop(0)
            self.slots[i] = _Live(req=req, pages=pages,
                                  tokens=list(req.prompt))
            admitted += 1
        self.total_admitted += admitted
        return admitted

    def _evict(self) -> int:
        """Free finished sequences' pages and reopen their slots."""
        evicted = 0
        for i, live in enumerate(self.slots):
            if live is None:
                continue
            done = live.generated >= live.req.max_new_tokens
            eos = (live.req.eos_id is not None and live.generated > 0
                   and live.tokens[-1] == live.req.eos_id)
            if done or eos:
                self.finished[live.req.rid] = live.tokens[
                    len(live.req.prompt):]
                self.allocator.free(live.pages)
                self.slots[i] = None
                evicted += 1
        self.total_evicted += evicted
        return evicted

    def _compose_frame(self):
        """The fixed-shape frame arrays for the current step: every live
        slot contributes its next uncached token; idle slots carry token
        0 at length 0 with their table row on pages no live sequence
        reads."""
        b = self.max_seqs
        ids = np.zeros((b, 1), np.int32)
        table = np.zeros((b, self.pages_per_seq), np.int32)
        lens = np.zeros((b,), np.int32)
        active = []
        for i, live in enumerate(self.slots):
            if live is None:
                if self.slot_aligned:
                    table[i, :] = np.arange(i * self.pages_per_seq,
                                            (i + 1) * self.pages_per_seq)
                else:
                    table[i, :] = self._scratch_page
                continue
            active.append(i)
            ids[i, 0] = live.tokens[live.cached]
            table[i, :len(live.pages)] = live.pages
            lens[i] = live.cached
        return ids, table, lens, active

    def step(self) -> dict:
        """One decode frame: admit, compose, run, harvest, evict."""
        admitted = self._admit()
        ids, table, lens, active = self._compose_frame()
        t0 = time.perf_counter()
        logits = self.step_fn(ids, table, lens)
        next_tokens = logits[:, 0].argmax(dim=-1).cpu().numpy()
        dt = time.perf_counter() - t0
        self.frame_seconds.append(dt)
        for i in active:
            live = self.slots[i]
            live.cached += 1
            if live.cached < len(live.tokens):
                continue  # still prefilling through decode frames
            live.tokens.append(int(next_tokens[i]))
            live.generated += 1
            self.tokens_generated += 1
        evicted = self._evict()
        rec = {"frame": self.frame, "active": len(active),
               "admitted": admitted, "evicted": evicted,
               "pages_in_use": self.allocator.pages_in_use,
               "queued": len(self.queue), "measured_s": dt}
        self.frame += 1
        return rec

    def run(self, requests: Sequence[DecodeRequest] = (),
            max_frames: int = 10_000) -> Dict[str, List[int]]:
        """Drive frames until every submitted request finished (a stuck
        executor fails loud at ``max_frames``).  Returns rid -> generated
        token ids."""
        if requests:
            self.submit(requests)
        while self.queue or any(s is not None for s in self.slots):
            if self.frame >= max_frames:
                raise RuntimeError(
                    f"decode executor exceeded {max_frames} frames with "
                    f"{len(self.queue)} queued and "
                    f"{sum(s is not None for s in self.slots)} live")
            self.step()
        return dict(self.finished)

    @staticmethod
    def _quantile(values, f: float):
        if not values:
            return None
        s = sorted(values)
        return s[min(len(s) - 1, int(f * (len(s) - 1)))]

    def summary(self) -> dict:
        return {
            "frames": self.frame,
            "completed": len(self.finished),
            "admitted": self.total_admitted,
            "evicted": self.total_evicted,
            "tokens_generated": self.tokens_generated,
            "measured_p50_s": self._quantile(self.frame_seconds, 0.5),
            "measured_p99_s": self._quantile(self.frame_seconds, 0.99),
        }


def compiled_decode_step(model) -> Callable:
    """A ``step_fn`` over a compiled decode model: one forward per frame,
    the KV-cache state dict threaded across calls (the pools are updated
    in place, see ops/decode_attention.py).  Frame arrays are copied to
    the model's device; the logits stay there."""
    compiled = model.compiled
    device = compiled.device
    box = {"state": model.state}

    def step(ids, page_table, seq_lens):
        ins = [torch.as_tensor(np.asarray(a, np.int32)).to(device)
               for a in (ids, page_table, seq_lens)]
        logits, box["state"] = compiled.apply(model.params, box["state"],
                                              ins)
        return logits

    step.state = box  # tests inspect the threaded cache
    return step
