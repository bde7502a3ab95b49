"""Continuous-batching decode executor — the port of
flexflow_tpu/runtime/decode.py.

Compose RAGGED requests into FIXED decode frames — the [max_seqs]-slot
shape the decode graph (models/decode.py) was built for:

* a ``PageAllocator`` owns the KV page pool; a request is **admitted**
  only when its full page allotment is reservable.  With radix
  **prefix sharing** armed, part of that allotment may CLAIM
  already-cached pages by refcount — a prefix-trie lookup keyed on
  token ids at page granularity finds the longest cached prefix of the
  prompt — and a mid-page divergence duplicates exactly that one page
  at admission (copy-on-write, ``copy_page_fn``).  The residency
  contract is **reserve-on-divergence**: from admission on, every page
  at or after the first position a sequence will write is PRIVATE
  (refcount 1, checked by ``PageAllocator.assert_divergence_reserved``),
  so an admitted sequence can always grow to ``max_seq_len``, writes
  never land in a shared page, and eviction returns a page to the free
  list only at refcount zero.  Admission runs in **priority order**
  when SLO classes are armed: higher-priority requests admit first, a
  request whose ``deadline_frames`` passed while queued is EXPIRED
  instead of served late, and a strictly-higher-priority arrival may
  preempt the lowest-priority live sequence (pages released by
  refcount, the sequence re-queued with its tokens so far —
  regeneration is deterministic);
* prompts enter through the **chunked prefill lane** when one is armed
  (``prefill_fn``, built by ``compiled_decode_step(model,
  prefill_chunk=C)`` from runtime/prefill.py): the prompt's causal
  forward runs once per C-token chunk and scatters K/V straight into
  the sequence's pages, then the sequence joins the decode loop at its
  LAST prompt token — token-identical to prefill through decode frames
  (one frame per prompt token), which remains the path without a
  ``prefill_fn``; under prefix sharing both paths start at the first
  token past the claimed prefix;
* each ``step`` feeds every live slot's next token through ONE step
  function call, until ``max_new_tokens`` or EOS;
* with the obs bus armed every frame emits a ``decode.frame`` event and
  the run ends with a ``decode.summary`` (the reference's schemas); the
  request span tree (``TRACER``) and the metrics histograms
  (``METRICS``) follow each request from enqueue to finish;
  ``decode_drift_report`` folds measured frame latencies against a
  predicted p99.  The hot path reads ``BUS.enabled`` once per frame.

The step function returns logits on the device; the executor takes the
argmax there and copies only the [B] token ids to the host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from flexflow_tpu_torch.obs import annotate
from flexflow_tpu_torch.obs.events import BUS
from flexflow_tpu_torch.obs.tracing import TRACER


@dataclass
class DecodeRequest:
    """One sequence to serve: the prompt's token ids and how many new
    tokens to generate.  ``eos_id`` stops generation early when the
    model emits it (None = run to max_new_tokens).  ``slo`` names the
    request's SLO class (resolved against the executor's class table);
    ``priority``/``deadline_frames`` override the class defaults —
    higher priority admits first, a deadline (frames from enqueue to
    admission) expires the request instead of serving it late."""

    rid: str
    prompt: Sequence[int]
    max_new_tokens: int = 8
    eos_id: Optional[int] = None
    slo: str = "standard"
    priority: Optional[int] = None
    deadline_frames: Optional[int] = None


@dataclass(frozen=True)
class SLOClass:
    """One request class of the serving deployment: admission priority,
    queue deadline, and the arrival quantile its latency is watched at
    (``measured_request_p99`` per class).  ``FFConfig.serve_slo_classes``
    entries carry these four fields."""

    name: str
    priority: int = 0
    deadline_frames: int = 0  # 0 = no deadline
    quantile: float = 0.99

    def to_jsonable(self) -> dict:
        return {"name": self.name, "priority": self.priority,
                "deadline_frames": self.deadline_frames,
                "quantile": self.quantile}


@dataclass
class _Pending:
    """A queued sequence: a fresh submission, or a preempted live
    sequence carrying the tokens it already produced (regeneration is
    deterministic, so re-decoding continues the same stream)."""

    req: DecodeRequest
    seq: int               # submission order (FIFO tie-break)
    priority: int
    deadline_frames: int   # 0 = none
    enqueue_frame: int
    tokens: List[int] = field(default_factory=list)
    generated: int = 0
    preempted: int = 0     # times this sequence lost its slot
    # telemetry stamps carried across preemption (first values win)
    enqueue_t: Optional[float] = None
    admit_t: Optional[float] = None
    prefill_done_t: Optional[float] = None
    first_token_t: Optional[float] = None
    started_frame: Optional[int] = None


@dataclass
class _Live:
    req: DecodeRequest
    pages: List[int]
    tokens: List[int] = field(default_factory=list)  # prompt + generated
    cached: int = 0        # tokens already written into the KV cache
    generated: int = 0
    started_frame: int = 0
    priority: int = 0
    preempted: int = 0
    seq: int = 0
    deadline_frames: int = 0
    enqueue_frame: int = 0
    # request lifecycle span stamps (perf_counter seconds) — populated
    # only while the obs bus is armed (see step()'s one-check contract).
    # prefill_done_t closes the PREFILL span: the cache holds every
    # prompt token but the last, so TTFT decomposes exactly into
    # queue (enqueue→admit) + prefill (admit→prefill_done) +
    # first decode frame (prefill_done→first_token).
    enqueue_t: Optional[float] = None
    admit_t: Optional[float] = None
    prefill_done_t: Optional[float] = None
    first_token_t: Optional[float] = None


class PageAllocator:
    """Free-list page allocator over the decode graph's pool, with
    copy-on-write refcounts and a radix prefix trie.

    Every in-use page carries a refcount (``alloc`` starts it at 1;
    ``share`` lets a second sequence claim it; ``free`` decrements and
    returns the page to the free list only at zero).  The trie maps
    token-id prefixes — at page granularity — to the page caching that
    prefix's K/V, published by ``register_prefix`` as sequences fill
    pages and consulted by ``lookup_prefix`` at admission.  Sharing a
    cached page is sound because a causal decoder's K/V at position i
    is a deterministic function of tokens[:i+1] alone.

    The residency contract is **reserve-on-divergence**: callers must
    arrange (CoW at admission) that every page at or after a
    sequence's first write position is private — checked by
    ``assert_divergence_reserved``.  That preserves the historical
    guarantee in the new regime: an admitted sequence can always grow
    to ``max_seq_len`` unpreempted by pool pressure, because its
    writable tail is reserved up front and shared pages are read-only
    by construction."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}  # in-use page -> refcount
        # prefix trie, flattened: full-prefix tuple -> page caching its
        # last page_size tokens; parent prefix -> {page: token chunk}
        # for mid-page (CoW) matches; page -> (parent, chunk) for
        # removal at refcount zero
        self._prefix: Dict[tuple, int] = {}
        self._children: Dict[tuple, Dict[int, tuple]] = {}
        self._page_key: Dict[int, tuple] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def alloc_ids(self, ids: Sequence[int]) -> Optional[List[int]]:
        """Reserve SPECIFIC page ids (the slot-aligned fast path), or
        None when any is already in use."""
        if any(p not in self._free for p in ids):
            return None
        for p in ids:
            self._free.remove(p)
            self._ref[p] = 1
        return list(ids)

    def share(self, pages: Sequence[int]) -> None:
        """Claim already-cached pages for one more sequence: each must
        be live (a sibling holds it), its refcount goes up by one, and
        ``free`` from either owner now only drops the count."""
        for p in pages:
            if self._ref.get(p, 0) < 1:
                raise ValueError(
                    f"page {p} is not live — the trie served a stale hit")
            self._ref[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            r = self._ref.get(p, 0)
            if r < 1:
                raise ValueError(f"page {p} is not in use")
            if r > 1:
                self._ref[p] = r - 1
            else:
                del self._ref[p]
                self._drop_prefix(p)
                self._free.append(p)

    # ---- prefix trie -----------------------------------------------------
    def register_prefix(self, tokens: Sequence[int], page_size: int,
                        pages: Sequence[int], cached: int) -> None:
        """Publish every FULLY-cached page of a sequence (the first
        ``cached`` tokens of ``tokens`` live in ``pages``) into the
        trie.  First registration of a prefix wins; already-published
        pages are skipped, so calling this at every page boundary is
        idempotent and O(full pages)."""
        for j in range(cached // page_size):
            p = pages[j]
            if p in self._page_key:
                continue  # this page already backs a trie entry
            parent = tuple(tokens[:j * page_size])
            chunk = tuple(tokens[j * page_size:(j + 1) * page_size])
            if parent + chunk in self._prefix:
                continue  # a sibling's page already owns this prefix
            self._prefix[parent + chunk] = p
            self._children.setdefault(parent, {})[p] = chunk
            self._page_key[p] = (parent, chunk)

    def lookup_prefix(self, tokens: Sequence[int], page_size: int):
        """Longest cached prefix of ``tokens``: returns
        ``(pages, matched, partial)`` — the fully-matching cached pages
        (claim them via ``share``), the token count they cover, and,
        when a further cached page agrees on ``extra`` more tokens
        mid-page, ``partial = (src_page, extra)`` for the caller to
        copy-on-write.  Pure lookup: claims nothing."""
        tokens = tuple(tokens)
        pages: List[int] = []
        k = 0
        while (k + 1) * page_size <= len(tokens):
            p = self._prefix.get(tokens[:(k + 1) * page_size])
            if p is None:
                break
            pages.append(p)
            k += 1
        matched = k * page_size
        partial = None
        rest = tokens[matched:]
        if rest:
            best_m, best_p = 0, None
            for p, chunk in self._children.get(tokens[:matched],
                                               {}).items():
                m = 0
                for a, b in zip(chunk, rest):
                    if a != b:
                        break
                    m += 1
                if m > best_m:
                    best_m, best_p = m, p
            if best_m:
                partial = (best_p, best_m)
        return pages, matched, partial

    def assert_divergence_reserved(self, pages: Sequence[int],
                                   first_write_page: int) -> None:
        """The reserve-on-divergence invariant, checked at admission:
        every page at or after the first page this sequence will write
        must be PRIVATE (refcount exactly 1) — shared pages are
        read-only, so post-admission writes can never need an
        in-flight CoW and the sequence's growth to ``max_seq_len`` is
        reserved up front."""
        for j in range(first_write_page, len(pages)):
            if self._ref.get(pages[j], 0) != 1:
                raise RuntimeError(
                    f"page {pages[j]} (allotment index {j}) is shared at "
                    f"refcount {self._ref.get(pages[j], 0)} but lies at "
                    f"or after the sequence's first write page "
                    f"{first_write_page} — reserve-on-divergence "
                    f"violated")

    def _drop_prefix(self, page: int) -> None:
        """Remove a page's trie entry when its refcount hits zero —
        the bytes are about to be reused, so the prefix is no longer
        cached anywhere."""
        key = self._page_key.pop(page, None)
        if key is None:
            return
        parent, chunk = key
        if self._prefix.get(parent + chunk) == page:
            del self._prefix[parent + chunk]
        kids = self._children.get(parent)
        if kids is not None:
            kids.pop(page, None)
            if not kids:
                del self._children[parent]


class ContinuousBatchingExecutor:
    """Admit ragged requests into fixed decode frames and drive the
    step function until every request completes."""

    def __init__(self, step_fn: Callable, *, max_seqs: int,
                 page_size: int, pages_per_seq: int, num_pages: int = 0,
                 predicted_step_s: Optional[float] = None,
                 prefill_fn: Optional[Callable] = None,
                 prefill_chunk: int = 0,
                 slo_classes: Optional[Sequence[SLOClass]] = None,
                 replica_label: Optional[str] = None,
                 prefix_sharing: bool = False,
                 copy_page_fn: Optional[Callable] = None):
        self.step_fn = step_fn
        # fleet membership (runtime/fleet.py): when set, the request
        # histograms are ALSO observed under `name|replica=...,slo=...`
        # labeled series so the metrics can tell fleet members apart
        self.replica_label = replica_label
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        # chunked prefill lane (runtime/prefill.py): when armed, a
        # prompt's first len-1 tokens are written into the cache in
        # ceil((len-1)/chunk) batched passes at admission instead of
        # one decode frame each; None keeps the historical
        # prefill-via-decode path byte-identical
        self.prefill_fn = prefill_fn
        self.prefill_chunk = int(prefill_chunk or 0)
        if prefill_fn is not None and self.prefill_chunk < 1:
            raise ValueError(
                "prefill_fn needs prefill_chunk >= 1 (the chunk size "
                "the writer was built for)")
        # SLO classes: priority admission / deadline expiry / preemption
        # (empty table = single-class FIFO, the historical behavior)
        self.slo_classes: Dict[str, SLOClass] = {
            c.name: c for c in (slo_classes or ())}
        self._seq = 0  # submission counter (FIFO tie-break)
        # radix prefix sharing: admission claims trie-cached prefix
        # pages by refcount instead of allocating them, mid-page
        # divergence copies that one page via copy_page_fn (CoW at
        # admission — reserve-on-divergence, see PageAllocator), and
        # prefill starts at the first token past the claimed prefix.
        # Off keeps every historical path byte-identical.
        self.prefix_sharing = bool(prefix_sharing)
        self.copy_page_fn = copy_page_fn
        self.allocator = PageAllocator(num_pages or max_seqs * pages_per_seq)
        # slot-aligned allocation: when the pool covers every slot,
        # slot i always takes pages [i*pps, (i+1)*pps) (the reference's
        # layout, which matches its batch-split state shardings).
        # Undersized (oversubscribed) pools fall back to the free list.
        # Prefix sharing also forces the free list: a claimed page lives
        # wherever the sibling's allotment put it.
        self.slot_aligned = (
            not self.prefix_sharing
            and self.allocator.num_pages >= max_seqs * pages_per_seq)
        # idle frame rows still scatter one garbage k/v (static-shape
        # scatter — the op cannot skip rows), so they must point at a
        # page no LIVE sequence can own.  Slot-aligned pools use the
        # idle slot's OWN range (free by construction while the slot is
        # idle; a later admission rewrites every position before
        # reading it).  Oversubscribed pools RESERVE one scratch page
        # up front — one page of capacity is the price of a pool that
        # can otherwise be fully exhausted while slots sit idle (the
        # free-list fallback of picking "some free page" corrupts live
        # cache exactly then).
        if not self.slot_aligned and getattr(step_fn, "split_pages", False):
            raise ValueError(
                "this executor allots pages from its free list (prefix "
                "sharing, or a pool of another size), which a step over "
                "pools split over the batch axes cannot serve: build it "
                "with compiled_decode_step(..., slot_aligned=False)")
        self._scratch_page = None
        if not self.slot_aligned:
            got = self.allocator.alloc(1)
            if not got:
                raise ValueError(
                    "page pool too small to reserve the scratch page")
            self._scratch_page = got[0]
        # the search's predicted (p99) decode-step seconds, when the
        # caller has one — recorded per frame so drift is computable
        self.predicted_step_s = predicted_step_s
        self.slots: List[Optional[_Live]] = [None] * max_seqs
        self.queue: List[_Pending] = []
        self.finished: Dict[str, List[int]] = {}
        self.expired: Dict[str, List[int]] = {}  # deadline-missed rids
        self.frame = 0
        self.frame_seconds: List[float] = []
        self.total_admitted = 0
        self.total_evicted = 0
        self.total_expired = 0
        self.total_preempted = 0
        self.prefill_chunks = 0  # chunked-prefill passes run
        self.prefill_tokens = 0  # prompt tokens written by the lane
        # prefix-sharing roll-up (all zero while sharing is off)
        self.prefix_hits = 0     # admissions that claimed a cached prefix
        self.shared_pages = 0    # pages claimed by refcount, cumulative
        self.cow_copies = 0      # mid-page divergences copied at admission
        self.prefix_tokens = 0   # prompt tokens served from shared cache
        # per-request lifecycle telemetry (enqueue→admit→prefill→first
        # token→EOS/evict spans; TTFT/TPOT/e2e + the TTFT split),
        # recorded only while the obs bus is armed — the hot path
        # checks BUS.enabled ONCE per frame (and once per submit
        # batch) and skips every stamp when it is off
        self.request_records: List[dict] = []

    # ------------------------------------------------------------------
    def submit(self, requests: Sequence[DecodeRequest]) -> None:
        obs = BUS.enabled  # one check per submit batch
        tr = TRACER.enabled  # ditto — the request-trace gate
        cap = self.page_size * self.pages_per_seq
        for r in requests:
            if not r.prompt:
                raise ValueError(f"request {r.rid!r} has an empty prompt")
            need = len(r.prompt) + r.max_new_tokens
            if need > cap:
                raise ValueError(
                    f"request {r.rid!r} wants {need} tokens but a sequence "
                    f"caps at {cap} (page_size x pages_per_seq)")
            cls = self.slo_classes.get(r.slo)
            entry = _Pending(
                req=r, seq=self._seq,
                priority=(r.priority if r.priority is not None
                          else (cls.priority if cls else 0)),
                deadline_frames=(
                    r.deadline_frames if r.deadline_frames is not None
                    else (cls.deadline_frames if cls else 0)),
                enqueue_frame=self.frame,
                tokens=list(r.prompt),
            )
            self._seq += 1
            # one clock read starts the request's e2e, its trace and its
            # queue span, so the phase spans sum to e2e exactly
            t = time.perf_counter() if (obs or tr) else None
            if obs:
                entry.enqueue_t = t
            if tr:
                # trace minted at enqueue (idempotent); the queue span
                # runs enqueue -> admission
                tid = TRACER.request_root(r.rid, at=t, slo=r.slo)
                TRACER.begin(tid, "queue", parent="request", at=t)
            self.queue.append(entry)

    def _expire(self, obs: bool = False, tr: bool = False) -> int:
        """Drop queued requests whose admission deadline passed —
        deadline-based admission control: a request the deployment can
        no longer serve inside its SLO is refused loudly (recorded in
        ``expired``, one ``decode.request`` phase="expired" event),
        never served late."""
        expired = 0
        kept = []
        for e in self.queue:
            if (e.deadline_frames
                    and self.frame - e.enqueue_frame > e.deadline_frames):
                self.expired[e.req.rid] = e.tokens[len(e.req.prompt):]
                expired += 1
                if obs:
                    rec = {"rid": e.req.rid, "phase": "expired",
                           "slo": e.req.slo,
                           "queued_frames": self.frame - e.enqueue_frame,
                           "deadline_frames": e.deadline_frames}
                    self.request_records.append(rec)
                    BUS.emit("decode.request", **rec)
                if tr:
                    tid = TRACER.trace_of(e.req.rid)
                    if tid is not None:
                        TRACER.end(tid, "queue", expired=True)
                        TRACER.finish_request(e.req.rid,
                                              outcome="expired")
            else:
                kept.append(e)
        self.queue = kept
        self.total_expired += expired
        return expired

    def _preempt_for(self, entry: _Pending, obs: bool,
                     tr: bool = False) -> bool:
        """Free a slot + pages for a strictly-higher-priority pending
        request by evicting the LOWEST-priority live sequence
        (latest-admitted tie-break).  The victim re-queues with its
        tokens so far — regeneration is deterministic, so its stream
        continues unchanged after re-admission."""
        victims = [
            (live.priority, -live.started_frame, -i, i)
            for i, live in enumerate(self.slots)
            if live is not None and live.priority < entry.priority
        ]
        if not victims:
            return False
        _, _, _, i = min(victims)
        live = self.slots[i]
        self.allocator.free(live.pages)
        self.slots[i] = None
        self.total_preempted += 1
        back = _Pending(
            req=live.req, seq=live.seq, priority=live.priority,
            deadline_frames=live.deadline_frames,
            enqueue_frame=live.enqueue_frame,
            tokens=list(live.tokens), generated=live.generated,
            preempted=live.preempted + 1,
            enqueue_t=live.enqueue_t, admit_t=live.admit_t,
            prefill_done_t=live.prefill_done_t,
            first_token_t=live.first_token_t,
            started_frame=live.started_frame,
        )
        self.queue.append(back)
        if obs:
            BUS.emit("decode.request", rid=live.req.rid,
                     phase="preempted", slo=live.req.slo,
                     by=entry.req.rid, tokens=live.generated)
        if tr:
            tid = TRACER.trace_of(live.req.rid)
            if tid is not None:
                # the victim was mid-decode or (via-decode path)
                # mid-prefill; either way its residency window closes
                # and a fresh queue span opens — the re-queue edge, at
                # one clock read
                t = time.perf_counter()
                TRACER.end_any(tid, ("decode", "prefill"), at=t,
                               preempted_by=entry.req.rid)
                TRACER.begin(tid, "queue", parent="request", at=t,
                             requeue=True)
        return True

    def _run_prefill(self, live: _Live, obs: bool,
                     tr: bool = False) -> None:
        """The chunked prefill lane: write the sequence's first
        ``len(tokens) - 1`` cached-to-be tokens through the batched
        chunk writer (``run_chunked_prefill``, runtime/prefill.py), so
        the decode loop starts at the LAST token and produces the first
        generated token in its first frame.  Under prefix sharing the
        first ``live.cached`` tokens are already in claimed/copied
        pages — the writer starts at the first divergent token."""
        n_pre = len(live.tokens) - 1
        start = live.cached  # shared-prefix skip-ahead (0 off-sharing)
        if n_pre - start <= 0 or self.prefill_fn is None:
            return
        from flexflow_tpu_torch.runtime.prefill import run_chunked_prefill

        with annotate.phase_span(annotate.PREFILL_PHASE):
            chunks = run_chunked_prefill(
                self.prefill_fn, live.tokens, live.pages,
                chunk=self.prefill_chunk,
                cap=self.page_size * self.pages_per_seq,
                start=start,
                trace_id=TRACER.trace_of(live.req.rid) if tr else None)
        live.cached = n_pre
        self.prefill_chunks += chunks
        self.prefill_tokens += n_pre - start
        if obs:
            BUS.emit("decode.prefill", rid=live.req.rid,
                     tokens=n_pre - start,
                     chunks=chunks, chunk=self.prefill_chunk)

    def _admit(self, obs: bool = False, tr: bool = False) -> int:
        """Fill open slots from the queue in (priority, submission)
        order while the allocator can reserve a FULL per-sequence
        allotment; expired requests are refused first, and a
        strictly-higher-priority arrival may preempt the
        lowest-priority live sequence when no allotment is free."""
        self._expire(obs, tr)
        admitted = 0
        while self.queue:
            order = sorted(range(len(self.queue)),
                           key=lambda j: (-self.queue[j].priority,
                                          self.queue[j].seq))
            entry = self.queue[order[0]]
            open_slots = [i for i in range(self.max_seqs)
                          if self.slots[i] is None]
            if not open_slots and not self._preempt_for(entry, obs, tr):
                break
            open_slots = [i for i in range(self.max_seqs)
                          if self.slots[i] is None]
            i = open_slots[0]
            # prefix-sharing claim: the trie lookup runs INSIDE the
            # preempt-retry loop because a preemption below may free a
            # matched page to refcount zero (stale hit otherwise).
            # Only the to-be-cached prefix (all but the last token) is
            # eligible — the last token is fed through decode, and its
            # scatter must land in a page this sequence owns.
            shared: List[int] = []
            matched = 0
            partial = None
            if self.prefix_sharing:
                shared, matched, partial = self.allocator.lookup_prefix(
                    entry.tokens[:-1], self.page_size)
                if partial is not None and self.copy_page_fn is None:
                    partial = None  # cannot CoW without a page copier
            if self.slot_aligned:
                pages = self.allocator.alloc_ids(range(
                    i * self.pages_per_seq, (i + 1) * self.pages_per_seq))
            else:
                pages = self.allocator.alloc(
                    self.pages_per_seq - len(shared))
            if pages is None:
                if not self._preempt_for(entry, obs, tr):
                    break
                continue  # retry with the freed allotment
            if shared:
                self.allocator.share(shared)
                pages = shared + pages
            if partial is not None:
                # mid-page divergence: duplicate the one agreeing page
                # into the first fresh page NOW (CoW at admission), so
                # every post-admission write lands in owned pages
                src, extra = partial
                dst = pages[len(shared)]
                self.copy_page_fn(src, dst)
                matched += extra
                self.cow_copies += 1
                if obs:
                    BUS.emit("decode.cow", rid=entry.req.rid,
                             src_page=src, dst_page=dst, tokens=extra)
            if matched:
                self.prefix_hits += 1
                self.shared_pages += len(shared)
                self.prefix_tokens += matched
                if obs:
                    BUS.emit("decode.prefix_hit", rid=entry.req.rid,
                             pages=len(shared), tokens=matched)
            if self.prefix_sharing:
                self.allocator.assert_divergence_reserved(
                    pages, matched // self.page_size)
            self.queue.pop(order[0])
            live = _Live(req=entry.req, pages=pages,
                         tokens=list(entry.tokens), cached=matched,
                         generated=entry.generated,
                         started_frame=(entry.started_frame
                                        if entry.started_frame is not None
                                        else self.frame),
                         priority=entry.priority,
                         preempted=entry.preempted, seq=entry.seq,
                         deadline_frames=entry.deadline_frames,
                         enqueue_frame=entry.enqueue_frame)
            t = time.perf_counter() if (obs or tr) else None
            if obs:
                live.enqueue_t = entry.enqueue_t
                live.admit_t = entry.admit_t or t
                live.prefill_done_t = entry.prefill_done_t
                live.first_token_t = entry.first_token_t
            tid = TRACER.trace_of(entry.req.rid) if tr else None
            if tid is not None:
                # admission edge: the queue window closes, the prefill
                # window opens (chunk children land under it);
                # cached_prefix records how many prompt tokens the
                # shared cache already held — the span's duration is
                # the cost of the REMAINING tokens only
                TRACER.end(tid, "queue", at=t)
                TRACER.begin(tid, "prefill", parent="request", at=t,
                             slot=i, pages=len(pages),
                             cached_prefix=matched)
            self._run_prefill(live, obs, tr)
            t = time.perf_counter() if (obs or tr) else None
            if self.prefix_sharing and live.cached:
                # publish this sequence's fully-cached pages (claimed
                # ones are already in the trie and skip out)
                self.allocator.register_prefix(
                    live.tokens, self.page_size, live.pages, live.cached)
            if obs and live.prefill_done_t is None:
                # the prefill span closes here for the chunked lane,
                # for single-token prompts, and for prompts fully
                # served from a shared prefix (nothing left to
                # prefill); the via-decode path closes it in step()
                # when the cache holds every prompt token but the last
                if (self.prefill_fn is not None or len(live.tokens) <= 1
                        or live.cached >= len(live.tokens) - 1):
                    live.prefill_done_t = t
            if tid is not None and (self.prefill_fn is not None
                                    or len(live.tokens) <= 1
                                    or live.cached >= len(live.tokens) - 1):
                # same edge for the span tree: prefill closes, the
                # decode residency window opens (the via-decode path
                # closes prefill in step() instead)
                if TRACER.end(tid, "prefill", at=t) is not None:
                    TRACER.begin(tid, "decode", parent="request", at=t)
            self.slots[i] = live
            admitted += 1
        self.total_admitted += admitted
        return admitted

    def _evict(self, obs: bool = False, tr: bool = False) -> int:
        """Free finished sequences' pages and reopen their slots."""
        evicted = 0
        # one clock read ends every finished request's e2e and its
        # decode span
        now = time.perf_counter() if (obs or tr) else None
        for i, live in enumerate(self.slots):
            if live is None:
                continue
            done_gen = live.generated >= live.req.max_new_tokens
            eos = (live.req.eos_id is not None and live.generated > 0
                   and live.tokens[-1] == live.req.eos_id)
            if done_gen or eos:
                self.finished[live.req.rid] = live.tokens[len(live.req.prompt):]
                self.allocator.free(live.pages)
                self.slots[i] = None
                evicted += 1
                if obs:
                    self._record_request(live, now)
                if tr:
                    tid = TRACER.trace_of(live.req.rid)
                    if tid is not None:
                        TRACER.end(tid, "decode", at=now, eos=eos,
                                   tokens=live.generated)
                        TRACER.finish_request(
                            live.req.rid, outcome="finish",
                            tokens=live.generated,
                            preempted=live.preempted)
        self.total_evicted += evicted
        return evicted

    def _record_request(self, live: _Live, now: float) -> None:
        """Close a finished request's lifecycle span: queue wait
        (enqueue→admit), TTFT (enqueue→first generated token), TPOT
        (steady per-token after the first), e2e — observed into the
        metrics registry histograms and emitted as one
        ``decode.request`` event.  Called only when the bus was armed
        at eviction time (the caller's one-check-per-frame gate)."""
        from flexflow_tpu_torch.obs.metrics import METRICS

        enq, adm, first = live.enqueue_t, live.admit_t, live.first_token_t
        pre = live.prefill_done_t
        queue_s = (adm - enq) if (enq is not None and adm is not None) \
            else None
        ttft_s = (first - enq) if (enq is not None and first is not None) \
            else None
        # the TTFT split: queue + prefill + first decode frame sum to
        # TTFT exactly (prefill_done closes when the cache holds every
        # prompt token but the last — chunked lane or via-decode alike)
        prefill_s = (pre - adm) if (adm is not None and pre is not None) \
            else None
        first_frame_s = (first - pre) \
            if (pre is not None and first is not None) else None
        e2e_s = (now - enq) if enq is not None else None
        tpot_s = None
        if first is not None and live.generated > 1:
            tpot_s = (now - first) / (live.generated - 1)
        rec = {
            "rid": live.req.rid,
            "phase": "finish",
            "slo": live.req.slo,
            "queue_s": queue_s,
            "prefill_s": prefill_s,
            "first_frame_s": first_frame_s,
            "ttft_s": ttft_s,
            "tpot_s": tpot_s,
            "e2e_s": e2e_s,
            "tokens": live.generated,
            "frames": self.frame - live.started_frame + 1,
            "preempted": live.preempted,
        }
        self.request_records.append(rec)
        # the global aggregates, and the request-latency histograms ALSO
        # per (replica, SLO class), the reference's labeled series.  Same
        # obs gate as the flat series — no new BUS.enabled reads.
        slo = live.req.slo or "standard"
        lab = (f"slo={slo}" if self.replica_label is None
               else f"replica={self.replica_label},slo={slo}")
        labeled = ("decode.queue_s", "decode.ttft_s", "decode.tpot_s",
                   "decode.e2e_s")
        for key, v in (("decode.queue_s", queue_s),
                       ("decode.prefill_s", prefill_s),
                       ("decode.first_frame_s", first_frame_s),
                       ("decode.ttft_s", ttft_s),
                       ("decode.tpot_s", tpot_s),
                       ("decode.e2e_s", e2e_s)):
            if v is not None:
                METRICS.histogram(key).observe(v)
                if key in labeled:
                    METRICS.histogram(f"{key}|{lab}").observe(v)
        BUS.emit("decode.request", **rec)

    # ------------------------------------------------------------------
    def _compose_frame(self):
        """The fixed-shape frame arrays for the CURRENT step: every
        live slot contributes its next uncached token (a prompt token
        still being prefilled, or the last generated token); idle slots
        carry token 0 at length 0, their table rows on pages no live
        sequence reads."""
        b = self.max_seqs
        ids = np.zeros((b, 1), np.int32)
        table = np.zeros((b, self.pages_per_seq), np.int32)
        lens = np.zeros((b,), np.int32)
        active = []
        for i, live in enumerate(self.slots):
            if live is None:
                # idle row: its scatter must land where no live
                # sequence reads (see __init__ — own slot range when
                # slot-aligned, the reserved scratch page otherwise)
                if self.slot_aligned:
                    table[i, :] = np.arange(
                        i * self.pages_per_seq,
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
        """One decode frame: admit, compose, run, harvest, evict.
        Returns the frame record (also emitted as ``decode.frame``).
        The request-span instrumentation costs exactly this one
        ``BUS.enabled`` read per frame when telemetry is off
        (test-enforced)."""
        obs = BUS.enabled  # ONE check per frame gates every span stamp
        tr = TRACER.enabled  # ditto for the request span tree
        admitted = self._admit(obs, tr)
        ids, table, lens, active = self._compose_frame()
        t0 = time.perf_counter()
        with annotate.phase_span(annotate.DECODE_PHASE):
            logits = self.step_fn(ids, table, lens)
            # argmax on the device: only the [B] token ids cross to the
            # host (the copy waits for the frame)
            next_tokens = logits[:, 0].argmax(dim=-1).cpu().numpy()
        dt = time.perf_counter() - t0
        self.frame_seconds.append(dt)
        now = time.perf_counter() if (obs or tr) else 0.0
        for i in active:
            live = self.slots[i]
            live.cached += 1
            if (self.prefix_sharing
                    and live.cached % self.page_size == 0):
                # a page just filled — publish it so later admissions
                # can claim it (generated tokens included: the stream
                # is deterministic, so equal prefixes mean equal K/V)
                self.allocator.register_prefix(
                    live.tokens, self.page_size, live.pages, live.cached)
            if live.cached < len(live.tokens):
                # still prefilling via decode: the next prompt token is
                # queued.  The prefill span closes when only the LAST
                # prompt token remains (the frame that feeds it is the
                # first decode frame — it produces the first token).
                if live.cached >= len(live.tokens) - 1:
                    if obs and live.prefill_done_t is None:
                        live.prefill_done_t = now
                    if tr:
                        tid = TRACER.trace_of(live.req.rid)
                        if tid is not None and TRACER.end(
                                tid, "prefill", at=now) is not None:
                            TRACER.begin(tid, "decode", at=now,
                                         parent="request")
                continue
            # the model's prediction extends the sequence
            live.tokens.append(int(next_tokens[i]))
            live.generated += 1
            if obs and live.first_token_t is None:
                live.first_token_t = now  # TTFT closes here
        evicted = self._evict(obs, tr)
        rec = {
            "frame": self.frame,
            "active": len(active),
            "admitted": admitted,
            "evicted": evicted,
            "pages_in_use": self.allocator.pages_in_use,
            "queued": len(self.queue),
            "measured_s": dt,
            "predicted_s": self.predicted_step_s,
        }
        if obs:
            from flexflow_tpu_torch.obs.metrics import METRICS

            METRICS.histogram("decode.frame_s").observe(dt)
            BUS.emit("decode.frame", **rec)
        self.frame += 1
        return rec

    def run(self, requests: Sequence[DecodeRequest] = (),
            max_frames: int = 10_000) -> Dict[str, List[int]]:
        """Drive frames until every submitted request finished (or the
        frame cap trips — a stuck executor must fail loud, not spin).
        Returns rid -> generated token ids."""
        if requests:
            self.submit(requests)
        while (self.queue or any(s is not None for s in self.slots)):
            if self.frame >= max_frames:
                raise RuntimeError(
                    f"decode executor exceeded {max_frames} frames with "
                    f"{len(self.queue)} queued and "
                    f"{sum(s is not None for s in self.slots)} live")
            self.step()
        if BUS.enabled:
            BUS.emit("decode.summary", **self.summary())
        return dict(self.finished)

    # ------------------------------------------------------------------
    @staticmethod
    def _quantile(values, f: float):
        if not values:
            return None
        s = sorted(values)
        return s[min(len(s) - 1, int(f * (len(s) - 1)))]

    def measured_p99(self, window: int = 0) -> Optional[float]:
        """p99 of the measured frame latencies — over the trailing
        ``window`` frames when given (the CONTINUOUS drift signal a
        long-running server feeds the controller), else the whole
        run."""
        times = self.frame_seconds[-window:] if window \
            else self.frame_seconds
        return self._quantile(times, 0.99)

    def measured_request_p99(self, metric: str = "ttft_s",
                             slo: Optional[str] = None,
                             window: int = 0) -> Optional[float]:
        """p99 of a per-request latency metric (``ttft_s``/``tpot_s``/
        ``e2e_s``/``queue_s``), optionally restricted to one SLO class
        (at that class's quantile) and to the trailing ``window``
        completions."""
        recs = [r for r in self.request_records
                if r.get("phase") == "finish"
                and (slo is None or r.get("slo") == slo)
                and r.get(metric) is not None]
        if window:
            recs = recs[-window:]
        cls = self.slo_classes.get(slo) if slo else None
        return self._quantile([r[metric] for r in recs],
                              cls.quantile if cls else 0.99)

    def summary(self) -> dict:
        q = lambda f: self._quantile(self.frame_seconds, f)  # noqa: E731
        out = {
            "frames": self.frame,
            "completed": len(self.finished),
            "admitted": self.total_admitted,
            "evicted": self.total_evicted,
            "expired": self.total_expired,
            "preempted": self.total_preempted,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "measured_p50_s": q(0.5),
            "measured_p99_s": q(0.99),
            "predicted_step_s": self.predicted_step_s,
        }
        if self.prefix_sharing:
            # prefix-sharing roll-up (keys appear only when the mode is
            # armed, keeping historical summaries byte-identical):
            # cumulative hits/claims/copies plus the private-page
            # complement so ffobs can render shared vs private
            out["prefix_hits"] = self.prefix_hits
            out["shared_pages"] = self.shared_pages
            out["private_pages"] = (
                self.total_admitted * self.pages_per_seq
                - self.shared_pages)
            out["cow_copies"] = self.cow_copies
            out["prefix_tokens"] = self.prefix_tokens
        recs = [r for r in self.request_records
                if r.get("phase") == "finish"]
        if recs:
            # request-level currency (recorded while the bus was
            # armed): TTFT / TPOT / e2e percentiles across completions,
            # with TTFT split into its queue + prefill + first-frame
            # components so the prompt path's cost is attributable per
            # phase
            for key in ("ttft_s", "tpot_s", "e2e_s", "queue_s",
                        "prefill_s", "first_frame_s"):
                vals = [r[key] for r in recs if r.get(key) is not None]
                out[f"{key[:-2]}_p50_s"] = self._quantile(vals, 0.5)
                out[f"{key[:-2]}_p99_s"] = self._quantile(vals, 0.99)
            out["requests_recorded"] = len(recs)
            by_class: Dict[str, list] = {}
            for r in recs:
                by_class.setdefault(r.get("slo", "standard"),
                                    []).append(r)
            if self.slo_classes or len(by_class) > 1:
                out["slo_classes"] = {
                    name: {
                        "completed": len(rs),
                        "ttft_p99_s": self._quantile(
                            [r["ttft_s"] for r in rs
                             if r.get("ttft_s") is not None], 0.99),
                        "e2e_p99_s": self._quantile(
                            [r["e2e_s"] for r in rs
                             if r.get("e2e_s") is not None], 0.99),
                    }
                    for name, rs in sorted(by_class.items())
                }
        return out

    def decode_drift_report(self, threshold: float = 0.5,
                            window: int = 0):
        """Predicted-vs-measured DECODE drift: ``predicted_step_s``
        against the measured frame-latency p99 (obs/drift.py's
        DriftReport); ``window`` restricts the measured side to the
        trailing frames.  None when either side is missing.  Emitted as
        a ``drift.report`` event when the bus is armed."""
        from flexflow_tpu_torch.obs.drift import build_drift_report

        measured = self.measured_p99(window)
        if not self.predicted_step_s or not measured:
            return None
        report = build_drift_report(
            {"total_s": self.predicted_step_s},
            measured, threshold=threshold)
        if report is not None:
            report.phases["decode"] = {
                "predicted_s": self.predicted_step_s,
                "measured_s": measured,
                "ratio": report.ratio,
            }
            if BUS.enabled:
                BUS.emit("drift.report", predicted_s=report.predicted_s,
                         measured_s=report.measured_s, ratio=report.ratio,
                         stale=report.stale, phase="decode")
        return report


def compiled_decode_step(model, prefill_chunk: int = 0,
                         slot_aligned: bool = True) -> Callable:
    """A ``step_fn`` over a compiled decode model: one forward per frame,
    the KV-cache state dict threaded across calls (the pools are updated
    in place, see ops/decode_attention.py).  The frame runs as a
    compiled step (compiler/graphs.py, the reference's jitted frame,
    runtime/decode.py:1047): the frame arrays are copied into static
    ``ids [B, 1]``, ``page_table [B, P]`` and ``seq_lens [B]`` buffers
    and, on the card, a captured CUDA graph replays.  That is sound
    because every launch argument of the frame is a static shape: the
    decode kernels read lengths and tables from device tensors, so
    their split-KV grid does not change from frame to frame, and the
    pools keep their addresses.  Each call returns a copy of the
    frame's logits, on the device (``step.graph`` is the frame's
    ``StepGraph``).

    ``step.copy_page(src, dst)`` is the prefix-sharing executor's
    ``copy_page_fn``: page ``src`` of every layer's k/v pool and, under
    an int8 pool, of its scales, copied in place into page ``dst``,
    eagerly, on the stream the replays run on.
    ``prefill_chunk > 0`` also builds the chunked prefill writer over
    the same graph, params and state (runtime/prefill.py), attached as
    ``step.prefill(ids [1, C], positions [1, C], page_table [1, P])``
    for the executor's ``prefill_fn``; each pass is a compiled step
    too (``step.prefill_graph``; reference decode.py:1078).

    Over ranks (a model compiled under a strategy over several ranks)
    every rank runs the same executor on the same requests, so
    admission, eviction, preemption and the prefix trie agree on every
    rank without messages: each rank feeds its block of the frame's
    arrays (``compiled.input_slices``) and gets the frame's whole
    logits back (``gather_output``), so every rank takes the same
    argmax.  The frame and the chunk pass then run eagerly: a CUDA
    graph cannot hold gloo's host hops (capturing multi-rank steps is
    ROADMAP, work on ported paths, item 5.3).  The pools' layout is
    chosen here, once: ``slot_aligned`` says whether the executor this
    step serves allots slot-aligned pages (``ContinuousBatchingExecutor.
    slot_aligned``: no prefix sharing, a pool of ``max_seqs *
    pages_per_seq`` pages).  If it does, a pool whose page dim is split
    over the batch axes stays split (each rank its slots' pages), and a
    frame or chunk pass whose table leaves its rank's range raises, as
    does ``copy_page``; if not, the step gathers such pools whole on
    every rank of the batch axes into its own state (the free-list
    allotment, ops/decode_attention.py; ``model.state`` keeps the
    lowering's layout).  ``step.split_pages`` says which, and the
    executor refuses a split step it would feed free-list pages.
    ``copy_page`` and the chunk pass write this rank's copy of each
    pool."""
    from flexflow_tpu_torch.compiler.graphs import StepGraph

    compiled = model.compiled
    device = compiled.device
    box = {"state": model.state}
    frame_graph = StepGraph(device)
    multi = compiled.mesh.world > 1
    blocks = compiled.page_blocks() if multi else None
    if blocks is not None and not slot_aligned:
        box["state"] = compiled.whole_page_pools(model.state)
        blocks = None

    def int32(*arrays):
        return [np.asarray(a, np.int32) for a in arrays]

    def bound():
        return [t for ws in model.params.values() for t in ws.values()] + \
            list(box["state"].values())

    def frame(ids, page_table, seq_lens):
        logits, box["state"] = compiled.apply(
            model.params, box["state"], [ids, page_table, seq_lens])
        return logits

    def shards(arrays):
        """This rank's blocks of the frame's whole arrays, on the
        device."""
        return [torch.from_numpy(np.ascontiguousarray(
            a[compiled.input_slices(i, a.shape)])).to(device)
            for i, a in enumerate(arrays)]

    def in_range(table, rows=None) -> None:
        """Under split pools, raise unless ``table``'s rows (frame rows
        ``rows``, or one sequence's when None) address only pages of
        the rank that runs them."""
        if blocks is None:
            return
        pages, slots = blocks
        owner = table // pages
        want = owner[:, :1] if rows is None else (rows // slots)[:, None]
        if not (owner == want).all():
            raise ValueError(
                "a page table addresses pages outside its rank's range of "
                "a pool split over the batch axes: build the step with "
                "compiled_decode_step(..., slot_aligned=False) for an "
                "executor that allots pages from its free list")

    def step(ids, page_table, seq_lens):
        arrays = int32(ids, page_table, seq_lens)
        if multi:
            in_range(arrays[1], np.arange(len(arrays[1])))
            return compiled.gather_output(frame(*shards(arrays)))
        return frame_graph(frame, arrays, bound()).clone()

    step.state = box  # tests inspect the threaded cache
    step.graph = frame_graph
    step.compiled = compiled
    step.split_pages = blocks is not None

    def copy_page(src: int, dst: int) -> None:
        if blocks is not None:
            raise ValueError("copy_page on pools split over the batch "
                             "axes: build the step with "
                             "compiled_decode_step(..., slot_aligned=False)")
        for key, val in box["state"].items():
            if key.rsplit("/", 1)[-1] in ("k_cache", "v_cache", "k_scale",
                                          "v_scale"):
                val[dst].copy_(val[src])

    step.copy_page = copy_page
    if prefill_chunk:
        from flexflow_tpu_torch.runtime.prefill import build_chunk_forward

        pf = build_chunk_forward(model.graph, compiled.compute_dtype,
                                 device, compiled)
        chunk_graph = StepGraph(device)

        def chunk(ids, positions, page_table):
            box["state"] = pf(model.params, box["state"], ids, positions,
                              page_table)
            return ()

        def prefill(ids, positions, page_table):
            arrays = int32(ids, positions, page_table)
            if multi:
                in_range(arrays[2])
                chunk(*(torch.from_numpy(a).to(device) for a in arrays))
                return
            chunk_graph(chunk, arrays, bound())

        step.prefill = prefill
        step.prefill_graph = chunk_graph
    return step
