"""Analytic cost model — a copy of flexflow_tpu/search/machine_model.py.

Replaces the reference's measured-kernel + bandwidth-table stack
(reference: src/runtime/machine_model.cc:57-68 SimpleMachineModel,
src/runtime/simulator.cc:515-787 measure_operator_cost /
estimate_xfer_cost) with a roofline model parameterized by MachineSpec:

* compute: max(FLOPs/MXU-peak, bytes/HBM-bw) per shard — correct
  first-order model for XLA-fused TPU programs, where the reference's
  per-op cuda-event timing has no analogue (ops fuse; SURVEY.md §7
  hard part (a)).  An optional on-device probe refines hot ops.
* collectives: ring formulas over ICI (bandwidth-optimal on a torus):
  allreduce 2(n-1)/n, allgather/reducescatter (n-1)/n, all_to_all
  (n-1)/n² per direction; DCN terms added when a collective spans
  ICI domains (hosts on CPU machines, slices on multislice TPU).

Whether a collective crosses DCN depends on WHICH mesh axes it rides,
not just its size: the lowering's deterministic axis assignment
(parallel/mesh.py view_slot_axes) gives the first (outermost, strided)
pool axes to the first view slots, and jax device ordering keeps an
ICI domain's devices contiguous — so an outer-axis group of size 2 on
a 2-slice machine crosses DCN while an inner-axis group of size
devices_per_host does not.  The cost model replays that assignment
(``_slot_axes``) so DP-across-slices weight syncs are priced at DCN
bandwidth and within-slice TP collectives at ICI bandwidth — the
scaling-book multislice recipe.  Callers without slot context fall
back to the size heuristic (n > devices_per_host).

In the port the same model prices the H100 (``MachineSpec.h100_sxm``):
its roofline reads the card's peak and HBM rate, ``ici_*`` is NVLink
through NVSwitch, and a calibration table measured on the card with
CUDA events (search/calibration.py) replaces the forward estimate
where it has a record.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from flexflow_tpu_torch.core.machine import MachineSpec, MachineView
from flexflow_tpu_torch.core.ptensor import ParallelTensorShape
from flexflow_tpu_torch.ops.base import REPLICA_SLOT, Operator, ShardAnnot
from flexflow_tpu_torch.parallel.mesh import (
    assign_slot_axes,
    place_zero_factors,
    prime_factors,
)

# fixed per-op dispatch overhead inside one XLA program (fusion makes
# this tiny compared to the reference's per-task launch overhead)
OP_OVERHEAD_S = 2e-6


def _merge_levels(acc: Dict[str, float], split: Dict[str, float]) -> None:
    """Accumulate a per-link-level seconds split into ``acc``."""
    for name, t in split.items():
        acc[name] = acc.get(name, 0.0) + t


def _min_compress_elems() -> int:
    """comm.quantized.MIN_COMPRESS_ELEMS (the floor the execution
    shares), imported lazily: the comm module pulls in torch, which
    this pure-python cost model otherwise never needs."""
    from flexflow_tpu_torch.comm.quantized import MIN_COMPRESS_ELEMS

    return MIN_COMPRESS_ELEMS


@dataclass
class CostModel:
    machine: MachineSpec
    # optional NetworkedMachineModel: collectives are then routed over
    # the ICI torus with per-link contention (search/network.py) instead
    # of the flat ring formulas
    network: Optional[object] = None
    # optional CalibrationTable of MEASURED per-(op, view) forward
    # seconds from the real chip — consulted before the roofline
    # (reference: ProfilingRecord cache, simulator.cc:515-554)
    calibration: Optional[object] = None
    # device count the search runs against (--search-num-nodes style
    # overrides make this differ from machine.num_devices); the mesh
    # the strategies lower onto has THIS many devices, so slot→axis
    # assignment must factor it, not the spec's chip count
    num_devices: Optional[int] = None
    # execution shards optimizer state of replicated weights over their
    # replication axes (config.zero_dp_shard) — memory feasibility must
    # credit the 1/replica optimizer share or the search rejects
    # strategies that actually fit
    zero_dp_shard: bool = False
    # inference compile (reference COMP_MODE_INFERENCE): no grads, no
    # optimizer state — op_memory counts weights + activations only
    inference: bool = False
    # gradient-sync wire precision (FFConfig.sync_precision): fp32 |
    # bf16 | int8 price every weight sync at that precision (safety
    # heuristic permitting); "search" makes it a per-weight-group
    # choice — sync_cost() returns the cheapest admissible precision's
    # cost, so the DP trades e.g. TP (no sync) against DP + compressed
    # sync with honest numbers (EQuARX, arXiv:2506.17615)
    sync_precision: str = "fp32"
    # error feedback on int8 sync (FFConfig.sync_ef="auto"): int8
    # choices upgrade to "int8_ef" — same wire, plus the residual
    # add/store passes priced in _quant_overhead.  A fidelity POLICY,
    # not a cost comparison: EF costs strictly more seconds than plain
    # int8 and the currency cannot see the error it removes, so the
    # upgrade is gated here instead of argmin'd
    sync_ef: bool = False
    # serving arrival model (search/serving.py ServingSpec,
    # FFConfig.objective="serve"): ops with a `sharded_bytes_accessed`
    # hook (the paged-KV decode attention) then price their ragged
    # cache stream at the spec's p-quantile max-shard load instead of
    # full occupancy, which puts the WHOLE search — both DP engines,
    # estimates, delta sim, the floor — in the p99-latency currency.
    # None (the default) changes nothing: every existing op's pricing
    # is byte-identical
    serving: Optional[object] = None

    # ---- slice topology --------------------------------------------------
    def levels(self):
        """The link hierarchy this cost model prices against
        (``MachineSpec.topology_levels``), clamped to the SEARCH device
        count: a level whose aligned group already contains every
        searched device adds no crossing class (an 8-device search of a
        16-chip 2-slice spec runs inside one slice).  Finest first;
        a flat machine is the single-level degenerate case."""
        if not hasattr(self, "_levels_cache"):
            import dataclasses

            from flexflow_tpu_torch.core.machine import LinkLevel

            ndev = self.num_devices or self.machine.num_devices
            lv = list(self.machine.topology_levels())
            out = [lv[0]]
            for lvl in lv[1:]:
                if ndev > out[-1].span:
                    out.append(lvl)
            if ndev > out[-1].span:
                # a --search-num-nodes-style override spans more devices
                # than the spec names: the extra reach is one more DCN
                # hop class (widen the coarsest configured level, or add
                # the classic machine-wide DCN level to a flat spec)
                if len(out) == 1:
                    out.append(LinkLevel(
                        "dcn", ndev, self.machine.dcn_bandwidth,
                        self.machine.dcn_latency))
                else:
                    out[-1] = dataclasses.replace(out[-1], span=ndev)
            self._levels_cache = tuple(out)
        return self._levels_cache

    def _axis_level(self, span: int) -> int:
        """The finest level whose aligned group contains an axis group
        of aligned ``span`` (stride * size): groups along an axis live
        in ALIGNED blocks, so the group stays inside one level-i block
        iff the span both fits and DIVIDES the level's group size —
        span 3 with slice 8 crosses at the [6,9) block even though
        3 < 8.  Returns 0 for within-slice, k for a group only the
        level-k links connect."""
        levels = self.levels()
        for i, lvl in enumerate(levels):
            if span <= lvl.span and lvl.span % span == 0:
                return i
        return len(levels) - 1

    def _slot_axes(self, slot_degrees: Tuple[int, ...]):
        """Per-slot (stride, size) mesh axes under the lowering's
        canonical take-first assignment (parallel/mesh.py
        assign_slot_axes over the prime-factor pool, devices in jax
        order: axis i has stride = product of later factor sizes).
        Returns None when a degree does not factor into the pool
        (invalid view — callers fall back to the size heuristic)."""
        if not hasattr(self, "_slot_axes_cache"):
            self._slot_axes_cache = {}
        if slot_degrees in self._slot_axes_cache:
            return self._slot_axes_cache[slot_degrees]
        pool = prime_factors(self.num_devices or self.machine.num_devices)
        strides = [1] * len(pool) if pool else []
        for i in range(len(pool) - 2, -1, -1):
            strides[i] = strides[i + 1] * pool[i + 1]
        try:
            idx = assign_slot_axes(slot_degrees, pool)
            result = tuple(
                tuple((strides[j], pool[j]) for j in taken) for taken in idx
            )
        except ValueError:
            result = None
        self._slot_axes_cache[slot_degrees] = result
        return result

    @staticmethod
    def _vanished_axes(slot_axes, retained_degree: int):
        """Axes of one slot that a resharding actually moves.  The dst
        annot replays the same take-first rule, so its retained factors
        consume the first SIZE-MATCHING axes of the slot (not simply
        the first k — with mixed primes, e.g. slot degree 6 = axes
        (2, 3), a retained degree 3 keeps the size-3 axis); whatever
        is left over is what the collective rides."""
        remaining = list(slot_axes)
        for p in prime_factors(retained_degree):
            for k, (_, size) in enumerate(remaining):
                if size == p:
                    del remaining[k]
                    break
        return remaining

    def _spans_dcn(
        self, slot_degrees: Tuple[int, ...], active_slots, retained=None
    ) -> Optional[int]:
        """The deepest link LEVEL a collective riding ``active_slots``
        of a view with ``slot_degrees`` crosses (0 = stays within one
        ICI domain/slice; k = the coarsest DCN class it must traverse —
        for the classic two-level machine the truthiness matches the
        historical crosses-DCN bool).  Groups along an axis of stride s
        and size f always live in ALIGNED blocks of span s*f (inner
        axes contribute < s to the base, outer axes multiples of the
        span), so the per-axis level is ``_axis_level(s*f)`` and the
        collective pays the worst axis.  ``retained[slot]`` is the
        degree the destination keeps on that slot — its size-matched
        axes are excluded (only the vanished axes move).  None =
        assignment failed."""
        dph = self.machine.devices_per_host
        if (self.num_devices or self.machine.num_devices) <= dph:
            return 0
        axes = self._slot_axes(tuple(slot_degrees))
        if axes is None:
            return None
        retained = retained or {}
        level = 0
        for slot in active_slots:
            ax = axes[slot]
            if slot in retained:
                ax = self._vanished_axes(ax, retained[slot])
            for stride, size in ax:
                level = max(level, self._axis_level(stride * size))
        return level

    def _net_groups(self, n: int) -> Optional[list]:
        """Candidate device groups for an n-way collective on the torus.
        The cost model only knows the group SIZE, not which mesh axis it
        rides: an inner-axis group is contiguous (0..n-1), an outer-axis
        group is strided (0, N/n, 2N/n, ...) and crosses more links.  We
        cost both and take the worst — underpricing outer-axis
        communication would bias the search toward strategies whose
        collectives are not actually cheap."""
        if self.network is None or n > self.network.topology.num_nodes:
            return None
        groups = [list(range(n))]
        stride = self.network.topology.num_nodes // n
        if stride > 1:
            groups.append(list(range(0, stride * n, stride)))
        return groups

    def _net_cached(self, kind: str, n: int, nbytes: float, fn) -> float:
        """Route expansion is O(n²) for all_to_all and runs in the
        search's innermost loop — memoize by (kind, n, nbytes): with the
        canonical groups these are pure functions of the key."""
        if not hasattr(self, "_net_cache"):
            self._net_cache = {}
        key = (kind, n, nbytes)
        hit = self._net_cache.get(key)
        if hit is None:
            hit = fn()
            self._net_cache[key] = hit
        return hit

    # ---- compute ---------------------------------------------------------
    def op_cost(self, op: Operator, mv: MachineView, backward: bool = True) -> float:
        """Per-iteration compute seconds for one shard of ``op`` under
        ``mv`` (all shards run concurrently on distinct devices).
        A calibration measurement for (op, view) overrides the
        roofline forward estimate when available."""
        # ops with a per-shard bytes hook (the paged-KV decode
        # attention) own their HBM-stream sharding rule: a head split
        # genuinely divides the cache read, and an armed serving spec
        # scales it to the ragged p-quantile load.  Such ops skip the
        # calibration override when a serving spec is armed — a lone-
        # chip probe measured full occupancy, which is exactly the
        # shape the serve currency must NOT price.
        sharded_bytes = getattr(op, "sharded_bytes_accessed", None)
        fwd = None
        if self.calibration is not None and not (
                sharded_bytes is not None and self.serving is not None):
            fwd = self.calibration.get(op, mv)
        if fwd is None:
            # replica groups do REDUNDANT work: only the partition count
            # shrinks each device's share.  Dividing by num_parts (which
            # includes replica_degree) priced an R8-replicated op at 1/8
            # of its true per-device cost and made the search replicate
            # compute that execution pays in full.
            parts = max(1, mv.num_parts // max(1, mv.replica_degree))
            flops = op.flops() / parts
            if sharded_bytes is not None:
                bytes_ = sharded_bytes(mv, serving=self.serving)
            else:
                bytes_ = op.bytes_accessed() / parts
            fwd = max(
                flops / self.machine.peak_flops,
                bytes_ / self.machine.hbm_bandwidth,
            )
        t = fwd + OP_OVERHEAD_S
        if backward:
            # bwd ≈ 2x fwd FLOPs for matmul-family, ~1x for elementwise
            bwd_factor = 2.0 if op.flops() > 4 * op.output_shapes[0].num_elements else 1.0
            t += bwd_factor * fwd + OP_OVERHEAD_S
            # training also pays the optimizer's elementwise update over
            # the local weight shard (measured on the host mesh: the
            # REPLICATED lm_head update dominated DP's real loss — a
            # weight-sharded view divides this term by its shard count)
            t += self.update_cost(op, mv)
        # ops whose sharded execution runs an internal collective (ring
        # attention over a split seq dim) declare the wire bytes — a
        # calibration measurement can't see them (probes run one chip).
        # Priced via allgather(): identical neighbor-ring pattern
        # ((n-1) hops of one shard), so the NetworkedMachineModel's
        # contention routing applies when configured.
        ring = getattr(op, "ring_comm_bytes", None)
        if ring is not None:
            nbytes, n, slot = ring(mv)
            if nbytes > 0.0:
                per_hop = nbytes / max(n - 1, 1)
                spans = self._spans_dcn(
                    tuple(mv.dim_degrees) + (mv.replica_degree,), [slot]
                )
                t += (2 if backward else 1) * self.allgather(
                    per_hop, n, spans
                )
        return t

    # ---- compressed collectives (EQuARX, arXiv:2506.17615) ---------------
    # elements per int8 scale block (comm/quantized.py DEFAULT_CHUNK);
    # each chunk ships one fp32 scale alongside its int8 payload
    QUANT_CHUNK = 256
    # HBM passes per quantize/dequantize endpoint (read fp32, write
    # int8+scales, read back ≈ 3 streaming passes over the buffer)
    QUANT_PASSES = 3.0

    # extra HBM passes the error-feedback residual costs per collective:
    # read the carried residual into the addend, write the new residual
    # back — two streaming passes over the full local fp32 buffer
    EF_PASSES = 2.0

    def _wire_scale(self, precision: Optional[str]) -> float:
        """Wire bytes per fp32 byte under the sync precision
        (``int8_ef`` rides the identical int8 wire — EF changes what is
        quantized, not the payload format)."""
        if precision == "bf16":
            return 0.5
        if precision in ("int8", "int8_ef"):
            return (1.0 + 4.0 / self.QUANT_CHUNK) / 4.0
        return 1.0

    def _quant_overhead(
        self, nbytes: float, n: int, precision: Optional[str]
    ) -> float:
        """Per-device quantize/dequant seconds for one compressed
        collective: the entry quantize runs over the full local buffer,
        the mid requant (between reduce-scatter and all-gather) over
        the 1/n reduced shard.  bf16 conversion is the same streaming
        pattern at the same pass count (the VPU cast is free; the
        traffic isn't).  ``int8_ef`` additionally pays the residual
        read + write (EF_PASSES over the full buffer) — the honest
        price of threading the error-feedback state."""
        if precision in (None, "fp32") or n <= 1:
            return 0.0
        t = (
            self.QUANT_PASSES * (nbytes + nbytes / n)
            / self.machine.hbm_bandwidth
        )
        if precision == "int8_ef":
            t += self.EF_PASSES * nbytes / self.machine.hbm_bandwidth
        return t

    # ---- collectives -----------------------------------------------------
    def _crosses(self, n: int, spans_dcn: Optional[int]) -> int:
        """The deepest link level an n-way collective rides (0 = pure
        ICI).  Axis-aware when the caller resolved it (``spans_dcn``,
        the level from ``_spans_dcn`` — legacy bool True maps to the
        deepest level), size heuristic otherwise."""
        if spans_dcn is not None:
            if spans_dcn is True:  # legacy callers/tests pass a bool
                return len(self.levels()) - 1
            return int(spans_dcn)
        if n > self.machine.devices_per_host:
            return len(self.levels()) - 1
        return 0

    def _link_time(
        self, bytes_per_device: float, n: int, spans_dcn: Optional[int] = None
    ) -> Tuple[float, float]:
        """(ici seconds, cross-level seconds) for moving bytes once
        around a ring of n devices; a ring crossing level k adds one
        term per traversed DCN class 1..k (the classic two-level
        machine keeps its single historical DCN term bit-identically)."""
        ici = bytes_per_device / self.machine.ici_bandwidth
        dcn = 0.0
        crossed = self._crosses(n, spans_dcn)
        if crossed:
            levels = self.levels()
            for i in range(1, crossed + 1):
                dcn += bytes_per_device / levels[i].bandwidth
        return ici, dcn

    def _cross_time(
        self, nbytes: float, n: int, spans_dcn: Optional[int]
    ) -> float:
        """Seconds per byte-unit across the traversed DCN classes (one
        term per level 1..crossed; 0 when the collective stays on ICI).
        The DCN add-on of the network-routed collective paths."""
        crossed = self._crosses(n, spans_dcn)
        if not crossed:
            return 0.0
        t = 0.0
        levels = self.levels()
        for i in range(1, crossed + 1):
            t += nbytes / levels[i].bandwidth
        return t

    def allreduce(
        self, nbytes: float, n: int, spans_dcn: Optional[bool] = None,
        precision: Optional[str] = None,
    ) -> float:
        """``precision`` (fp32|bf16|int8, default fp32) compresses the
        wire bytes by _wire_scale and adds the per-device quantize
        overhead — the EQuARX pricing the search uses to trade sync
        precision against everything else."""
        if n <= 1:
            return 0.0
        wire = nbytes * self._wire_scale(precision)
        extra = self._quant_overhead(nbytes, n, precision)
        groups = self._net_groups(n)
        if groups is not None:
            t = self._net_cached(
                "ar", n, wire,
                lambda: max(self.network.ring_allreduce_time(g, wire)
                            for g in groups))
            t += 2.0 * (n - 1) / n * self._cross_time(wire, n, spans_dcn)
            return t + extra
        ici, dcn = self._link_time(2.0 * (n - 1) / n * wire, n, spans_dcn)
        return ici + dcn + 2 * (n - 1) * self.machine.ici_latency + extra

    def allgather(
        self, nbytes_shard: float, n: int, spans_dcn: Optional[bool] = None,
        precision: Optional[str] = None,
    ) -> float:
        if n <= 1:
            return 0.0
        wire = nbytes_shard * self._wire_scale(precision)
        groups = self._net_groups(n)
        if groups is not None:
            t = self._net_cached(
                "ag", n, wire,
                lambda: max(self.network.allgather_time(g, wire)
                            for g in groups))
            t += (n - 1) * self._cross_time(wire, n, spans_dcn)
            return t
        ici, dcn = self._link_time((n - 1) * wire, n, spans_dcn)
        return ici + dcn + (n - 1) * self.machine.ici_latency

    def reducescatter(
        self, nbytes: float, n: int, spans_dcn: Optional[bool] = None,
        precision: Optional[str] = None,
    ) -> float:
        """One compressed phase plus the quantize passes (entry over
        the full buffer, shard-side dequant) — the ZeRO-1 grad path;
        the update's all-gather is priced separately."""
        return (
            self.allgather(nbytes / max(n, 1), n, spans_dcn, precision)
            + self._quant_overhead(nbytes, n, precision)
        )

    def all_to_all(
        self, nbytes_shard: float, n: int, spans_dcn: Optional[bool] = None
    ) -> float:
        if n <= 1:
            return 0.0
        groups = self._net_groups(n)
        if groups is not None:
            t = self._net_cached(
                "a2a", n, nbytes_shard,
                lambda: max(self.network.all_to_all_time(g, nbytes_shard)
                            for g in groups))
            t += (n - 1) / n * self._cross_time(nbytes_shard, n, spans_dcn)
            return t
        # each device exchanges (n-1)/n of its shard; ICI torus is
        # dimension-ordered so add a hop-count factor ~sqrt(n)/2
        hops = max(1.0, math.sqrt(n) / 2.0)
        ici, dcn = self._link_time(nbytes_shard * (n - 1) / n * hops, n, spans_dcn)
        return ici + dcn + (n - 1) * self.machine.ici_latency

    # ---- resharding (parallel-op) cost ----------------------------------
    def xfer_cost(
        self,
        shape: ParallelTensorShape,
        src: Optional[ShardAnnot],
        dst: Optional[ShardAnnot],
    ) -> float:
        """Edge cost when producer/consumer shardings differ — the role
        of estimate_xfer_cost (reference: simulator.cc:556-731), but
        classified into the collective GSPMD will emit.  Memoized — the
        search evaluates the same (shape, src, dst) triple millions of
        times (reference caches the same way, simulator.cc:515-554)."""
        if src is None or dst is None:
            return 0.0
        if not hasattr(self, "_xfer_cache"):
            self._xfer_cache = {}
        key = (shape.num_bytes, src, dst)
        hit = self._xfer_cache.get(key)
        if hit is None:
            hit = self._xfer_cost_uncached(shape, src, dst)
            self._xfer_cache[key] = hit
        return hit

    def _xfer_cost_uncached(
        self,
        shape: ParallelTensorShape,
        src: ShardAnnot,
        dst: ShardAnnot,
    ) -> float:
        if src.degrees == dst.degrees and src.partial == dst.partial:
            # NOTE: replica-degree differences are deliberately free — in
            # GSPMD a tensor is implicitly replicated over every mesh axis
            # its spec does not use, so "replicate to r" moves no bytes
            # (the producer's unused-axis devices already hold the value);
            # redundant compute is parallel in wall-time.  All-gather cost
            # appears only on sharded->unsharded dim changes (below).
            return 0.0
        n_src = max(1, src.num_parts)
        n_dst = max(1, dst.num_parts)
        total = shape.num_bytes
        # slot degrees in the producer view's assignment order,
        # approximated by the tensor's own dim order (exact when the
        # annot's parallel_idx is the identity — the common case)
        src_slots = tuple(src.degrees) + (src.replica,)
        if src.partial:
            # partial-sum producer: reduction (+ possible reshard).
            # The psum rides the replica/contraction slot.
            spans = self._spans_dcn(src_slots, [len(src.degrees)])
            return self.allreduce(
                total / max(n_dst // src.replica, 1), src.replica, spans
            )
        shard_src = total / max(n_src // max(src.replica, 1), 1)
        shard_dst = total / max(n_dst // max(dst.replica, 1), 1)
        # every emitted reshard op materializes its result through HBM
        # (write + read) and breaks XLA producer->consumer fusion —
        # charged on top of the link bytes below.  Without this term the
        # search trades noise-level compute wins for real boundary
        # copies (measured on the host mesh: a 1.4% predicted win
        # executed 7-12% slower).
        mat = (2.0 * shard_dst / self.machine.hbm_bandwidth
               + self.machine.reshard_overhead_s)
        n = max(n_src, n_dst)
        src_deg = 1
        for d in src.degrees:
            src_deg *= d
        dst_deg = 1
        for d in dst.degrees:
            dst_deg *= d
        if dst_deg > src_deg and all(
            dd % sd == 0 for sd, dd in zip(src.degrees, dst.degrees)
        ):
            # pure refinement (repartition): slicing is local when the
            # finer sharding nests in the coarser one
            return mat + OP_OVERHEAD_S
        if dst_deg < src_deg and all(
            sd % dd == 0 for sd, dd in zip(src.degrees, dst.degrees)
        ):
            # combine: all-gather over the vanished degree — only the
            # TAIL axes of each shrinking slot move (the retained dst
            # degree keeps the slot's first-assigned axes)
            shrink = [
                i for i, (sd, dd) in enumerate(zip(src.degrees, dst.degrees))
                if sd > dd
            ]
            spans = self._spans_dcn(
                src_slots, shrink, {i: dst.degrees[i] for i in shrink},
            )
            return (
                self.allgather(shard_src, src_deg // max(dst_deg, 1), spans)
                + mat + OP_OVERHEAD_S
            )
        if src_deg == dst_deg and src.replica == dst.replica:
            # pure dim-to-dim migration at constant total degree (e.g.
            # [B/8, S] -> [B, S/8]): GSPMD emits a true all-to-all over
            # the axes each shrinking slot releases
            moved = [
                i for i, (sd, dd) in enumerate(zip(src.degrees, dst.degrees))
                if sd > dd
            ]
            spans = self._spans_dcn(
                src_slots, moved,
                {i: math.gcd(src.degrees[i], dst.degrees[i]) for i in moved},
            )
            return self.all_to_all(shard_src, n, spans) + mat + OP_OVERHEAD_S
        # mixed transition (degrees change AND migrate across dims, or
        # the replica factor changes): the SPMD partitioner's fallback
        # is "involuntary full rematerialization" — all-gather to
        # replicated, then slice locally (observed XLA warning
        # spmd_partitioner.cc:652).  Charging only an all-to-all here
        # made the search pick reshardings that execution pays full
        # gather for.
        spans = self._spans_dcn(
            src_slots, [i for i, d in enumerate(src.degrees) if d > 1]
        )
        # full remat: the replicated intermediate (the WHOLE tensor) is
        # written and re-read on every device before the local re-slice
        return (self.allgather(shard_src, src_deg, spans)
                + 2.0 * total / self.machine.hbm_bandwidth
                + self.machine.reshard_overhead_s + OP_OVERHEAD_S)

    def placement_move_cost(
        self, shape: ParallelTensorShape, src: Optional[ShardAnnot],
        spans_dcn: bool = False,
    ) -> float:
        """Cost of relocating a tensor between disjoint device blocks
        (views with different start_part): each shard crosses ICI once —
        or DCN when the blocks live on different hosts/slices."""
        parts = max(1, src.num_parts) if src is not None else 1
        shard = shape.num_bytes / parts
        if spans_dcn:
            return shard / self.machine.dcn_bandwidth + self.machine.dcn_latency
        return shard / self.machine.ici_bandwidth + self.machine.ici_latency

    # ---- gradient synchronization ---------------------------------------
    # optimizer-update memory passes per weight element: Adam reads
    # (w, g, m, v) and writes (w, m, v) — ~7 sequential streams.  The
    # constant matters less than the SCALING: each device updates its
    # own weight SHARD, so sharding a weight divides its update traffic
    # while replication repeats it on every holder (the host_cpu
    # per-device bandwidth already encodes that holders share the core).
    OPT_UPDATE_PASSES = 7.0

    def weight_sync_parts(
        self, op: Operator, mv: MachineView
    ) -> Optional[list]:
        """The per-weight sync terms of one (op, view): a list of
        ``(shard_bytes, replica, spans_dcn, total_elems)`` tuples, one
        per weight whose propagated annot is replicated (replica > 1) —
        the shared decomposition ``weight_sync_cost`` sums and the
        gradient-sync SCHEDULE coalesces into fused buckets
        (search/sync_schedule.py, Simulator's per-bucket lanes).
        Returns None when propagation rejects the view."""
        try:
            osh = op.propagate(mv)
        except AssertionError:
            return None
        # view slot degrees in the lowering's assignment order
        # (output dims, then the replica/contraction slot)
        nslots = len(mv.dim_degrees)
        slot_degrees = tuple(mv.dim_degrees) + (mv.replica_degree,)
        parts = []
        for ws, annot in zip(op._weight_specs, osh.weights):
            if annot is None or annot.replica <= 1:
                continue
            n = 1
            for d in ws.shape:
                n *= d
            shard_elems = n
            for d in annot.degrees:
                shard_elems //= max(d, 1)
            # the grad psum rides every view slot the weight itself
            # does NOT consume (the weight is replicated across them)
            weight_slots = {
                s for s, d in zip(annot.parallel_idx(), annot.degrees)
                if d > 1 and s != -1
            }
            active = [
                i for i in range(nslots)
                if slot_degrees[i] > 1 and i not in weight_slots
            ]
            if mv.replica_degree > 1 and REPLICA_SLOT not in weight_slots:
                active.append(nslots)
            spans = self._spans_dcn(slot_degrees, active)
            # group key: the (slot degrees, active slots) signature —
            # under the lowering's canonical slot→axis assignment, two
            # weights share their replication MESH AXES (and so can ride
            # one fused collective, comm/bucketed.py groups by the axes)
            # only when this signature matches; bucket_sync_cost fuses
            # per key so mixed-sharding buckets are never under-priced
            # with fewer latency floors than execution pays
            parts.append(
                (shard_elems * ws.dtype.itemsize, annot.replica, spans, n,
                 (slot_degrees, tuple(active)))
            )
        return parts

    def weight_sync_cost(
        self, op: Operator, mv: MachineView, precision: str = "fp32"
    ) -> float:
        """Per-iteration grad-allreduce for weights replicated across
        ``mv`` (reference: NCCL allreduce in optimizer, optimizer.cc:155-193;
        here XLA's psum over the batch axes of the mesh), at the given
        wire ``precision``.  The optimizer's elementwise update is
        priced separately (``update_cost``) on the compute timeline."""
        parts = self.weight_sync_parts(op, mv)
        if parts is None:
            return math.inf
        total = 0.0
        for nbytes, replica, spans, n, _key in parts:
            # sub-floor weights (bias/scale vectors) sync at fp32 even
            # inside a compressed group — mirrors quantized_grad_sync's
            # per-weight MIN_COMPRESS_ELEMS skip exactly
            p = precision
            if p != "fp32" and n < _min_compress_elems():
                p = "fp32"
            total += self.allreduce(nbytes, replica, spans, precision=p)
        return total

    def bucket_sync_cost(self, parts: list, precision: str = "fp32",
                         plan=None, level_acc: Optional[dict] = None,
                         ) -> float:
        """Seconds for ONE coalesced sync bucket: every weight part
        sharing a replication-axes signature (the group key from
        ``weight_sync_parts``) and effective wire precision rides a
        single fused collective over the summed bytes — one latency
        term where ``weight_sync_cost`` pays one per weight.  That
        amortization is what the schedule search trades against
        exposure: XLA's all-reduce combiner batches small same-group
        all-reduces the same way, and the bucketed execution path
        (comm/bucketed.py) flattens each replication group's payload
        into one wire buffer for real — the key keeps the priced fusion
        granularity matched to the executed one, so mixed-sharding
        buckets never get credited fewer latency floors than execution
        pays.  Sub-floor weights inside a compressed bucket keep fp32,
        exactly as ``weight_sync_cost``/``quantized_grad_sync`` do.

        ``plan`` — a staged reduction plan (search/reduction_plan.py):
        groups whose replication spans a link-level boundary are then
        priced as the staged hierarchy (``staged_sync_cost``) at the
        plan's per-level wire precisions instead of one flat ring; a
        sub-floor (fp32-forced) group stays fp32 at every level.  With
        ``plan=None`` the pricing is unchanged — the flat bit-identical
        baseline.  ``level_acc`` accumulates per-link-level seconds
        (the ICI-vs-DCN lanes of the simulator breakdown)."""
        groups: Dict[Tuple, float] = {}
        for nbytes, replica, spans, n, key in parts:
            if replica <= 1:
                continue
            p = precision
            if p != "fp32" and n < _min_compress_elems():
                p = "fp32"
            gk = (replica, spans, p, key)
            groups[gk] = groups.get(gk, 0.0) + nbytes
        total = 0.0
        for (replica, spans, p, key), nbytes in groups.items():
            if plan is not None and spans:
                factors = self.replica_level_split(key, replica)
                deepest = 0 if factors is None else max(
                    (i for i, f in enumerate(factors) if f > 1), default=0)
                # stage only when the plan reaches EXACTLY the deepest
                # level this group spans (the SHD131 legality rule);
                # a mismatched plan would otherwise be priced with
                # compressed RS/AG stages or a flat-rated cross stage —
                # a shape the executor never runs
                if deepest > 0 and plan.cross_level == deepest:
                    precs = tuple(
                        sp if p != "fp32" else "fp32"
                        for sp in plan.level_precisions)
                    total += self.staged_sync_cost(
                        nbytes, factors, precs, level_acc)
                    continue
            t = self.allreduce(nbytes, replica, spans, precision=p)
            total += t
            if level_acc is not None:
                _merge_levels(level_acc, self.allreduce_level_split(
                    nbytes, replica, spans, p, total=t))
        return total

    # ---- hierarchical (staged) reduction pricing -------------------------
    def replica_level_split(self, key, replica: int):
        """Per-level group factors of one fused sync group: how the
        replica-allreduce of a weight part (the group key from
        ``weight_sync_parts``) decomposes over the link hierarchy —
        ``factors[0]`` devices within a slice x ``factors[1]`` slice
        groups at DCN level 1 x ...; the product equals ``replica``.
        None when the slot→axis assignment fails or does not reproduce
        the replica factor (callers fall back to flat pricing)."""
        slot_degrees, active = key
        axes = self._slot_axes(tuple(slot_degrees))
        if axes is None:
            return None
        factors = [1] * len(self.levels())
        for slot in active:
            for stride, size in axes[slot]:
                factors[self._axis_level(stride * size)] *= size
        p = 1
        for f in factors:
            p *= f
        if p != replica:
            return None
        return tuple(factors)

    def staged_sync_cost(self, nbytes: float, factors: Tuple[int, ...],
                         precisions: Tuple[str, ...],
                         level_acc: Optional[dict] = None) -> float:
        """Hierarchical allreduce over the level split ``factors``:
        reduce-scatter within each level-0 group, recursively allreduce
        the 1/f0 shard across the coarser levels, then all-gather
        within the group (the staged shape of arXiv:2110.10548; XLA's
        own multislice allreduce).  The cross-level traffic shrinks by
        the within-level factor — THE hierarchical win the flat ring
        never earns.  ``precisions[i]`` is the wire precision of the
        level-i stage (the RS/AG pair below the deepest level, the
        middle allreduce at it); per-level precision is how int8-over-
        DCN composes with fp32-over-ICI."""
        levels = self.levels()

        def go(nb: float, li: int) -> float:
            k = factors[li]
            deeper = any(f > 1 for f in factors[li + 1:])
            prec = precisions[li] if li < len(precisions) else "fp32"
            if not deeper:
                t = self.allreduce(nb, k, li, precision=prec)
                if level_acc is not None and k > 1:
                    _merge_levels(level_acc, self.allreduce_level_split(
                        nb, k, li, prec, total=t))
                return t
            t = 0.0
            if k > 1:
                rs = self.reducescatter(nb, k, li, prec)
                ag = self.allgather(nb / k, k, li, prec)
                t += rs + ag
                if level_acc is not None:
                    _merge_levels(
                        level_acc, {levels[li].name: rs + ag})
                nb = nb / k
            return t + go(nb, li + 1)

        return go(nbytes, 0)

    def allreduce_level_split(
        self, nbytes: float, n: int, spans_dcn: Optional[int] = None,
        precision: Optional[str] = None, total: Optional[float] = None,
    ) -> Dict[str, float]:
        """``allreduce(...)`` decomposed per link level (the predicted
        ICI-vs-DCN lanes): each traversed DCN class gets its ring-bytes
        term, level 0 the remainder (ici wire + latency + quantize
        overhead) — the split sums exactly to the scalar cost."""
        if total is None:
            total = self.allreduce(nbytes, n, spans_dcn, precision)
        if n <= 1 or not math.isfinite(total):
            return {}
        levels = self.levels()
        crossed = self._crosses(n, spans_dcn)
        wire = nbytes * self._wire_scale(precision)
        split: Dict[str, float] = {}
        acc = 0.0
        for i in range(1, crossed + 1):
            t = 2.0 * (n - 1) / n * wire / levels[i].bandwidth
            split[levels[i].name] = split.get(levels[i].name, 0.0) + t
            acc += t
        split[levels[0].name] = max(0.0, total - acc)
        return split

    def sync_levels(self, op: Operator, mv: MachineView) -> Dict[str, float]:
        """Per-link-level seconds of one (op, view)'s weight sync at the
        mode-selected wire precision — the per-level predicted comm rows
        the DriftReport renders (drift on the slow DCN class visible
        separately from intra-slice drift)."""
        parts = self.weight_sync_parts(op, mv)
        if not parts:
            return {}
        prec = self.sync_precision_choice(op, mv)[0]
        out: Dict[str, float] = {}
        for nbytes, replica, spans, n, _key in parts:
            p = prec
            if p != "fp32" and n < _min_compress_elems():
                p = "fp32"
            _merge_levels(out, self.allreduce_level_split(
                nbytes, replica, spans, p))
        return out

    # the search compresses a group's sync only where the allreduce
    # actually DOMINATES: fp32 sync must exceed this fraction of the
    # op's own compute+update time.  Where compute dominates, the sync
    # hides behind it (async collectives — simulate()'s comm timeline),
    # so quantization would trade gradient fidelity for nothing.
    SYNC_DOMINANCE = 0.5

    def sync_precision_choice(
        self, op: Operator, mv: MachineView
    ) -> Tuple[str, float]:
        """(wire precision, sync seconds) this cost model prices for
        one (op, view) — THE shared rule between the DP search (via
        ``sync_cost``), the simulator, and the execution-side map
        builder (search/sync_precision.py), so simulated strategies
        price compressed sync exactly as the lowering will run it."""
        base = self.weight_sync_cost(op, mv)
        mode = self.sync_precision or "fp32"
        if mode == "fp32" or base <= 0.0 or not math.isfinite(base):
            return "fp32", base
        from flexflow_tpu_torch.search.sync_precision import grad_safe_to_compress

        if not grad_safe_to_compress(op):
            return "fp32", base
        if mode == "search":
            comp = self.op_cost(op, mv, backward=not self.inference)
            if not math.isfinite(comp) or base < self.SYNC_DOMINANCE * comp:
                return "fp32", base
            candidates = ("bf16", "int8")
        else:
            candidates = (mode,)
        best = ("fp32", base)
        for p in candidates:
            c = self.weight_sync_cost(op, mv, precision=p)
            if c < best[1]:
                best = (p, c)
        if best[0] == "int8" and self.sync_ef:
            # EF upgrade (FFConfig.sync_ef="auto"): same int8 wire plus
            # the residual passes, returned at its honest (slightly
            # higher) price — chosen for fidelity the currency cannot
            # see, never by the argmin above.  Unless the EF passes eat
            # the whole compression win: fp32 is then both exact AND
            # cheaper, so the upgrade falls back instead of picking a
            # strictly dominated wire.
            c_ef = self.weight_sync_cost(op, mv, precision="int8_ef")
            best = ("int8_ef", c_ef) if c_ef < base else ("fp32", base)
        return best

    def sync_cost(self, op: Operator, mv: MachineView) -> float:
        """weight_sync_cost at the precision the model's mode selects —
        what the simulator and both DP engines put on the comm
        timeline."""
        return self.sync_precision_choice(op, mv)[1]

    def update_cost(self, op: Operator, mv: MachineView) -> float:
        """Optimizer elementwise update over the local weight shard —
        serial compute at the tail of the step (it needs the final
        grads), so it belongs on the device timeline, unlike the
        overlappable grad allreduce."""
        if not op._weight_specs:
            return 0.0
        try:
            osh = op.propagate(mv)
        except AssertionError:
            return math.inf
        total = 0.0
        for ws, annot in zip(op._weight_specs, osh.weights):
            shard_elems = 1
            for d in ws.shape:
                shard_elems *= d
            if annot is not None:
                for d in annot.degrees:
                    shard_elems //= max(d, 1)
            total += (
                self.OPT_UPDATE_PASSES * shard_elems * ws.dtype.itemsize
                / self.machine.hbm_bandwidth
            )
        return total

    # ---- memory ----------------------------------------------------------
    def op_memory(self, op: Operator, mv: MachineView) -> float:
        """Per-device bytes: weights + activations for one shard."""
        try:
            osh = op.propagate(mv)
        except AssertionError:
            return math.inf
        mem = 0.0
        for ws, annot in zip(op._weight_specs, osh.weights):
            n = 1
            for d in ws.shape:
                n *= d
            for d in annot.degrees:
                n //= max(d, 1)
            w = n * ws.dtype.itemsize
            if self.inference:
                mem += w  # weights only: no grad, no optimizer state
                continue
            opt = w  # one optimizer-state share (weight + grad + opt)
            if self.zero_dp_shard:
                # mirror execution exactly (lowering._zero_augmented):
                # state shards over the mesh axes the weight does NOT
                # consume — implicit replication included — but only
                # onto evenly-divisible dims (place_zero_factors is THE
                # shared rule); unplaceable factors stay replicated, so
                # an indivisible weight is NOT credited savings it
                # won't get at runtime
                nd = self.num_devices or self.machine.num_devices
                sharded = 1
                for d in annot.degrees:
                    sharded *= max(d, 1)
                if sharded >= 1 and nd % sharded == 0 and nd > sharded:
                    extents = [
                        s // max(d, 1) if d and s % max(d, 1) == 0 else 1
                        for s, d in zip(ws.shape, annot.degrees)
                    ]
                    free = prime_factors(nd // sharded)
                    placed = place_zero_factors(extents, free)
                    achieved = 1
                    for _, fi in placed:
                        achieved *= free[fi]
                    opt = w / achieved
            mem += w * 2 + opt
        for shape, annot in zip(op.output_shapes, osh.outputs):
            n = shape.num_elements
            for d in annot.degrees:
                n //= max(d, 1)
            mem += n * shape.dtype.itemsize * (1 if self.inference else 2)
            # fwd activation (+ its grad when training)
        kv = getattr(op, "kv_cache_bytes", None)
        if kv is not None:
            # per-device KV residency at FULL page-pool occupancy (the
            # paged decode cache, ops/decode_attention.py): strategies
            # that cannot hold the pool are rejected inside the search's
            # memory check, not at runtime OOM.  Full occupancy, not the
            # arrival model's ragged load — HBM must fit the worst frame
            # the executor is allowed to admit.  Prefix sharing shrinks
            # that worst frame (shared pages are resident once across
            # the pool, ServingSpec.shared_residency_factor) — thread
            # the armed spec into hooks that accept it; legacy hooks
            # without the keyword price unshared.
            try:
                mem += kv(mv, serving=self.serving)
            except TypeError:
                mem += kv(mv)
        return mem
