"""Machine description and per-op parallelization descriptors — a copy
of flexflow_tpu/core/machine.py with one constructor added.

* ``MachineSpec`` — the hardware the cost model prices against: device
  count, per-device peak FLOP/s and HBM bandwidth, the link hierarchy
  (``LinkLevel``: level 0 inside a host, coarser levels across hosts).
  The reference's TPU specs (``tpu_v5e``, ``tpu_v5p``) and its CPU test
  machine (``host_cpu``) are kept, so a search here can be held against
  the reference's on the same spec; ``h100_sxm`` describes the card the
  port runs on and is the default of ``FFConfig.machine_spec``.  The
  fields keep the reference's names: ``ici_*`` is the link inside a
  host (NVLink through NVSwitch on the H100), ``dcn_*`` the link across
  hosts, and ``platform`` the backend a calibration table must come
  from (``"cuda"`` for the H100).
* ``MachineView`` — the view of one operator: a degree per output dim,
  a replica degree and a placement offset.  Each op's ``propagate(mv)``
  turns it into the sharding of its tensors and ``parallel/mesh.py``
  maps its slots onto mesh axes; the lowering (compiler/lowering.py)
  runs any combination of views, one process per rank, and ignores
  ``start_part`` as the reference's GSPMD lowering does.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Tuple

# measured by chip_smoke.py phase 9 on four H100 80GB HBM3 cards at a
# 700 W limit, joined by NVLink, with NCCL: the link latency is the
# device time of a 4-byte all-reduce over the 4 ranks (200 of them in
# one captured CUDA graph) over its 2 (n - 1) ring hops; the reshard
# overhead is one batch-split to replicated reshard of a 128 KB
# activation (parallel/mesh.py ``reshard``, host clock to its
# synchronise, the median of 200) less its bytes at the NVLink and HBM
# rates: what a layout boundary costs the port's eager steps beyond
# its bytes.  Each constant is the median of six runs on four
# machines: 3.43, 4.07, 3.67, 4.10, 3.61 and 3.23 us per hop (the last
# four the medians of 5 replays, which spanned 2.96-4.56 us); 0.265,
# 0.298, 0.308, 0.204, 0.403 and 0.329 ms per reshard (p10-p90 within
# a run: 0.17-0.61 ms).
H100_LINK_LATENCY_S = 3.64e-6
H100_RESHARD_OVERHEAD_S = 3.03e-4

# the published peaks of the NVIDIA cards the port runs on, by the
# name torch.cuda.get_device_name gives (the first key it contains):
# (HBM bytes/s, fp32 operations/s, dense bf16 tensor-core operations/s).
# The one table of them: ``h100_sxm``, the MFU tools and chip_smoke.py
# read it.
CARD_PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 756e12),
    ("H100 NVL", 3.9e12, 60e12, 835e12),
    ("H200", 4.8e12, 67e12, 989e12),
    ("H100", 3.35e12, 67e12, 989e12),  # SXM
)


def card_peaks(name: str):
    """(bytes/s, fp32 operations/s, bf16 operations/s) of the card named
    ``name``, or None when CARD_PEAKS has no row for it."""
    for key, *peaks in CARD_PEAKS:
        if key in name:
            return tuple(peaks)
    return None


@dataclass(frozen=True)
class LinkLevel:
    """One level of the machine's link hierarchy: devices live in
    aligned groups of ``span`` connected at this level's bandwidth;
    collectives confined to one group never pay the coarser levels.
    Level 0 is always ICI (within a slice); coarser levels are DCN
    classes (across slices, across superpods, ...)."""

    name: str
    span: int  # devices per aligned group at this level
    bandwidth: float  # bytes/s per device
    latency: float  # seconds per hop


@dataclass(frozen=True)
class MachineSpec:
    """Hardware description used for cost modeling and mesh construction.

    Bandwidths are bytes/second, latencies seconds, flops are
    peak per-chip FLOP/s at the matmul dtype (bf16 on TPU).
    """

    num_devices: int = 1
    # size of one ICI domain — a host for CPU machines, a SLICE for
    # multislice TPU (ICI spans all chips of a slice; DCN links slices).
    # Collectives confined to one domain ride ICI; crossing ones add a
    # DCN term (search/machine_model.py _spans_dcn).
    devices_per_host: int = 8
    peak_flops: float = 1.97e14  # TPU v5e bf16 MXU peak
    hbm_bandwidth: float = 8.1e11  # bytes/s
    hbm_capacity: float = 16e9  # bytes
    vmem_capacity: float = 128e6  # bytes (~VMEM per core)
    ici_bandwidth: float = 4.5e10  # bytes/s per link per direction
    ici_latency: float = 1e-6  # seconds per hop
    ici_torus: Tuple[int, ...] = ()  # physical torus shape, () = derive
    dcn_bandwidth: float = 3.125e9  # bytes/s per host (25 Gbps)
    dcn_latency: float = 10e-6
    # optional N-LEVEL link hierarchy above ICI: tuples of
    # (span, bandwidth, latency), spans strictly ascending, each a
    # multiple of devices_per_host and a divisor of the next (aligned
    # nesting).  Empty (the default) derives the classic two-level
    # structure — one DCN class spanning the whole machine — from
    # dcn_bandwidth/dcn_latency, so every existing spec prices
    # bit-identically.  ``topology_levels()`` is the one reader.
    slice_levels: Tuple[Tuple[int, float, float], ...] = ()
    # fixed seconds per GSPMD reshard op beyond its byte costs (kernel
    # launches, layout churn, fusion break).  ~launch-scale on TPU;
    # dominant at small sizes on a serialized CPU host (measured ~2 ms
    # per boundary for a 128 KB tensor — 20x the byte estimate)
    reshard_overhead_s: float = 1e-6
    name: str = "tpu_v5e"
    # the jax platform this spec models ("tpu" or "cpu") — measured
    # calibration records are only coherent with a simulator whose
    # machine model describes the backend they were probed on.  An
    # explicit field (not a name heuristic): custom-named models from
    # --machine-model-file stay correctly classified, and to_file /
    # from_file round-trip it.
    platform: str = "tpu"

    # ---- constructors ----------------------------------------------------
    @staticmethod
    def tpu_v5e(num_devices: int = 8) -> "MachineSpec":
        side = int(math.isqrt(num_devices))
        torus = (side, num_devices // side) if side * (num_devices // side) == num_devices else (num_devices,)
        return MachineSpec(num_devices=num_devices, ici_torus=torus)

    @staticmethod
    def tpu_v5p(num_devices: int = 8) -> "MachineSpec":
        return MachineSpec(
            num_devices=num_devices,
            peak_flops=4.59e14,
            hbm_bandwidth=2.765e12,
            hbm_capacity=95e9,
            ici_bandwidth=9e10,
            name="tpu_v5p",
        )

    @staticmethod
    def h100_sxm(num_devices: int = 8) -> "MachineSpec":
        """NVIDIA H100 SXM5 80GB: the port's counterpart of ``tpu_v5e``
        and the default ``FFConfig.machine_spec``.  Published figures:
        989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB, and NVLink 4 at
        450 GB/s each way per GPU through NVSwitch, 8 GPUs per host
        (one big switch: ``search/network.py`` ``nvswitch_network``);
        across hosts one 400 Gb/s NIC per GPU.  The on-chip store that
        plays VMEM's part is the SMs' shared memory (132 x 228 KB).
        ``ici_latency`` and ``reshard_overhead_s`` are this card's own,
        measured by ``chip_smoke.py`` phase 9 (its ``link latency`` and
        ``reshard overhead`` lines; PERF.md records the card and power
        limit of the run they come from).  ``dcn_latency`` is not
        measured: no multi-host machine was at hand."""
        return MachineSpec(
            num_devices=num_devices,
            devices_per_host=8,
            peak_flops=card_peaks("H100")[2],
            hbm_bandwidth=card_peaks("H100")[0],
            hbm_capacity=80e9,
            vmem_capacity=132 * 228e3,
            ici_bandwidth=4.5e11,
            ici_latency=H100_LINK_LATENCY_S,
            dcn_bandwidth=5e10,
            dcn_latency=5e-6,
            reshard_overhead_s=H100_RESHARD_OVERHEAD_S,
            name="h100_sxm",
            platform="cuda",
        )

    @staticmethod
    def host_cpu(num_devices: int = 8) -> "MachineSpec":
        """Virtual-device CPU machine for tests (same role as the
        reference's --search-num-workers override, graph.cc:1535-1540).

        Measured on the CI-style host (often ONE physical core serving
        all virtual devices): ~1.4e11 FLOP/s f32 matmul for the WHOLE
        host, so per-device peak is host/num_devices — virtual devices
        serialize, parallel speedup on this "mesh" is zero and the
        model must say so or the search picks replication-heavy
        strategies that execution loses.  Collectives serialize through
        the same core, so the ring formula needs the EFFECTIVE
        bandwidth that reproduces measured wall times: an 8-way psum
        measures ~0.10 ms fixed + total-bytes/7.6e9 across 4KB-32MB
        payloads, which the 2(n-1)/n-shard ring formula reproduces at
        0.95e9 B/s with the fixed cost spread over 2(n-1) hops
        (~7 us/hop).  Memory traffic (the reshard materialization term)
        shares the core too: ~1.25e9 B/s per virtual device."""
        return MachineSpec(
            num_devices=num_devices,
            peak_flops=1.4e11 / max(1, num_devices),
            hbm_bandwidth=1.25e9,
            ici_bandwidth=0.95e9,
            ici_latency=7e-6,
            reshard_overhead_s=1.5e-3,
            name="host_cpu",
            platform="cpu",
        )

    @staticmethod
    def from_file(path: str) -> "MachineSpec":
        """Load from a JSON machine-config file — the TPU analogue of
        the reference's EnhancedMachineModel config
        (reference: machine_config_example:1-40, --machine-model-file)."""
        with open(path) as f:
            cfg = json.load(f)
        if "ici_torus" in cfg:
            cfg["ici_torus"] = tuple(cfg["ici_torus"])
        if "slice_levels" in cfg:
            cfg["slice_levels"] = tuple(
                tuple(lvl) for lvl in cfg["slice_levels"])
        return MachineSpec(**cfg)

    def to_file(self, path: str) -> None:
        d = {k: getattr(self, k) for k in self.__dataclass_fields__}
        d["ici_torus"] = list(d["ici_torus"])
        d["slice_levels"] = [list(lvl) for lvl in d["slice_levels"]]
        with open(path, "w") as f:
            json.dump(d, f, indent=2)

    # ---- queries ---------------------------------------------------------
    @property
    def num_hosts(self) -> int:
        return max(1, self.num_devices // self.devices_per_host)

    def topology_levels(self) -> Tuple[LinkLevel, ...]:
        """The machine's link hierarchy, finest first.  Level 0 is
        always ICI with span ``devices_per_host``; above it come the
        configured ``slice_levels`` or — when none are configured and
        the machine is bigger than one slice — the single classic DCN
        level spanning the whole machine.  A flat machine (one slice)
        is the degenerate single-level case."""
        levels = [LinkLevel("ici", self.devices_per_host,
                            self.ici_bandwidth, self.ici_latency)]
        if self.slice_levels:
            multi = len(self.slice_levels) > 1
            prev = self.devices_per_host
            for i, (span, bw, lat) in enumerate(self.slice_levels):
                if span <= prev or span % prev != 0:
                    raise ValueError(
                        f"slice_levels[{i}] span {span} must be an "
                        f"ascending multiple of the previous level's "
                        f"span {prev}")
                levels.append(LinkLevel(
                    f"dcn{i + 1}" if multi else "dcn", span, bw, lat))
                prev = span
        elif self.num_devices > self.devices_per_host:
            levels.append(LinkLevel(
                "dcn", self.num_devices, self.dcn_bandwidth,
                self.dcn_latency))
        return tuple(levels)

    def matmul_time(self, flops: float) -> float:
        return flops / self.peak_flops

    def hbm_time(self, num_bytes: float) -> float:
        return num_bytes / self.hbm_bandwidth




@dataclass(frozen=True)
class MachineView:
    """Parallelization of one operator: degree per output dim + replicas.

    ``dim_degrees[i]`` partitions output dim i into that many shards;
    ``replica_degree`` replicates the op's output.  Total parts =
    product.  ``start_part`` is the placement offset: the op's shards
    occupy the contiguous device block [start_part, start_part +
    num_parts)."""

    dim_degrees: Tuple[int, ...]
    replica_degree: int = 1
    start_part: int = 0

    @property
    def num_parts(self) -> int:
        p = self.replica_degree
        for d in self.dim_degrees:
            p *= d
        return p

    @property
    def is_trivial(self) -> bool:
        return self.num_parts == 1

    def __str__(self) -> str:
        s = "x".join(str(d) for d in self.dim_degrees)
        if self.replica_degree > 1:
            s += f"*R{self.replica_degree}"
        if self.start_part:
            s += f"@{self.start_part}"
        return f"MV[{s}]"

    @staticmethod
    def trivial(ndim: int) -> "MachineView":
        return MachineView(dim_degrees=(1,) * ndim)

    @staticmethod
    def data_parallel(ndim: int, degree: int,
                      batch_dim: int = 0) -> "MachineView":
        dims = [1] * ndim
        dims[batch_dim] = degree
        return MachineView(dim_degrees=tuple(dims))
