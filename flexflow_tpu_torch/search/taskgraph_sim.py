"""Logical-task-graph simulator — the alternative cost evaluator; a
copy of flexflow_tpu/search/taskgraph_sim.py.

Reference parity: LogicalTaskgraphBasedSimulator (simulator.h:774-816)
— operates on the logical task graph, expands allreduces into ring
transfers at simulation time, and routes transfer segments over the
NetworkedMachineModel instead of costing each transfer independently.

TPU re-design: the event-driven Simulator prices each edge/sync with
the (memoized) per-collective network cost; this simulator instead
**pools every transfer of the iteration into one traffic matrix** and
evaluates them jointly on the ICI torus — capturing cross-collective
link contention the per-edge model cannot see.  Compute is the same
device-timeline critical path with zero edge cost; the iteration
estimate assumes XLA overlaps communication with compute:

    time = max(compute_critical_path, joint_comm_time) + latency terms

Coarser in sequencing, sharper in contention — the same trade the
reference's logical simulator makes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from flexflow_tpu_torch.core.graph import Graph
from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.search.machine_model import OP_OVERHEAD_S
from flexflow_tpu_torch.search.simulator import Simulator


class LogicalTaskGraphSimulator(Simulator):
    def _ring_flows(self, n: int, bytes_per_link: float) -> List[Tuple[int, int, float]]:
        """Ring flows over BOTH canonical groups (contiguous inner-axis
        and strided outer-axis — CostModel._net_groups), so links shared
        with concurrent collectives are charged conservatively."""
        flows = []
        for g in self.cost._net_groups(n) or [list(range(n))]:
            flows.extend(
                (g[i], g[(i + 1) % n], bytes_per_link) for i in range(n)
            )
        return flows

    def simulate(self, graph: Graph, strategy: Dict[int, MachineView],
                 include_update=None, schedule=None, breakdown=None,
                 comm_schedule=None, sync_schedule=None) -> float:
        if include_update is None:
            include_update = not self.inference
        if self.cost.network is None:
            # no topology to pool flows on — fall back to the event sim
            return super().simulate(graph, strategy, include_update, schedule,
                                    breakdown=breakdown,
                                    comm_schedule=comm_schedule,
                                    sync_schedule=sync_schedule)
        # pooled-traffic currency: flows are joint, so a sync schedule's
        # per-bucket lanes have no representation here — sync bytes are
        # pooled identically either way (ignored by design)

        topo = graph.topo_order()
        shardings = {}
        for node in topo:
            mv = strategy.get(node.guid)
            if mv is None:
                mv = node.op.fixed_machine_view() or MachineView.trivial(
                    node.op.output_shapes[0].ndim
                )
            osh = self._propagate(node, mv)
            if osh is None:
                return math.inf
            shardings[node.guid] = (mv, osh)

        # ---- compute: device-timeline critical path, zero edge cost ----
        ready: Dict[int, float] = {}
        avail = {d: 0.0 for d in range(self.num_devices)}
        compute_end = 0.0
        flows: List[Tuple[int, int, float]] = []
        lat = self.machine.ici_latency

        for node in topo:
            mv, osh = shardings[node.guid]
            start = 0.0
            for e in graph.in_edges[node.guid]:
                start = max(start, ready.get(e.src, 0.0))
                # ---- pool this edge's resharding traffic ----
                src_mv, src_osh = shardings[e.src]
                src_annot = (src_osh.outputs[e.src_idx]
                             if e.src_idx < len(src_osh.outputs) else None)
                dst_annot = (osh.inputs[e.dst_idx]
                             if e.dst_idx < len(osh.inputs) else None)
                shape = graph.nodes[e.src].op.output_shapes[e.src_idx]
                t_edge = self.cost.xfer_cost(shape, src_annot, dst_annot)
                if not math.isfinite(t_edge):
                    return math.inf
                # pure-local reshards (repartition refinement) are costed
                # at OP_OVERHEAD_S and move zero wire bytes — skip them
                if t_edge > OP_OVERHEAD_S:
                    # time -> bottleneck-link bytes, with the collective's
                    # latency term removed first (traffic_time re-adds
                    # path latency once; charging it as payload would
                    # double-count).  Residual approximation: a DCN term
                    # folds into ICI bytes (conservative).
                    n = max(src_annot.num_parts if src_annot else 1,
                            dst_annot.num_parts if dst_annot else 1, 2)
                    n = min(n, self.cost.network.topology.num_nodes)
                    t_bw = max(0.0, t_edge - (n - 1) * lat)
                    if t_bw > 0:
                        flows.extend(self._ring_flows(
                            n, t_bw * self.machine.ici_bandwidth))
            devs = self.view_device_set(mv)
            for d in devs:
                start = max(start, avail[d])
            fwd, full, sync, _mem = self._node_costs(node, mv)
            finish = start + (full if include_update else fwd)
            for d in devs:
                avail[d] = finish
            ready[node.guid] = finish
            compute_end = max(compute_end, finish)
            if schedule is not None:
                schedule.append((node.op.name, start, finish, tuple(sorted(devs))))
            if include_update:
                if not math.isfinite(sync):
                    return math.inf
                if sync > 0:
                    n = max(2, min(mv.num_parts,
                                   self.cost.network.topology.num_nodes))
                    t_bw = max(0.0, sync - 2 * (n - 1) * lat)
                    if t_bw > 0:
                        flows.extend(self._ring_flows(
                            n, t_bw * self.machine.ici_bandwidth))

        comm_time = self.cost.network.traffic_time(flows) if flows else 0.0
        total = max(compute_end, comm_time)
        if breakdown is not None:
            # pooled-traffic currency: flows are joint, so there are no
            # per-collective comm records (comm_schedule stays empty BY
            # DESIGN).  pooled_comm=True says so explicitly — ffobs /
            # trace consumers must not read "no comm records" as "no
            # communication" (the whole iteration's resharding + sync
            # traffic is inside comm_end_s as one joint evaluation).
            breakdown.update(
                total_s=total,
                compute_end_s=compute_end,
                comm_end_s=comm_time,
                num_devices=self.num_devices,
                include_update=include_update,
                pooled_comm=True,
            )
        return total
