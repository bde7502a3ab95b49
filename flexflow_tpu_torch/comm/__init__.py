"""Collective communication — the port of flexflow_tpu/comm/.

* ``compat`` — the transport seam: the reduce-scatter gloo lacks, and
  compressed payloads as raw bytes (the reference's absorbs JAX's
  ``shard_map`` drift).
* ``quantized`` — EQuARX-style compressed gradient sums
  (arXiv:2506.17615): per-chunk-scaled int8 or bf16, quantize ->
  all-to-all -> sum -> requantize -> all-gather, with error feedback and
  the error-bound contract.
* ``bucketed`` — the searched gradient-sync schedule's executor: fused
  buckets issued in the schedule's order as the backward produces
  their gradients.
* ``hierarchical`` — the staged reduction plans on machines with link
  levels: exact fp32 reduce-scatter and all-gather within a host around
  the cross-level exchange (arXiv:2110.10548).

Every collective goes through ``parallel/mesh.py``, which counts it.
The reference's ``__init__`` names are exported but ``shard_map`` and
``force_cpu_devices``: JAX's own API drift and virtual CPU devices,
which a port of torch ranks has no counterpart of.
"""

from flexflow_tpu_torch.comm.bucketed import BucketedSync, bucketed_grad_sync
from flexflow_tpu_torch.comm.compat import (
    all_gather_bytes,
    all_to_all_bytes,
    reduce_scatter,
)
from flexflow_tpu_torch.comm.hierarchical import (
    mesh_axis_spans,
    plan_axis_groups,
    plan_cross_precision,
    staged_allreduce,
)
from flexflow_tpu_torch.comm.quantized import (
    DEFAULT_CHUNK,
    MIN_COMPRESS_ELEMS,
    SYNC_PRECISIONS,
    allreduce_error_bound,
    dequantize_chunked,
    quantize_chunked,
    quantized_allreduce,
    quantized_allreduce_ef,
    quantized_grad_sync,
    replication_axes,
)

__all__ = [
    "BucketedSync",
    "DEFAULT_CHUNK",
    "MIN_COMPRESS_ELEMS",
    "SYNC_PRECISIONS",
    "all_gather_bytes",
    "all_to_all_bytes",
    "allreduce_error_bound",
    "bucketed_grad_sync",
    "dequantize_chunked",
    "mesh_axis_spans",
    "plan_axis_groups",
    "plan_cross_precision",
    "quantize_chunked",
    "quantized_allreduce",
    "quantized_allreduce_ef",
    "quantized_grad_sync",
    "reduce_scatter",
    "replication_axes",
    "staged_allreduce",
]
