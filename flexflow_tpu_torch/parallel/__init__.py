"""Multi-rank execution: the mesh of ranks, resharding and the ranks'
collectives, ring attention and the pipeline — the port of
flexflow_tpu/parallel/.  Its ``__init__``'s names are exported here
but two JAX idioms: ``annot_partition_spec``
returns a ``jax.sharding.PartitionSpec`` (the port's layout is
``parallel.mesh.placement``'s ``Placement``), and ``pipeline_spmd`` is
the reference's ``lax.scan`` over stages, which the port does not copy
(``parallel/pipeline.py``: GPipe over ranks)."""

from flexflow_tpu_torch.parallel.mesh import (
    build_mesh,
    prime_factors,
    view_slot_axes,
)
from flexflow_tpu_torch.parallel.pipeline import (
    PipelineConfig,
    split_microbatches,
    merge_microbatches,
)

__all__ = [
    "build_mesh",
    "prime_factors",
    "view_slot_axes",
    "PipelineConfig",
    "split_microbatches",
    "merge_microbatches",
]
