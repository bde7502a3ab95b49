"""tests/test_ptensor.py's contracts on the port's shape algebra
(flexflow_tpu_torch/core/ptensor.py), with the port's counterpart of
``partition_spec``: ``parallel.mesh.placement`` of an annotation."""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.core.ptensor import (
    DataType,
    ParallelDim,
    ParallelTensorShape,
    replica_dim,
)
from flexflow_tpu_torch.ops.base import REPLICA_SLOT, ShardAnnot
from flexflow_tpu_torch.parallel.mesh import Mesh, Placement, placement


def test_basic_shape():
    s = ParallelTensorShape.make([64, 128], "float32")
    assert s.sizes == (64, 128)
    assert s.degrees == (1, 1)
    assert s.num_elements == 64 * 128
    assert s.num_bytes == 64 * 128 * 4
    assert s.total_degree == 1


def test_partitioned_dims():
    s = ParallelTensorShape.make(
        [64, 128], "bfloat16", degrees=[4, 2], axes=[("x0", "x1"), ("x2",)])
    assert s.shard_sizes == (16, 64)
    assert s.total_degree == 8
    assert s.shard_bytes == 16 * 64 * 2
    assert s.used_axes() == ("x0", "x1", "x2")


def test_replica_dim():
    s = ParallelTensorShape.make([32, 32]).with_replica(4, ("x0", "x1"))
    assert s.replica_degree == 4
    assert s.total_degree == 4
    assert s.sizes == (32, 32)  # replicas invisible logically
    assert s.with_replica(1).replica_degree == 1


def test_invalid_degree():
    with pytest.raises(ValueError):
        ParallelDim(size=10, degree=3)
    with pytest.raises(ValueError):
        replica_dim(4).__class__(size=3, degree=4, is_replica=True)


def test_placement_of_an_annotation():
    """partition_spec's contract on the port's layouts: dims split over
    their slots' axes, replication by absence, partial sums over the
    replica slot's axes."""
    slots = {0: ("x0", "x1"), 1: (), 2: ("x2",), REPLICA_SLOT: ()}
    assert placement(ShardAnnot((4, 1, 2)), slots) == Placement(
        (("x0", "x1"), (), ("x2",)))
    assert placement(ShardAnnot((1, 1)), slots) == Placement.replicated(2)
    slots = {0: ("x0",), 1: (), REPLICA_SLOT: ("x1", "x2")}
    linear_x = ShardAnnot((2, 4), replica=1, idx=(0, REPLICA_SLOT))
    assert placement(linear_x, slots) == Placement((("x0",), ("x1", "x2")))
    out = placement(ShardAnnot((2, 1), replica=4, partial=True), slots)
    assert out == Placement((("x0",), ()), partial=("x1", "x2"))
    assert out.without_partial() == Placement((("x0",), ()))


def test_local_blocks_follow_row_major_coordinates():
    """Rank r of 8 sits at the row-major coordinates of r over (2, 2, 2),
    as np.array(devices).reshape(shape) orders the reference's mesh."""
    pl = Placement((("x0", "x1"), ("x2",)))
    for r in range(8):
        m = Mesh(8, r, make_groups=False)
        assert [m.coord(a) for a in m.names] == list(
            np.unravel_index(r, (2, 2, 2)))
        rows, cols = pl.local_slices((16, 6), m)
        assert (rows.start, rows.stop) == (4 * (r // 2), 4 * (r // 2) + 4)
        assert (cols.start, cols.stop) == (3 * (r % 2), 3 * (r % 2) + 3)
        assert pl.local_sizes((16, 6), m) == (4, 3)
        assert m.members(("x0", "x2")) == sorted(
            q for q in range(8) if (q // 2) % 2 == (r // 2) % 2)


def test_drop_parallelism_and_logical_eq():
    s = ParallelTensorShape.make([64, 128], degrees=[4, 2],
                                 axes=[("a",), ("b",)])
    d = s.drop_parallelism()
    assert d.degrees == (1, 1)
    assert d.logical_eq(s)


def test_dtype():
    assert DataType.from_any("float32") is DataType.FLOAT32
    assert DataType.from_any(np.float32) is DataType.FLOAT32
    assert DataType.BFLOAT16.itemsize == 2
    assert DataType.BFLOAT16.to_torch() is torch.bfloat16
