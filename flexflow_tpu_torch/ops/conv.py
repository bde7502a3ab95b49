"""Conv2D and Pool2D — the port of flexflow_tpu/ops/conv.py, with the
reference's NHWC semantics (reference: src/ops/conv_2d.cc, pool_2d.cc).

Activations stay NHWC tensors.  A conv runs as ``F.conv2d`` on the
input viewed as NCHW (``permute(0, 3, 1, 2)``): an NHWC-contiguous
tensor seen that way is ``channels_last``, so cuDNN takes its NHWC
kernels and no activation is copied; the result is viewed back as NHWC.
The kernel weight keeps the reference's HWIO shape ``[kh, kw, cin /
groups, cout]`` (``propagate``'s annotations and the npz checkpoints
rely on it) and is converted per call, cast to the compute dtype and
laid out as OIHW in ``channels_last`` memory (OHWI) in one copy.
Rounding is the reference's (conv.py:137-152): the product rounded to
the compute dtype, then the fp32 bias, then the activation, then the
input's dtype.

Pooling: max pads with -inf; average sums in fp32 and always divides
by ``kh * kw`` (``count_include_pad``).  Output sizes floor
(``_out_size``).  torch's pools refuse a padding above half the kernel,
which the reference allows: that input is padded explicitly (-inf or 0)
and pooled without padding.

Under a strategy (``propagate`` is the reference's): a batch or
out-channel split runs ``forward`` on the shards; an in-channel split
``r`` leaves partial sums, so the bias goes in on one rank of the
replica axes and an activation waits for the op's own sum, as in
ops/linear.py.  A split H or W is OptCNN's attribute parallelism, for
which the reference lets GSPMD exchange halos: here ``forward_sharded``
exchanges them itself (``parallel.mesh.halo_exchange``).  Rank r's
output rows along a split dim are its block [o0, o1) of the output,
which read input rows [o0 * s - p, (o1 - 1) * s - p + k); the rank
receives the rows of that window it does not hold from the ranks that
own them (however many blocks away: a 7x7 kernel over blocks of 2
rows takes rows from several owners), drops the rows it holds outside
it (stride 2 can leave a block's edge unread), pads only where the
window crosses the tensor's edge (zeros for a conv and an average,
-inf for a max; the average still divides by ``kh * kw``), and runs
the op unpadded on that dim: every rank computes its own output block
and nothing else.  With H and W both split, H is exchanged first and
W then on the H-extended window, which carries the corners.  The
backward returns each halo row's gradient to its owner.  A grouped
conv under an in-channel split gathers the channels and the kernel
whole (a group's channels do not follow the split): one rank of the
replica axes computes the product and the others add zeros.  A grouped
conv under an out-channel split computes its block of the out channels
from the input channels of the groups that block belongs to
(``_group_pieces``): the block may span several whole groups (a
depthwise conv's block is its own input channels) or lie inside one
(more ranks than groups).  The input's gradient is then a partial sum
over the out-channel axes, which the lowering sums as it does for an
ungrouped conv.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.core.machine import MachineView
from flexflow_tpu_torch.core.optype import OperatorType
from flexflow_tpu_torch.core.ptensor import DataType, ParallelTensorShape
from flexflow_tpu_torch.initializers import (
    DEFAULT_BIAS_INIT,
    DEFAULT_WEIGHT_INIT,
    Initializer,
)
from flexflow_tpu_torch.ops.base import (
    REPLICA_SLOT,
    LoweringContext,
    Operator,
    OpSharding,
    ShardAnnot,
    WeightSpec,
    register_op,
)

_ACT = {  # the reference's table (conv.py:35-41)
    None: lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def _check_activation(op_name: str, activation) -> None:
    if activation not in _ACT:
        raise NotImplementedError(
            f"{op_name} activation {activation!r} not supported; "
            f"one of {sorted(k for k in _ACT if k)}"
        )


def _out_size(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def _spatial_axes(pl) -> Tuple[str, ...]:
    """The mesh axes a layout splits dims 1-2 (H, W) over."""
    return tuple(pl.dims[1]) + tuple(pl.dims[2])


def _halo_windows(size: int, n: int, kernel: int, stride: int, pad: int
                 ) -> Tuple[Tuple[int, int], ...]:
    """Each of ``n`` ranks' input rows [lo, hi) along a dim of ``size``
    split evenly: the rows its block of the output reads, in unpadded
    coordinates (lo < 0 or hi > size where the window crosses an
    edge)."""
    out = _out_size(size, kernel, stride, pad)
    if size % n or out % n:
        raise ValueError(f"a split of {n} does not divide input {size} "
                         f"and output {out}")
    per = out // n
    return tuple((j * per * stride - pad,
                  (j * per + per - 1) * stride - pad + kernel)
                 for j in range(n))


def halo_rows(size: int, n: int, kernel: int, stride: int, pad: int,
              rank: int) -> Tuple[int, int, int]:
    """Along a dim of ``size`` split ``n`` ways under a window of
    ``kernel`` rows at ``stride`` and padding ``pad``: (the rows
    ``rank`` sends in the forward exchange, the rows it sends back in
    the backward, the rows of its window)."""
    block = size // n
    windows = [(max(lo, 0), min(hi, size))
               for lo, hi in _halo_windows(size, n, kernel, stride, pad)]

    def held(lo, hi, j):  # rows of [lo, hi) in rank j's block
        return max(0, min(hi, (j + 1) * block) - max(lo, j * block))

    lo, hi = windows[rank]
    others = [j for j in range(n) if j != rank]
    return (sum(held(*windows[j], rank) for j in others),
            sum(held(lo, hi, j) for j in others), hi - lo)


def halo_cells(hw: Tuple[int, int], splits: Tuple[int, int],
               kernel: Tuple[int, int], stride: Tuple[int, int],
               pad: Tuple[int, int], rank: int) -> Tuple[int, int]:
    """The H x W cells ``rank`` sends in one conv's or pool's halo
    exchanges over an input of ``hw`` split ``splits`` = (nh, nw) ways
    (the rank at (rank // nw, rank % nw)), H first on its W block, then
    W on its H window: (forward, backward).  Times the batch block,
    the channels and the element size, the exchanges' bytes."""
    (h, w), (nh, nw) = hw, splits
    rh, rw = divmod(rank, nw)
    fwd = bwd = 0
    rows = h
    if nh > 1:
        f, b, rows = halo_rows(h, nh, kernel[0], stride[0], pad[0], rh)
        fwd, bwd = f * (w // nw), b * (w // nw)
    if nw > 1:
        f, b, _ = halo_rows(w, nw, kernel[1], stride[1], pad[1], rw)
        fwd, bwd = fwd + f * rows, bwd + b * rows
    return fwd, bwd


def _halo_input(ctx, x, kernel, stride, pad, fill):
    """This rank's input window of a conv or pool over its split H and
    W (module docstring), padded with ``fill`` where it crosses the
    tensor's edges; returns it and the padding the op keeps on each of
    H and W (none on a split dim)."""
    from flexflow_tpu_torch.parallel.mesh import halo_exchange

    in_pl, out_pl = ctx.in_placements[0], ctx.out_placements[0]
    edge = [0, 0, 0, 0]  # H low, H high, W low, W high
    keep = list(pad)
    for i, d in enumerate((1, 2)):
        axes = in_pl.dims[d]
        if not axes:
            continue
        if tuple(out_pl.dims[d]) != tuple(axes):
            raise ValueError(f"dim {d} split over {axes} in, "
                             f"{out_pl.dims[d]} out")
        n = ctx.mesh.size(axes)
        size = x.shape[d] * n
        windows = _halo_windows(size, n, kernel[i], stride[i], pad[i])
        lo, hi = windows[ctx.mesh.index(axes)]
        x = halo_exchange(x, d, axes, ctx.mesh,
                          [(max(a, 0), min(b, size)) for a, b in windows])
        edge[2 * i], edge[2 * i + 1] = max(0, -lo), max(0, hi - size)
        keep[i] = 0
    if any(edge):
        x = F.pad(x, (0, 0, edge[2], edge[3], edge[0], edge[1]), value=fill)
    return x, tuple(keep)


@register_op
class Conv2DOp(Operator):
    """Input [N, H, W, Cin] -> output [N, Ho, Wo, Cout].

    attrs: out_channels, kernel_h/w, stride_h/w, padding_h/w, groups,
    activation, use_bias (reference ctor: conv_2d.cc FFModel::conv2d).
    """

    op_type = OperatorType.CONV2D

    def __init__(
        self,
        name,
        input_shapes,
        out_channels: int,
        kernel_h: int,
        kernel_w: int,
        stride_h: int = 1,
        stride_w: int = 1,
        padding_h: int = 0,
        padding_w: int = 0,
        groups: int = 1,
        activation: str | None = None,
        use_bias: bool = True,
        kernel_initializer: Initializer | None = None,
        bias_initializer: Initializer | None = None,
    ):
        _check_activation(type(self).__name__, activation)
        self._kernel_init = kernel_initializer or DEFAULT_WEIGHT_INIT
        self._bias_init = bias_initializer or DEFAULT_BIAS_INIT
        super().__init__(
            name,
            input_shapes,
            out_channels=out_channels,
            kernel_h=kernel_h,
            kernel_w=kernel_w,
            stride_h=stride_h,
            stride_w=stride_w,
            padding_h=padding_h,
            padding_w=padding_w,
            groups=groups,
            activation=activation,
            use_bias=use_bias,
        )

    def infer(self) -> Sequence[ParallelTensorShape]:
        n, h, w, c = self.input_shapes[0].sizes
        a = self.attrs
        assert c % a["groups"] == 0 and a["out_channels"] % a["groups"] == 0
        ho = _out_size(h, a["kernel_h"], a["stride_h"], a["padding_h"])
        wo = _out_size(w, a["kernel_w"], a["stride_w"], a["padding_w"])
        return (
            ParallelTensorShape.make(
                (n, ho, wo, a["out_channels"]), self.input_shapes[0].dtype
            ),
        )

    def weight_specs(self) -> Sequence[WeightSpec]:
        a = self.attrs
        cin = self.input_shapes[0].sizes[-1]
        specs = [
            WeightSpec(
                "kernel",
                (a["kernel_h"], a["kernel_w"], cin // a["groups"],
                 a["out_channels"]),
                DataType.FLOAT32,
                self._kernel_init,
            )
        ]
        if a["use_bias"]:
            specs.append(WeightSpec("bias", (a["out_channels"],),
                                    DataType.FLOAT32, self._bias_init))
        return specs

    def _conv(self, ctx, x, kernel, padding=None) -> torch.Tensor:
        """The product, NHWC in, NHWC out, rounded to the compute dtype
        and returned in fp32 (``padding``: the attrs' by default).
        ``x`` holds the input channels whole when the conv is grouped;
        ``kernel`` this rank's block of the out channels, which
        ``_group_pieces`` pairs with its groups' input channels."""
        a = self.attrs
        cd = ctx.compute_dtype
        if padding is None:
            padding = (a["padding_h"], a["padding_w"])

        def conv(xs, ks, groups):
            # HWIO -> OIHW in channels_last memory (OHWI), cast, one copy
            k = ks.permute(3, 2, 0, 1).to(dtype=cd,
                                          memory_format=torch.channels_last)
            y = F.conv2d(xs.to(cd).permute(0, 3, 1, 2), k,
                         stride=(a["stride_h"], a["stride_w"]),
                         padding=padding, groups=groups)
            return y.permute(0, 2, 3, 1).float()

        if a["groups"] == 1:
            return conv(x, kernel, 1)
        ys = [conv(x[..., i0:i1], kernel[..., c0:c1], groups)
              for i0, i1, c0, c1, groups in self._group_pieces(ctx, kernel)]
        return ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)

    def _group_pieces(self, ctx, kernel):
        """This rank's block [o0, o1) of the out channels (the whole on
        one rank) as runs of one ``F.conv2d`` each: (input channels
        [i0, i1), the block's channels [c0, c1), groups).  A block of
        whole groups is one run over those groups' input channels; a
        block that starts or ends inside a group (more ranks than
        groups, or groups that do not divide evenly) is a run per group
        it touches, each an ungrouped conv over that group's input
        channels."""
        g, cout = self.attrs["groups"], self.attrs["out_channels"]
        per_out, per_in, b = cout // g, kernel.shape[2], kernel.shape[3]
        o0 = 0
        if ctx.mesh is not None and ctx.out_placements:
            o0 = ctx.mesh.index(ctx.out_placements[0].dims[3]) * b
        if o0 % per_out == 0 and b % per_out == 0:
            g0, ng = o0 // per_out, b // per_out
            return [(g0 * per_in, (g0 + ng) * per_in, 0, b, ng)]
        pieces, c = [], o0
        while c < o0 + b:
            grp = c // per_out
            end = min((grp + 1) * per_out, o0 + b)
            pieces.append((grp * per_in, (grp + 1) * per_in, c - o0,
                           end - o0, 1))
            c = end
        return pieces

    def _finish(self, ctx, y, weights, dtype) -> torch.Tensor:
        """Bias (counted once over partial addends), the op's own sum
        before an activation, the activation, the input's dtype."""
        a = self.attrs
        if a["use_bias"] and ctx.partial_leader():
            y = y + weights["bias"].float()
        if a["activation"] is not None:
            y = ctx.reduce_partial(y)
        return _ACT[a["activation"]](y).to(dtype)

    def forward(self, ctx: LoweringContext, inputs, weights):
        x = inputs[0]
        y = self._conv(ctx, x, weights["kernel"])
        return [self._finish(ctx, y, weights, x.dtype)]

    def forward_sharded(self, ctx, inputs, weights, osh):
        from flexflow_tpu_torch.parallel.mesh import (
            Placement,
            grad_all_reduce,
            reshard,
        )

        x, kernel = inputs[0], weights["kernel"]
        in_pl = ctx.in_placements[0]
        r_axes = in_pl.dims[3] if self.attrs["groups"] > 1 else ()
        if not _spatial_axes(in_pl) and not r_axes:
            return None
        a = self.attrs
        x, padding = _halo_input(
            ctx, x, (a["kernel_h"], a["kernel_w"]),
            (a["stride_h"], a["stride_w"]),
            (a["padding_h"], a["padding_w"]), 0.0)
        if r_axes:
            # a group's channels do not follow an in-channel split: the
            # input's channels and the kernel's in dim are gathered whole,
            # the leader of the replica axes computes the product and the
            # other addends are zeros of it (the gradients sum back)
            n_axes, co_axes = in_pl.dims[0], ctx.out_placements[0].dims[3]
            x = grad_all_reduce(
                reshard(x, Placement((n_axes, (), (), r_axes)),
                        Placement((n_axes, (), (), ())), ctx.mesh),
                r_axes, ctx.mesh)
            kernel = grad_all_reduce(
                reshard(kernel, Placement(((), (), r_axes, co_axes)),
                        Placement(((), (), (), co_axes)), ctx.mesh),
                r_axes, ctx.mesh)
        y = self._conv(ctx, x, kernel, padding)
        if r_axes and not ctx.partial_leader():
            y = y * 0.0
        return [self._finish(ctx, y, weights, inputs[0].dtype)]

    def propagate(self, mv: MachineView) -> OpSharding:
        n, h, w, co = mv.dim_degrees
        r = mv.replica_degree  # in-channel split -> partial sums
        x_annot = ShardAnnot((n, h, w, r), replica=co,
                             idx=(0, 1, 2, REPLICA_SLOT))
        out = ShardAnnot(mv.dim_degrees, replica=r, partial=r > 1)
        wk = ShardAnnot((1, 1, r, co), replica=n * h * w,
                        idx=(-1, -1, REPLICA_SLOT, 3))
        ws = [wk]
        if self.attrs["use_bias"]:
            ws.append(ShardAnnot((co,), replica=n * h * w * r, idx=(3,)))
        return OpSharding(inputs=(x_annot,), weights=tuple(ws),
                          outputs=(out,))

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return (0, 1, 2, 3)  # sample, both spatial (OptCNN), out-channel

    def max_replica_degree(self) -> int:
        return self.input_shapes[0].sizes[-1] // self.attrs["groups"]

    def flops(self) -> float:
        a = self.attrs
        out = self.output_shapes[0]
        cin = self.input_shapes[0].sizes[-1]
        return (2.0 * out.num_elements * a["kernel_h"] * a["kernel_w"] * cin
                / a["groups"])


@register_op
class Pool2DOp(Operator):
    """attrs: kernel_h/w, stride_h/w, padding_h/w, pool_type (max|avg),
    activation. Reference: src/ops/pool_2d.cc."""

    op_type = OperatorType.POOL2D

    def __init__(
        self,
        name,
        input_shapes,
        kernel_h: int,
        kernel_w: int,
        stride_h: int = 1,
        stride_w: int = 1,
        padding_h: int = 0,
        padding_w: int = 0,
        pool_type: str = "max",
        activation: str | None = None,
    ):
        if pool_type not in ("max", "avg"):
            raise NotImplementedError(f"pool_type {pool_type!r}")
        _check_activation(type(self).__name__, activation)
        super().__init__(
            name,
            input_shapes,
            kernel_h=kernel_h,
            kernel_w=kernel_w,
            stride_h=stride_h,
            stride_w=stride_w,
            padding_h=padding_h,
            padding_w=padding_w,
            pool_type=pool_type,
            activation=activation,
        )

    def infer(self) -> Sequence[ParallelTensorShape]:
        n, h, w, c = self.input_shapes[0].sizes
        a = self.attrs
        ho = _out_size(h, a["kernel_h"], a["stride_h"], a["padding_h"])
        wo = _out_size(w, a["kernel_w"], a["stride_w"], a["padding_w"])
        return (ParallelTensorShape.make((n, ho, wo, c),
                                         self.input_shapes[0].dtype),)

    def _pool(self, x: torch.Tensor, pad=None) -> torch.Tensor:
        """The pool, NHWC in and out (``pad``: the attrs' by default)."""
        a = self.attrs
        kernel = (a["kernel_h"], a["kernel_w"])
        stride = (a["stride_h"], a["stride_w"])
        if pad is None:
            pad = (a["padding_h"], a["padding_w"])
        is_max = a["pool_type"] == "max"
        v = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        if not is_max:
            v = v.float()
        if pad[0] > kernel[0] // 2 or pad[1] > kernel[1] // 2:
            # beyond torch's half-kernel limit: pad here, pool unpadded
            v = F.pad(v, (pad[1], pad[1], pad[0], pad[0]),
                      value=float("-inf") if is_max else 0.0)
            pad = (0, 0)
        if is_max:
            y = F.max_pool2d(v, kernel, stride, pad)
        else:
            # count_include_pad: the reference divides by kh * kw
            y = F.avg_pool2d(v, kernel, stride, pad,
                             count_include_pad=True).to(x.dtype)
        return _ACT[a["activation"]](y.permute(0, 2, 3, 1))

    def forward(self, ctx, inputs, weights):
        return [self._pool(inputs[0])]

    def forward_sharded(self, ctx, inputs, weights, osh):
        if not _spatial_axes(ctx.in_placements[0]):
            return None
        a = self.attrs
        fill = float("-inf") if a["pool_type"] == "max" else 0.0
        x, pad = _halo_input(ctx, inputs[0], (a["kernel_h"], a["kernel_w"]),
                             (a["stride_h"], a["stride_w"]),
                             (a["padding_h"], a["padding_w"]), fill)
        return [self._pool(x, pad)]

    def propagate(self, mv: MachineView) -> OpSharding:
        a = ShardAnnot(mv.dim_degrees, mv.replica_degree)
        return OpSharding(inputs=(a,), weights=(), outputs=(a,))

    def splittable_output_dims(self) -> Tuple[int, ...]:
        return (0, 1, 2, 3)
