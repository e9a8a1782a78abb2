"""Differentiable collectives over a process group.

``group=None`` means no group: one process, and every function here
returns its input. A real group, of size 1 too, runs the collective.

Gradient convention. The train step runs one backward a process, from the
loss that process computed, and then averages the parameter gradients
over the data group (``train/trainer.py``). Summed over the processes,
those backward seeds are ``world`` times the global loss, so each
collective's backward is its exact transpose with respect to that sum:

* :func:`all_gather_rows` (every process gets every process's rows): the
  gradient of a process's rows is the sum of the gradients of every copy
  of them (a reduce-scatter);
* :func:`all_reduce_mean` (every process gets the mean, e.g. BatchNorm's
  global statistics): the gradient of each input is the mean of the
  outputs' gradients (an all-reduce mean, SyncBatchNorm's backward);
* :func:`value_mean` (a loss reported as its mean over the group, as
  JAX's ``pmean``): the gradient is that of the process's own input,
  since each process seeds the backward of its own part.

With those, the mean of the processes' gradients is the gradient of the
global loss (``tests/test_torch_multiproc.py`` holds it against one
process fed the concatenated batch).

Tensor parallelism adds Megatron's functions over the model group, whose
processes share their rows and so seed the same loss: a value every
process holds whole (replicated) and a value each holds its part of
(split: its heads, or its columns) meet through

* :func:`copy_to_group`, in front of a column-split layer, and on any
  replicated tensor that enters split arithmetic whole (the Container
  gate): the forward passes it on, the backward sums the processes'
  partial gradients;
* :func:`reduce_from_group`, behind a row-split layer: the forward sums
  the partial outputs;
* :func:`scatter_to_group`: a replicated value cut to this process's part
  (LoRA's delta of q, k or v; ConViT's positional attention of its heads);
  the backward gathers the parts' gradients, so every process holds the
  whole gradient;
* :func:`gather_from_group`: the parts made whole (the context that
  LoRA's output projection or Container's convolution reads whole); the
  backward keeps this process's part of the (replicated) gradient.

Each keeps the replicated tensors' gradients whole and the same on every
process of the model group, so only the data group averages them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd import Function


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def global_rank(group, rank: int) -> int:
    """The global rank of ``rank`` within ``group``."""
    return dist.get_global_rank(group, rank)


def reduce_scatter_rows(x, group, op=dist.ReduceOp.SUM):
    """``x`` ``[n * m, ...]`` reduced over the group, this process's block
    of ``m`` rows returned."""
    out = x.new_empty((x.shape[0] // group_size(group),) + x.shape[1:])
    dist.reduce_scatter_tensor(out, x.contiguous(), op=op, group=group)
    return out


def gather_rows(x, group):
    """Every process's ``x`` ``[m, ...]`` concatenated in group-rank order,
    ``[n * m, ...]``, without autograd."""
    out = x.new_empty((group_size(group) * x.shape[0],) + x.shape[1:])
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


class _AllGatherRows(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group), None


def all_gather_rows(x, group):
    """Differentiable :func:`gather_rows` (the backward reduce-scatters)."""
    if group is None:
        return x
    return _AllGatherRows.apply(x, group)


def _mean(x, group):
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y / group_size(group)


class _AllReduceMean(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _mean(x, group)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.group), None


def all_reduce_mean(x, group):
    """The mean of ``x`` over the group on every process; its backward is
    the mean of the gradients."""
    if group is None:
        return x
    return _AllReduceMean.apply(x, group)


class _ValueMean(Function):
    @staticmethod
    def forward(ctx, x, group):
        return _mean(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def value_mean(x, group):
    """The mean of ``x`` over the group as the value, ``x``'s own gradient
    as the gradient (see the module's convention)."""
    if group is None:
        return x
    return _ValueMean.apply(x, group)


def rotate(tensors, group):
    """Send each tensor to the previous group rank and receive the next
    rank's (JAX's ``ppermute`` with ``j -> j - 1``): after ``t`` calls,
    group rank ``i`` holds what rank ``(i + t) % n`` started with."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    r = group_rank(group)
    prev = global_rank(group, (r - 1) % n)
    nxt = global_rank(group, (r + 1) % n)
    received = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, got in zip(tensors, received):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), prev, group))
        ops.append(dist.P2POp(dist.irecv, got, nxt, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


class _CopyToGroup(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x, group):
    """Megatron's ``f``: the input of a column-split layer, the same on
    every process of the model group; its backward sums the processes'
    gradients (each saw only its columns)."""
    if group is None:
        return x
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """Megatron's ``g``: the sum over the model group of a row-split
    layer's partial outputs; its backward passes the gradient on, the same
    on every process."""
    if group is None:
        return x
    return _ReduceFromGroup.apply(x, group)


def _part(x, group, dim):
    return x.chunk(group_size(group), dim=dim)[group_rank(group)]


def _gather_dim(x, group, dim):
    return gather_rows(x.movedim(dim, 0), group).movedim(0, dim)


class _ScatterToGroup(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _part(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.group, ctx.dim), None, None


class _GatherFromGroup(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _part(g, ctx.group, ctx.dim).contiguous(), None, None


def scatter_to_group(x, group, dim: int = -1):
    """This process's part of the replicated ``x``: its chunk of ``dim``
    in group-rank order (the model rank's heads: ``mesh.tp_split``); the
    backward gathers the chunks' gradients."""
    if group is None:
        return x
    return _ScatterToGroup.apply(x, group, dim % x.ndim)


def gather_from_group(x, group, dim: int = -1):
    """Every process's part ``x`` concatenated along ``dim`` in group-rank
    order; the backward keeps this process's chunk of the gradient, which
    is whole and the same on every process downstream."""
    if group is None:
        return x
    return _GatherFromGroup.apply(x, group, dim % x.ndim)
