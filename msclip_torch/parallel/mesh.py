"""The process mesh and the sharding rules (``msclip_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``('data', 'model')`` mesh and
lets XLA insert the collectives. The port's mesh is the same grid of
processes (one process a device): global rank ``r`` sits at data index
``r // model`` and model index ``r % model`` (JAX's
``devices.reshape(data, model)``), and :class:`Mesh` holds the ``data``
group (the processes that share a model index: the batch is split over
them) and the ``model`` group (those that share a data index).

The rules say which dim of each tensor is split, keyed on the port's
parameter names (the reference ``state_dict`` keys): they pick, for every
tensor, the dim the JAX rule picks for its leaf. JAX linear weights are
``[in, out]`` and its convs HWIO where the port's are ``[out, in]`` and
OIHW (``utils/convert.py``), so each rule is taken in the JAX layout and
mapped back.

* :func:`param_dim`: tensor parallelism (``_param_pspec``);
* :func:`fsdp_dims` (``fsdp_param_shardings``, ``TPU.FSDP``): every
  tensor of at least ``min_size`` elements split over ``data`` on its
  largest free dim that the data size divides;
* :func:`zero1_dims` (``optstate_shardings``, ``TPU.ZERO1``): the AdamW
  moments of every tensor whose leading (JAX-layout) dim the data size
  divides.

:func:`split_for_model` cuts the tensor-parallel tensors to a model
rank's part (the qkv in-projection by heads, so K1 and K2 run unchanged on
``H / model`` heads) and :func:`gather_over_model` makes them whole again.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..utils.comm import initialized
from .collectives import gather_rows, group_size

_LINEAR_SUFFIXES = ("attn.in_proj_weight", "attn.out_proj.weight",
                    "mlp.c_fc.weight", "mlp.c_proj.weight")


@dataclass(frozen=True)
class Mesh:
    """A ``data x model`` grid of processes and this process's place in
    it. ``data_group``/``model_group`` are None for a single process with
    no process group (every collective is then skipped)."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def create_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh over every process of the default group (one process
    without a group); ``data=-1`` takes what ``model`` leaves. Every
    process must call it, in the same order (it creates the groups)."""
    world = dist.get_world_size() if initialized() else 1
    if data == -1:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} processes")
    if not initialized():
        return Mesh(data, model)
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(model):  # every process creates every group
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return Mesh(data, model, rank, data_group, model_group)


def mesh_from_config(config) -> Mesh:
    return create_mesh(config.TPU.MESH_DATA, config.TPU.MESH_MODEL)


def jax_axes(key: str, ndim: int):
    """``axes[j]``: the port dim of the JAX leaf's dim ``j`` for the
    tensor ``key`` (``utils/convert.py``'s kinds)."""
    if ndim == 4:  # conv: JAX HWIO, port OIHW
        return (2, 3, 1, 0)
    if ndim == 2 and key.endswith(_LINEAR_SUFFIXES):  # [in, out] / [out, in]
        return (1, 0)
    return tuple(range(ndim))


def _jax_tp_dim(key: str, ndim: int):
    """``_param_pspec`` in the JAX layout: the split dim, or None. The
    Gumbel family's specific block (``<block>.specific_attn.*``,
    ``.specific_mlp.*``) is a block under JAX's ``specific/attn`` and
    ``specific/mlp``."""
    parts = [p[len("specific_"):] if p.startswith("specific_") else p
             for p in key.split(".")]
    if "attn" in parts:
        if key.endswith(("in_proj_weight", "in_proj_bias")):
            return 1 if ndim == 2 else 0  # qkv column split
        if key.endswith("out_proj.weight"):
            return 0  # row split
        return None
    if "mlp" in parts:
        if "c_fc" in parts:
            return 1 if ndim == 2 else 0
        if "c_proj" in parts and parts[-1] == "weight":
            return 0
    return None


def param_dim(key: str, shape):
    """The port dim that tensor parallelism splits over ``model`` (qkv and
    ``c_fc`` column-split, ``out_proj`` and ``c_proj`` row-split, the
    rest replicated), or None."""
    j = _jax_tp_dim(key, len(shape))
    return None if j is None else jax_axes(key, len(shape))[j]


def fsdp_dim(key: str, shape, n_data: int, model: int = 1,
             min_size: int = 65536):
    """``fsdp_param_shardings`` for one tensor: None below ``max(min_size,
    n_data)`` elements; else the largest dim (the first of equals, in the
    JAX layout) that tensor parallelism leaves free and ``n_data``
    divides, or None if there is none."""
    ndim = len(shape)
    size = 1
    for s in shape:
        size *= s
    if ndim == 0 or size < max(min_size, n_data):
        return None
    axes = jax_axes(key, ndim)
    jshape = [shape[a] for a in axes]
    taken = _jax_tp_dim(key, ndim) if model > 1 else None
    best = None
    for d in range(ndim):
        if (d != taken and jshape[d] >= n_data and jshape[d] % n_data == 0
                and (best is None or jshape[d] > jshape[best])):
            best = d
    return None if best is None else axes[best]


def zero1_dim(key: str, shape, n_data: int):
    """``optstate_shardings`` for the moments of one tensor: the port dim
    of the JAX leaf's leading dim when ``n_data`` divides it, else None
    (scalars and indivisible tensors stay whole)."""
    if len(shape) == 0:
        return None
    d = jax_axes(key, len(shape))[0]
    return d if shape[d] >= n_data and shape[d] % n_data == 0 else None


def fsdp_dims(params, n_data: int, model: int = 1, min_size: int = 65536):
    """``{key: dim or None}`` of :func:`fsdp_dim` for every tensor."""
    return {k: fsdp_dim(k, tuple(v.shape), n_data, model, min_size)
            for k, v in params.items()}


def zero1_dims(params, n_data: int, model: int = 1):
    """``{key: dim or None}`` of :func:`zero1_dim` for every tensor; with
    ``model > 1`` the tensor-parallel tensors keep their split and no
    other (JAX: a leaf already sharded keeps its sharding)."""
    return {k: None if model > 1 and param_dim(k, tuple(v.shape)) is not None
            else zero1_dim(k, tuple(v.shape), n_data)
            for k, v in params.items()}


def _qkv_rows(n: int, m: int, r: int):
    """The rows of an ``[n = 3E, ...]`` in-projection that hold model rank
    ``r``'s heads: its ``E / m`` rows of each of q, k and v, so that each
    head keeps its q, k and v on one rank."""
    e = n // 3
    return torch.cat([torch.arange(j * e + r * e // m,
                                   j * e + (r + 1) * e // m)
                      for j in range(3)])


def tp_split(key: str, t, m: int, r: int):
    """Model rank ``r``'s part of the tensor ``key`` (:func:`param_dim`),
    the qkv in-projection split by heads; the tensor itself when it is
    not split."""
    d = param_dim(key, tuple(t.shape))
    if d is None or m == 1:
        return t
    if key.endswith(("in_proj_weight", "in_proj_bias")):
        return t[_qkv_rows(t.shape[0], m, r)].clone()
    return t.chunk(m, dim=d)[r].clone(memory_format=torch.contiguous_format)


def tp_gather(key: str, t, group):
    """The whole tensor ``key`` from every model rank's :func:`tp_split`
    part ``t`` (a collective over ``group``; no autograd)."""
    t = t.detach()
    m = group_size(group)
    d = param_dim(key, tuple(t.shape))
    if d is None or m == 1:
        return t
    whole = gather_rows(t.movedim(d, 0), group).movedim(0, d).contiguous()
    if key.endswith(("in_proj_weight", "in_proj_bias")):
        order = torch.cat([_qkv_rows(whole.shape[0], m, r)
                           for r in range(m)])
        whole = whole[torch.argsort(order)]
    return whole


def split_for_model(params, mesh: Mesh):
    """``params`` with every tensor-parallel tensor cut to this process's
    part (``{key: tensor}``; unchanged when ``mesh.model == 1``)."""
    if mesh.model == 1:
        return dict(params)
    return {k: tp_split(k, v, mesh.model, mesh.model_rank)
            for k, v in params.items()}


def gather_over_model(params, mesh: Mesh):
    """The inverse of :func:`split_for_model`: whole tensors from every
    model rank's parts (a collective)."""
    if mesh.model == 1:
        return dict(params)
    return {k: tp_gather(k, v, mesh.model_group) for k, v in params.items()}
