"""The (data, model) mesh over a ``torch.distributed`` process group (port
of ``deepmerge_tpu/parallel/mesh.py``).

One process per rank. The ranks are laid out as the JAX package lays out
its devices, ``reshape(n_data, n_model)``: rank ``d · n_model + m`` has
data coordinate ``d`` and model coordinate ``m``. ``data`` shards every
batch axis (pairs, points, edges); ranks that share a data coordinate
compute the same rows, as the JAX mesh does with replicated parameters.
Collectives are ``all_reduce`` (SUM, MIN) and ``broadcast`` only, on
whatever backend the caller started (NCCL on the card, gloo on the CPU).

``model`` is tensor parallelism, the JAX package's Megatron rules
(``_TP_RULES``) made explicit: ``shard_params`` gives each rank its heads'
slices of the attention and its slice of the MLP's hidden layer, an
S2Former built for the mesh (``models.s2former.S2Former(cfg, mesh)``) runs
its blocks on them, and two autograd functions place the collectives GSPMD
would insert: ``copy_to_model`` (Megatron's f, before qkv and fc1) and
``reduce_from_model`` (g, after proj and fc2).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

NO_GROUP = (
    "mesh: no torch.distributed process group — start one rank per device "
    "under torchrun (`torchrun --nproc_per_node=N -m "
    "deepmerge_tpu_torch ... --mesh`, which calls "
    "parallel.distributed.initialize()), or call "
    "torch.distributed.init_process_group(init_method='tcp://localhost:"
    "<port>', world_size=N, rank=r) in each process first"
)


@dataclass
class Mesh:
    """This rank's view of the (data, model) mesh: ``shape`` as
    ``{"data": n_data, "model": n_model}``, the rank, its ``coords``, the
    group of the ranks along its data axis (those with its model
    coordinate; ``None`` is the whole world, when ``n_model`` is 1), the
    rank's device, and the group of the ranks along its model axis (those
    with its data coordinate; ``None`` when ``n_model`` is 1)."""

    shape: dict
    rank: int
    coords: dict
    data_group: Any
    device: torch.device
    model_group: Any = None


def _local_device(devices) -> torch.device:
    """This rank's device: ``devices`` is one device, or one per rank in
    rank order; by default ``cuda:LOCAL_RANK``."""
    from deepmerge_tpu_torch.utils.device import resolve_device

    if devices is None:
        devices = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    elif isinstance(devices, (list, tuple)):
        devices = devices[dist.get_rank()]
    return resolve_device(devices)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices=None, ranks=None) -> Optional[Mesh]:
    """The mesh over the current process group (``n_data`` defaults to the
    world size over ``n_model``). Every rank must call it: a model axis
    above 1 creates one data-axis group per model coordinate, then one
    model-axis group per data coordinate, in that order on every rank.

    ``ranks`` gives a data-only mesh over those ranks of the world alone,
    in a group of their own (``dist.new_group``, which every rank of the
    world calls); a rank outside ``ranks`` gets None."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(NO_GROUP)
    if ranks is not None:
        ranks = list(ranks)
        assert n_model == 1 and n_data in (None, len(ranks)), (
            f"a mesh over ranks {ranks} is {len(ranks)}x1")
        group = dist.new_group(ranks)
        if dist.get_rank() not in ranks:
            return None
        i = ranks.index(dist.get_rank())
        return Mesh(shape={"data": len(ranks), "model": 1}, rank=i,
                    coords={"data": i, "model": 0}, data_group=group,
                    device=_local_device(devices))
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, (
        f"mesh {n_data}x{n_model} != {world} ranks")
    rank = dist.get_rank()
    group = model_group = None
    if n_model > 1:
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if rank % n_model == m:
                group = g
        for d in range(n_data):
            g = dist.new_group([d * n_model + m for m in range(n_model)])
            if rank // n_model == d:
                model_group = g
    return Mesh(shape={"data": n_data, "model": n_model}, rank=rank,
                coords={"data": rank // n_model, "model": rank % n_model},
                data_group=group, device=_local_device(devices),
                model_group=model_group)


def shard_rows(n: int, mesh: Mesh, axis: str = "data") -> slice:
    """This rank's contiguous rows of a leading axis of ``n`` rows (``n``
    divisible by the axis size, as a sharded JAX array needs)."""
    s = mesh.shape[axis]
    assert n % s == 0, f"{n} rows do not split over {s} {axis} ranks"
    k = n // s
    return slice(mesh.coords[axis] * k, (mesh.coords[axis] + 1) * k)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of every leaf of a batch (tensors and arrays in
    dicts, lists and tuples), its leading axis split over ``data``."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return batch[shard_rows(batch.shape[0], mesh)]
    return batch


def _broadcast_(t: torch.Tensor, mesh: Mesh) -> None:
    """Broadcast ``t`` from the mesh's rank 0 in place; a tensor off the
    mesh's device (Adam's step counts on the CPU under NCCL) travels
    through it. A data-only mesh broadcasts in its own group (the whole
    world, unless ``make_mesh`` was given ``ranks``)."""
    group = mesh.data_group if mesh.model_group is None else None
    src = 0 if group is None else dist.get_global_rank(group, 0)
    if t.device == mesh.device or dist.get_backend() == "gloo":
        dist.broadcast(t, src=src, group=group)
    else:
        buf = t.to(mesh.device)
        dist.broadcast(buf, src=src, group=group)
        t.copy_(buf)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Broadcast every tensor of ``tree`` (a state dict, an optimizer's
    state, nested dicts, lists and tuples, or a module's parameters and
    buffers) from rank 0, in place; returns ``tree``."""
    if isinstance(tree, torch.nn.Module):
        replicate(tree.state_dict(keep_vars=True), mesh)
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            replicate(v, mesh)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(v, mesh)
    elif isinstance(tree, torch.Tensor):
        with torch.no_grad():
            _broadcast_(tree.data if tree.requires_grad else tree, mesh)
    return tree


def all_reduce_(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """``all_reduce`` of ``t`` in place over the mesh's data axis."""
    dist.all_reduce(t, op=op, group=mesh.data_group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The SUM over the data axis, differentiable: the gradient of a sum
    replicated on every rank is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The differentiable SUM of ``x`` over the data axis."""
    return _AllReduceSum.apply(x, mesh.data_group)


@dataclass
class BatchShard:
    """A training forward that computes only this rank's rows of a global
    batch. It rides where the forward takes its dropout generator: every
    mask is drawn for the ``batch`` rows of the global batch from
    ``generator`` and cut to ``rows`` (so the masks do not depend on the
    world size), and BatchNorm's moments are summed over the mesh's data
    axis (so its statistics are the global batch's)."""

    generator: torch.Generator
    rows: torch.Tensor
    batch: int
    mesh: Mesh

    def rand(self, shape) -> torch.Tensor:
        """Uniform draws of ``shape`` (this rank's rows first) as the
        global batch's rows ``rows``."""
        full = torch.rand((self.batch,) + tuple(shape[1:]),
                          generator=self.generator,
                          device=self.generator.device)
        return full.index_select(0, self.rows.to(full.device))


# the tensor-parallel split of each block parameter, by name suffix: the
# axis cut and how ("heads": the q, k and v thirds of the rows, each cut
# alike; "slice": one contiguous cut). The rest is replicated, the proj and
# fc2 biases too: they are added once, after the reduction.
_TP_SPLITS = (
    ("attn.qkv.weight", 0, "heads"),
    ("attn.qkv.bias", 0, "heads"),
    ("attn.relative_position_bias_table", 1, "slice"),
    ("attn.proj.weight", 1, "slice"),
    ("mlp.fc1.weight", 0, "slice"),
    ("mlp.fc1.bias", 0, "slice"),
    ("mlp.fc2.weight", 1, "slice"),
)


def _tp_split(name: str):
    for suffix, axis, how in _TP_SPLITS:
        if name.endswith(suffix):
            return axis, how
    return None


def _tp_index(name: str, full: int, how: str, mesh: Mesh) -> torch.Tensor:
    """This rank's indices along the split axis of a ``full``-long one:
    for "heads" its C/n rows of each third (the q, k and v rows of heads
    [m·H/n, (m+1)·H/n)), else its contiguous 1/n."""
    n, m = mesh.shape["model"], mesh.coords["model"]
    parts = 3 if how == "heads" else 1
    if full % (parts * n):
        raise ValueError(f"shard_params: {name} has {full} rows along its "
                         f"split axis, not divisible into {parts} x {n}")
    k = full // (parts * n)
    return torch.cat([torch.arange(p * n * k + m * k, p * n * k + (m + 1) * k)
                      for p in range(parts)])


def shard_params(state_dict: dict, mesh: Mesh) -> dict:
    """This rank's slices of a reference-named ``state_dict`` for the
    mesh's model axis, under the same names: qkv's weight and bias the q,
    k and v rows of heads [m·H/n, (m+1)·H/n) (not JAX's contiguous 3C/n
    columns, a layout GSPMD reshards), the relative-position bias table
    those heads' columns, proj's weight their input columns, fc1's weight
    and bias contiguous output rows, fc2's weight the matching input
    columns; everything else as it is. An identity when ``n_model`` is
    1."""
    if mesh.shape["model"] == 1:
        return dict(state_dict)
    out = {}
    for name, t in state_dict.items():
        split = _tp_split(name)
        if split is None:
            out[name] = t
            continue
        axis, how = split
        idx = _tp_index(name, t.shape[axis], how, mesh).to(t.device)
        out[name] = t.index_select(axis, idx)
    return out


def gather_params(state_dict: dict, mesh: Mesh) -> dict:
    """The inverse of ``shard_params``: the whole reference layout from
    every rank's slices, on every rank of the model group (each slice
    summed into zeros there: ``all_reduce`` is the port's only gathering
    collective). The counterpart of ``jax.device_get`` on sharded leaves.
    An identity when ``n_model`` is 1."""
    if mesh.shape["model"] == 1:
        return dict(state_dict)
    n = mesh.shape["model"]
    out = {}
    for name, t in state_dict.items():
        split = _tp_split(name)
        if split is None:
            out[name] = t
            continue
        axis, how = split
        shape = list(t.shape)
        shape[axis] *= n
        full = t.new_zeros(shape)
        idx = _tp_index(name, shape[axis], how, mesh).to(t.device)
        full.index_copy_(axis, idx, t.detach())
        on_device = t.device == mesh.device or dist.get_backend() == "gloo"
        buf = full if on_device else full.to(mesh.device)
        dist.all_reduce(buf, group=mesh.model_group)
        out[name] = buf if on_device else buf.to(t.device)
    return out


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward; backward, the SUM over the model
    axis of the ranks' partial gradients (each rank's branch reaches the
    input through its own heads or hidden units only)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the SUM over the model axis of the ranks' partial
    products forward; backward, the identity (the sum's gradient is the
    same on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's f over the mesh's model axis (before qkv and fc1)."""
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Megatron's g over the mesh's model axis (after proj and fc2)."""
    return _ReduceFromModel.apply(x, mesh.model_group)
