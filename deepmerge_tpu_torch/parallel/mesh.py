"""The (data, model) mesh over a ``torch.distributed`` process group (port
of ``deepmerge_tpu/parallel/mesh.py``).

One process per rank. The ranks are laid out as the JAX package lays out
its devices, ``reshape(n_data, n_model)``: rank ``d · n_model + m`` has
data coordinate ``d`` and model coordinate ``m``. ``data`` shards every
batch axis (pairs, points, edges); ranks that share a data coordinate
compute the same rows, as the JAX mesh does with replicated parameters.
Collectives are ``all_reduce`` (SUM, MIN) and ``broadcast`` only, on
whatever backend the caller started (NCCL on the card, gloo on the CPU).

``shard_params`` (the JAX package's Megatron tensor-parallel rules) is not
ported: the port's block kernels take whole weights.
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
    coordinate; ``None`` is the whole world, when ``n_model`` is 1) and
    the rank's device."""

    shape: dict
    rank: int
    coords: dict
    data_group: Any
    device: torch.device


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
              devices=None) -> Mesh:
    """The mesh over the current process group (``n_data`` defaults to the
    world size over ``n_model``). Every rank must call it: a model axis
    above 1 creates one data-axis group per model coordinate."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(NO_GROUP)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model == world, (
        f"mesh {n_data}x{n_model} != {world} ranks")
    rank = dist.get_rank()
    group = None
    if n_model > 1:
        for m in range(n_model):
            g = dist.new_group([d * n_model + m for d in range(n_data)])
            if rank % n_model == m:
                group = g
    return Mesh(shape={"data": n_data, "model": n_model}, rank=rank,
                coords={"data": rank // n_model, "model": rank % n_model},
                data_group=group, device=_local_device(devices))


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
    """Broadcast ``t`` from rank 0 in place; a tensor off the mesh's device
    (Adam's step counts on the CPU under NCCL) travels through it."""
    if t.device == mesh.device or dist.get_backend() == "gloo":
        dist.broadcast(t, src=0)
    else:
        buf = t.to(mesh.device)
        dist.broadcast(buf, src=0)
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


def shard_params(params: Any, mesh: Mesh) -> Any:
    """The JAX package's tensor-parallel rules are not ported."""
    raise NotImplementedError(
        "shard_params: tensor parallelism (the Megatron rules of the JAX "
        "package) is not ported — the port's block kernels take whole "
        "weights (ROADMAP.md queue A, A3b)")
