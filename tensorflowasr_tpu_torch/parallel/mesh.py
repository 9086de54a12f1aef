"""Device meshes, the data-parallel split and the collectives a train step
needs.

Counterpart of ``tensorflowasr_tpu/parallel/mesh.py``. Under GSPMD the
JAX train step is one global program over a ``data`` mesh: the batch is
sharded, the state replicated, and every reduction over the batch
(BatchNorm moments, the balance terms of ``mask_loss``, the batch mean, the
chunk model's ``t_ref``) is taken over the global batch. The port runs one
process per rank, so each of those reductions is an explicit collective
over the data group:

- :func:`global_sum` (optionally differentiable: its backward all-reduces
  the gradient, which is exact when the ranks' losses add up to the global
  loss and their gradients are summed) and :func:`global_max`;
- :func:`all_reduce_` sums gradients in place, one flat collective;
- :func:`set_data_group` hands the group to every module that reduces over
  the batch (each BatchNorm, the chunk model's ``t_ref``).

A one-process run has no process group: its mesh and group are None and
every function here is the identity. An N-rank step then equals the
one-process step on the global batch.

``data_parallel_shardings`` has no torch meaning (there are no jit
shardings to hand over) and is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from tensorflowasr_tpu_torch.parallel.multihost import (
    batch_rows,
    host_local_batch,
)

MODEL_AXIS = "model"


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Tuple[int, ...]] = None,
              device: Union[str, torch.device] = "cuda") -> DeviceMesh:
    """A mesh over every rank of the process group (rank-major, the last
    axis fastest). Default: a 1-D ``data`` axis; a multi-axis mesh needs
    ``shape``, e.g. (2, 2) with ("data", "model")."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.multihost.initialize first")
    n = dist.get_world_size()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} ranks")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def make_data_mesh(global_batch: int,
                   device: Union[str, torch.device] = "cuda"
                   ) -> Optional[DeviceMesh]:
    """1-D ``data`` mesh over every rank, or None without a process group.
    Unlike the JAX package's, it idles no rank (a rank cannot sit out): the
    batch is split as ``np.array_split`` does (:func:`batch_rows`), and
    since every reduction is global, an uneven split gives the same step.
    A global batch smaller than the number of ranks raises."""
    if not dist.is_initialized():
        return None
    n = dist.get_world_size()
    if global_batch < n:
        raise ValueError(f"global batch {global_batch} is smaller than "
                         f"{n} ranks")
    return make_mesh(device=device)


def _data_dims(mesh: DeviceMesh) -> List[int]:
    names = mesh.mesh_dim_names or ()
    return [i for i in range(mesh.ndim)
            if i >= len(names) or names[i] != MODEL_AXIS]


def data_size(mesh: Optional[DeviceMesh]) -> int:
    """Ranks the batch is split over: every axis but ``model``."""
    if mesh is None:
        return 1
    return int(np.prod([mesh.size(i) for i in _data_dims(mesh)]))


def data_rank(mesh: Optional[DeviceMesh]) -> int:
    """This rank's index along the data axes (row-major)."""
    if mesh is None:
        return 0
    dims = _data_dims(mesh)
    coord = mesh.get_coordinate()
    return int(np.ravel_multi_index([coord[i] for i in dims],
                                    [mesh.size(i) for i in dims]))


def data_group(mesh: Optional[DeviceMesh]):
    """The process group of this rank's data axes, or None without a
    mesh."""
    if mesh is None:
        return None
    dims = _data_dims(mesh)
    if len(dims) == mesh.ndim:
        return mesh.get_group(0) if mesh.ndim == 1 else dist.group.WORLD
    if len(dims) != 1:
        raise ValueError(f"one data axis beside {MODEL_AXIS!r} expected, "
                         f"got {mesh.mesh_dim_names}")
    return mesh.get_group(dims[0])


def batch_spec(mesh: DeviceMesh) -> Tuple[Shard, ...]:
    """The placement of a batch: its leading axis sharded over every mesh
    axis (a DTensor placement per mesh dimension)."""
    return tuple(Shard(0) for _ in range(mesh.ndim))


def local_batch_size(global_batch: int, mesh: Optional[DeviceMesh]) -> int:
    """The rows of ``global_batch`` this rank keeps."""
    rows = batch_rows(global_batch, data_size(mesh), data_rank(mesh))
    return rows.stop - rows.start


def shard_batch(batch: Dict[str, np.ndarray], mesh: Optional[DeviceMesh],
                device: Union[str, torch.device, None] = None
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a numpy batch [B, ...] as tensors on ``device``
    (``*_host`` length copies kept, ``multihost.host_local_batch``);
    scalars are kept whole."""
    n, i = data_size(mesh), data_rank(mesh)
    local = {}
    for k, v in batch.items():
        v = np.asarray(v)
        local[k] = v[batch_rows(v.shape[0], n, i)] if v.ndim >= 1 else v
    return host_local_batch(local, mesh, device)


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage), any other tensor
    itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def replicate(state, mesh: Optional[DeviceMesh]):
    """Broadcast a train state's (or a module's) parameters, buffers and
    optimizer moments from data rank 0 to every rank of its data group, in
    place; returns ``state``. Sharded (tensor-parallel) leaves broadcast
    their local shards along the data axis."""
    group = data_group(mesh)
    if group is None:
        return state
    src = dist.get_global_rank(group, 0)
    model = getattr(state, "model", state)
    tensors = [local_shard(t) for t in model.state_dict().values()
               if isinstance(t, torch.Tensor)]
    optimizer = getattr(state, "optimizer", None)
    if optimizer is not None:
        for per_param in optimizer.adam.state.values():
            tensors += [local_shard(v) for v in per_param.values()
                        if isinstance(v, torch.Tensor)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=src, group=group)
    return state


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the incoming gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def global_sum(x: torch.Tensor, group, differentiable: bool = False
               ) -> torch.Tensor:
    """``x`` summed over ``group`` (``x`` itself without a group). With
    ``differentiable``, the gradient flows back to every rank's ``x``."""
    if group is None:
        return x
    if differentiable:
        return _AllReduceSum.apply(x, group)
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def global_max(x: torch.Tensor, group) -> torch.Tensor:
    """``x``'s elementwise maximum over ``group`` (no gradient)."""
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_reduce_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor over ``group`` in place, as one flat collective."""
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def set_data_group(model: torch.nn.Module, group) -> None:
    """Hand the data group to every module of ``model`` that reduces over
    the batch (``data_group`` attribute: each BatchNorm, the chunk model);
    None makes them per-rank again."""
    for m in model.modules():
        if hasattr(m, "data_group"):
            m.data_group = group


def rank_seed(seed: int, rank: int, step: int = 0) -> int:
    """A generator seed for data rank ``rank`` at ``step``: ``seed`` itself
    for rank 0 at step 0, apart for every other (rank, step), so ranks draw
    different dropout and SpecAugment masks and a resumed run does not
    replay its first ones."""
    return (int(seed) + int(rank) * 0x9E3779B97F4A7C15
            + int(step) * 0xBF58476D1CE4E5B9) % (2 ** 63)
