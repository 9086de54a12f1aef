"""The process group: one process per card, several hosts.

Counterpart of ``tensorflowasr_tpu/parallel/multihost.py``. Where the JAX
package starts ``jax.distributed`` and lets GSPMD place one program over
every device, the port runs one process per card (``torchrun``) joined by a
``torch.distributed`` process group:

- :func:`initialize`        - the process group (a no-op for one process);
- :func:`make_hybrid_mesh`  - a ``("dcn_data", "data")`` mesh of (nodes,
  ranks per node);
- :func:`batch_rows` / :func:`process_batch_slice` - which rows of the
  global batch a rank keeps;
- :func:`host_local_batch`  - this rank's numpy rows on this rank's device.

Every rank runs the same seeded loader, so it sees the same global batch
and keeps its own rows: step shapes agree across ranks as the bucketed
loaders guarantee.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

BACKENDS = ("nccl", "gloo")


def default_backend(device: Union[str, torch.device]) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: Union[str, torch.device] = "cuda") -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``; a no-op for ``num_processes`` None or 1.

    ``coordinator_address`` is ``host:port`` (TCP) or an init-method URL
    such as ``file:///path/rdzv``. ``backend`` defaults to NCCL for a CUDA
    ``device`` and gloo for the CPU; nothing retries with another one."""
    if num_processes is None or num_processes <= 1:
        return
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if coordinator_address is None:
        raise ValueError("several processes need a coordinator_address")
    init = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init,
                            world_size=int(num_processes),
                            rank=int(process_id))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_hybrid_mesh(axis_names=("dcn_data", "data"),
                     device: Union[str, torch.device] = "cuda"
                     ) -> DeviceMesh:
    """(nodes, ranks per node) mesh, both axes data parallel. The ranks per
    node are torchrun's ``LOCAL_WORLD_SIZE`` (every rank on one node when
    it is not set)."""
    world = process_count()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_node:
        raise ValueError(f"{world} ranks do not fill nodes of {per_node}")
    return DeviceMesh(torch.device(device).type,
                      torch.arange(world).reshape(world // per_node,
                                                  per_node),
                      mesh_dim_names=tuple(axis_names))


def batch_rows(global_batch: int, n: int, i: int) -> slice:
    """Rank ``i``'s rows of ``global_batch`` over ``n`` ranks, as
    ``np.array_split`` cuts them: the first ``global_batch % n`` ranks take
    one row more. The one rule for which rows a rank keeps."""
    per, extra = divmod(global_batch, n)
    start = i * per + min(i, extra)
    return slice(start, start + per + (1 if i < extra else 0))


def process_batch_slice(global_batch: int) -> slice:
    """Rows of the global batch this process keeps (:func:`batch_rows`),
    with the JAX package's check that the batch divides by the number of
    processes (the trainers split an uneven batch too,
    ``parallel/mesh.py::shard_batch``)."""
    n = process_count()
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return batch_rows(global_batch, n, process_index())


def host_local_batch(local_batch: Dict[str, np.ndarray], mesh=None,
                     device: Union[str, torch.device, None] = None
                     ) -> Dict[str, torch.Tensor]:
    """This rank's numpy rows -> tensors on this rank's device (``device``,
    else the mesh's device type). The length vectors the CTC losses read on
    the host also stay behind as ``*_host`` CPU tensors."""
    if device is None:
        device = mesh.device_type if mesh is not None else "cpu"
    out = {}
    for k, v in local_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k.endswith("_length"):
            out[k + "_host"] = t
        out[k] = t.to(device, non_blocking=True)
    return out
