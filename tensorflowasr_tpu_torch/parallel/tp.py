"""Tensor parallelism for the Conformer family: Megatron sharding over the
``model`` axis of a ``("data", "model")`` mesh, through
``torch.distributed.tensor.parallel``.

Counterpart of ``tensorflowasr_tpu/parallel/tp.py``, whose rules
(``tp.py:46-53``) are held here in torch's layout (a ``Dense`` is an
``nn.Linear``, weight [out, in]):

- ``ffn1`` column-parallel (weight and bias ``Shard(0)``), ``ffn2``
  row-parallel (weight ``Shard(1)``, bias replicated): one all-reduce after
  ``ffn2``, none in between;
- attention ``query`` / ``key`` / ``value`` column-parallel (each rank
  computes its own heads end to end) and ``out`` row-parallel: one
  all-reduce after the output projection.

The rules match by name, so every stack shards: the encoder, the CTC
decoder and the translator's blocks. Convolutions, norms and embeddings
stay plain tensors, identical on every rank of the ``model`` axis; their
gradients are all-reduced over ``data`` only (``train/state.py``).

Divisibility is judged as JAX judges it, on the dimension it shards: the
FFN width, and the number of HEADS for attention (4 heads on a model axis
of 8 replicate, although the fused [heads x head_size, d] weight would
divide and split a head in half).

Random draws: every rank of a data group seeds its generator alike, so
dropout on the replicated activations draws the same mask on every model
rank; dropout on the sharded FFN hidden draws the full-width mask and keeps
its slice (``layers.Dropout``'s ``shard``), so the replicas never diverge
and the masks equal the unsharded model's.
"""

from __future__ import annotations

import re
from typing import Dict

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.distributed.tensor.parallel import (
    ColwiseParallel,
    RowwiseParallel,
    parallelize_module,
)

from tensorflowasr_tpu_torch.models.layers import FFModule, MultiHeadAttention
from tensorflowasr_tpu_torch.parallel import mesh as mesh_lib

# parameter-name regex -> placement over the "model" axis, in torch names,
# e.g. encoder.blocks.0.ff_module_1.ffn1.weight
_TP_RULES = [
    (re.compile(r"ffn1\.(weight|bias)$"), Shard(0)),
    (re.compile(r"ffn2\.weight$"), Shard(1)),
    (re.compile(r"mha\.(query|key|value)\.(weight|bias)$"), Shard(0)),
    (re.compile(r"mha\.out\.weight$"), Shard(1)),
]


def tp_spec(name: str) -> Placement:
    """The placement one parameter name takes over the ``model`` axis by
    rule alone (``Replicate()`` where no rule matches); see
    :func:`tp_placements` for the divisibility check."""
    for rx, placement in _TP_RULES:
        if rx.search(name):
            return placement
    return Replicate()


def _sharded_modules(model: nn.Module, model_size: int) -> Dict[str, str]:
    """{Dense module name: "colwise" | "rowwise"} for the FFN and attention
    projections whose sharded dimension divides by ``model_size``."""
    plan = {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, FFModule) and \
                m.ffn1.out_features % model_size == 0:
            plan[prefix + "ffn1"] = "colwise"
            plan[prefix + "ffn2"] = "rowwise"
        elif isinstance(m, MultiHeadAttention) and \
                m.num_heads % model_size == 0:
            for p in ("query", "key", "value"):
                plan[prefix + p] = "colwise"
            plan[prefix + "out"] = "rowwise"
    return plan


def tp_placements(model: nn.Module, model_size: int
                  ) -> Dict[str, Placement]:
    """Every parameter's placement over a ``model`` axis of ``model_size``:
    the rule's, or ``Replicate()`` where the sharded dimension (FFN width,
    attention heads) does not divide."""
    plan = _sharded_modules(model, model_size)
    out = {}
    for name, _ in model.named_parameters():
        module = name.rsplit(".", 1)[0]
        out[name] = tp_spec(name) if module in plan else Replicate()
    return out


def shard_params_tp(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Shard ``model``'s FFN and attention projections over ``mesh``'s
    ``model`` axis in place (their parameters become DTensors; every other
    parameter stays a plain tensor) and returns it. Attention reads its
    local head count from the projected width, so the same forward runs
    sharded or not."""
    tp_mesh = mesh[mesh_lib.MODEL_AXIS]
    size = tp_mesh.size()
    plan = _sharded_modules(model, size)
    styles = {"colwise": ColwiseParallel, "rowwise": RowwiseParallel}
    parallelize_module(model, tp_mesh,
                       {name: styles[kind]() for name, kind in plan.items()})
    rank = tp_mesh.get_local_rank()
    for name, m in model.named_modules():
        if isinstance(m, FFModule) and \
                f"{name + '.' if name else ''}ffn1" in plan:
            m.hidden_shard = (rank, size)
    return model


def shard_state_tp(state, mesh: DeviceMesh):
    """Shard a train state over ``mesh``: the model's projections as
    :func:`shard_params_tp` does, the optimizer's moments like their
    parameters (the same slices), the gradient all-reduce and BatchNorm
    statistics over the ``data`` axis, and the global-norm clip told which
    gradients are sharded over ``model``. Returns ``state``."""
    model, opt = state.model, state.optimizer
    old = dict(model.named_parameters())
    shard_params_tp(model, mesh)
    new = dict(model.named_parameters())
    swap = {id(p): new[k] for k, p in old.items()}

    def like(v, p):
        """A moment of parameter ``p``, placed as ``p`` is."""
        if not (isinstance(p, DTensor) and isinstance(v, torch.Tensor)
                and v.shape == p.shape):
            return v
        placement, tp_mesh = p.placements[0], p.device_mesh
        if isinstance(placement, Shard):
            v = v.chunk(tp_mesh.size(), dim=placement.dim)[
                tp_mesh.get_local_rank()]
        return DTensor.from_local(v.contiguous(), tp_mesh, p.placements,
                                  run_check=False)

    opt.params = [swap[id(p)] for p in opt.params]
    for group in opt.adam.param_groups:
        group["params"] = [swap[id(p)] for p in group["params"]]
        # a multi-tensor (foreach) update refuses DTensors beside plain
        # tensors in one list
        group["foreach"] = False
    moments = {swap[id(p)]: {k: like(v, swap[id(p)]) for k, v in s.items()}
               for p, s in opt.adam.state.items()}
    opt.adam.state.clear()
    opt.adam.state.update(moments)
    group = mesh_lib.data_group(mesh)
    opt.group = group
    opt.model_group = mesh.get_group(mesh_lib.MODEL_AXIS)
    mesh_lib.set_data_group(model, group)
    return state


# a batch is split over the ``data`` axis only: every rank of the ``model``
# axis keeps the same rows
shard_batch_dp = mesh_lib.shard_batch
