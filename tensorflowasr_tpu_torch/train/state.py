"""Train state and optimizer / schedule factories.

Counterpart of ``tensorflowasr_tpu/train/state.py``. The recipe is plain
Adam(lr=1e-4, b1=0.9, b2=0.98, eps=1e-6) (``optimizer_config`` in
``configs/am_data.yml``); the transformer warmup schedule is available via
``use_warmup``. :class:`Optimizer` wraps ``torch.optim.Adam`` with what the
JAX package composes from optax: a schedule read at each update, optional
clipping by the global norm, and ``grad_accum_steps`` k with the semantics
of ``optax.MultiSteps`` (the MEAN of k micro-gradients, one update every
k-th call, clipping acts on the mean).

Under data parallelism the optimizer holds the data group
(``parallel/mesh.py``) and sums the gradients over it in the update call,
after accumulation and before the division by the count and the clip: one
flat all-reduce per update, GSPMD's gradient psum. Under tensor parallelism
(``parallel/tp.py``) a sharded parameter's gradient is a DTensor whose
local shard is all-reduced over ``data`` like any other, and the global
norm adds the squares of the sharded gradients over the ``model`` group
(the replicated ones count once).

The full state (model with its BatchNorm buffers, optimizer, step, the
generator that dropout draws from) is one object, checkpointed as one file.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from tensorflowasr_tpu_torch.parallel.mesh import (
    all_reduce_,
    global_sum,
    local_shard,
)


def transformer_schedule(dmodel: int, warmup_steps: int = 10000,
                         peak_scale: float = 1.0) -> Callable[[int], float]:
    """lr = d^-0.5 * min(step^-0.5, step * warmup^-1.5), with step =
    max(count, 1): the count of updates made so far starts at 0, so the
    first two updates share one rate."""

    def schedule(count: int) -> float:
        step = max(float(count), 1.0)
        return peak_scale * dmodel ** -0.5 * min(
            step ** -0.5, step * warmup_steps ** -1.5)

    return schedule


class Optimizer:
    """Adam with a schedule, global-norm clipping and gradient accumulation.

    Call :meth:`step` once after every backward pass. Gradients add up in
    ``param.grad`` over ``accum_steps`` calls; the last of them divides by
    the count, clips, sets the rate from the schedule (read at the number of
    updates made so far), updates and clears the gradients. Nothing here
    reads a value back from the device.

    ``group`` (set by the trainer) is the data group the gradients are
    summed over; ``model_group`` the tensor-parallel group whose shards
    the clip's norm adds up. Every rank runs the same modules, so every
    rank holds gradients for the same parameters. ``grad_norm`` keeps the
    global norm the last clip computed (after the all-reduce and the
    division), a device scalar.
    """

    def __init__(self, params, lr: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.98, eps: float = 1e-6,
                 grad_clip_norm: Optional[float] = None,
                 accum_steps: int = 1):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = lr if callable(lr) else None
        self.adam = torch.optim.Adam(
            self.params, lr=0.0 if callable(lr) else float(lr),
            betas=(b1, b2), eps=eps)
        self.grad_clip_norm = grad_clip_norm
        self.accum_steps = int(accum_steps)
        self.count = 0          # updates made
        self.mini_step = 0      # backward passes since the last update
        self.group = None
        self.model_group = None
        self.grad_norm = None   # the last clip's global norm (device)

    def _global_norm(self, grads) -> torch.Tensor:
        """The gradients' global norm; a sharded gradient's squares are
        summed over the model group, a replicated one's counted once."""
        sharded = [g for g in grads if isinstance(g, DTensor)
                   and any(pl.is_shard() for pl in g.placements)]
        plain = [local_shard(g) for g in grads
                 if not any(g is s for s in sharded)]
        sq = torch.stack(torch._foreach_norm(plain)).square().sum()
        if sharded:
            local = torch.stack(torch._foreach_norm(
                [local_shard(g) for g in sharded])).square().sum()
            sq = sq + global_sum(local, self.model_group)
        return torch.sqrt(sq)

    def step(self) -> bool:
        """Returns whether this call updated the parameters."""
        self.mini_step += 1
        if self.mini_step < self.accum_steps:
            return False
        grads = [p.grad for p in self.params if p.grad is not None]
        local = [local_shard(g) for g in grads]
        # GSPMD's gradient psum over the data axes
        all_reduce_(local, self.group)
        if self.accum_steps > 1:
            torch._foreach_div_(local, float(self.accum_steps))
        if self.grad_clip_norm:
            # optax.clip_by_global_norm: untouched below the limit, else
            # scaled onto it
            norm = self.grad_norm = self._global_norm(grads)
            limit = float(self.grad_clip_norm)
            scale = torch.where(norm < limit, torch.ones_like(norm),
                                limit / norm)
            torch._foreach_mul_(local, scale)
        if self.schedule is not None:
            for group in self.adam.param_groups:
                group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        self.count += 1
        self.mini_step = 0
        return True

    def state_dict(self) -> dict:
        """Between the updates of an accumulation the gradients so far are
        saved, summed over the data group (a collective: every rank calls
        this), so the file holds what one process would hold."""
        pending = None
        if self.mini_step:
            pending = [None if p.grad is None else p.grad.detach().clone()
                       for p in self.params]
            all_reduce_([g for g in pending if g is not None], self.group)
        return {"adam": self.adam.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "pending_grads": pending}

    def load_state_dict(self, state: dict) -> None:
        """Saved pending gradients (the data group's sum) go to data rank 0
        alone, so the next update's all-reduce counts them once."""
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        pending = state["pending_grads"] or [None] * len(self.params)
        if self.group is not None and dist.get_rank(self.group) != 0:
            pending = [None] * len(self.params)
        for p, g in zip(self.params, pending):
            p.grad = None if g is None else g.to(p.device, p.dtype)


def make_optimizer(params, optimizer_config: Optional[dict] = None,
                   dmodel: int = 144, use_warmup: bool = False,
                   grad_clip_norm: Optional[float] = None) -> Optimizer:
    """The optimizer over ``params`` that ``optimizer_config`` describes
    (keys lr, beta1, beta2, epsilon, warmup_steps, grad_accum_steps). A
    different ``grad_accum_steps`` changes what a checkpoint holds between
    updates, so resume with the value the run was saved with."""
    oc = optimizer_config or {}
    lr = oc.get("lr", 1e-4)
    if use_warmup:
        lr = transformer_schedule(dmodel, oc.get("warmup_steps", 10000))
    return Optimizer(params, lr, b1=oc.get("beta1", 0.9),
                     b2=oc.get("beta2", 0.98), eps=oc.get("epsilon", 1e-6),
                     grad_clip_norm=grad_clip_norm,
                     accum_steps=int(oc.get("grad_accum_steps", 1)))


@dataclasses.dataclass
class ASRTrainState:
    """Everything a training run carries from step to step. ``step`` counts
    ``train_step`` calls (micro-batches) on the host; ``generator`` lives on
    the model's device and feeds dropout and SpecAugment."""

    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        saved = state["generator"].cpu()
        # a checkpoint written on another kind of device (the card's Philox
        # state against the CPU's Mersenne Twister) cannot continue its
        # dropout stream here: the seeded generator stays
        if saved.numel() == self.generator.get_state().numel():
            self.generator.set_state(saved)
        self.step = int(state["step"])
