"""Punctuation-recovery training: class-balanced cross entropy plus BERT
feature distillation.

Counterpart of ``tensorflowasr_tpu/train/punc_trainer.py``:

  loss = mean(classes_loss(labels, logits)
              + distill_weight * bert_feature_loss(features, bert_out))

- ``classes_loss``: per example, the cross entropy averaged over the
  non-pad positions plus the same averaged over the positions that carry a
  punctuation class (label not 0 and not 1), which re-weights the rare
  punctuation labels;
- ``bert_feature_loss``: per position, the squared error against the
  precomputed teacher features, masked where the teacher holds its -10.0
  pad, over the shorter of the two lengths.

Dropout masks come from the state's generator (``layers.set_generator``),
so they cannot match the JAX package's ``fold_in(rng, step)`` masks: parity
holds at dropout 0.

Batch: ids [B, T] i32, punc_labels [B, T] i32 (0 pad, 1 no punctuation,
>= 2 a punctuation class), optional bert_features [B, T, 768] f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.train.state import ASRTrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def classes_loss(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """labels [B, T], logits [B, T, C] -> [B]."""
    ce = F.cross_entropy(logits.to(torch.float32).transpose(1, 2),
                         labels.long(), reduction="none")
    mask = (labels != 0).to(torch.float32)
    mask_one = mask * (labels != 1).to(torch.float32)
    per_ex = torch.sum(ce * mask, -1) / (torch.sum(mask, -1) + 1e-6)
    per_ex_punc = torch.sum(ce * mask_one, -1) / (
        torch.sum(mask_one, -1) + 1e-6)
    return per_ex + per_ex_punc


def bert_feature_loss(teacher: torch.Tensor, pred: torch.Tensor
                      ) -> torch.Tensor:
    """teacher [B, T1, D], pred [B, T2, D] -> [B]."""
    t = min(teacher.shape[1], pred.shape[1])
    teacher, pred = teacher[:, :t], pred[:, :t]
    mask = (teacher != -10.0).to(torch.float32)
    sq = torch.square(teacher - pred) * mask
    per_pos = torch.sum(sq, -1) / (torch.sum(mask, -1) + 1e-6)
    return torch.mean(per_pos, -1)


def classes_acc(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(logits, -1).to(labels.dtype)
    mask = (labels != 0).to(torch.float32)
    return torch.sum((pred == labels) * mask) / (torch.sum(mask) + 1e-6)


def loss_and_metrics(model: torch.nn.Module, batch: Batch,
                     distill_weight: float = 10.0
                     ) -> Tuple[torch.Tensor, Metrics]:
    """Forward in the model's current mode (dropout in training mode), the
    train loss and its metrics."""
    logits, bert_out = model(batch["ids"])
    bd = classes_loss(batch["punc_labels"], logits)
    fm = bert_feature_loss(batch["bert_features"], bert_out) \
        if "bert_features" in batch else torch.zeros_like(bd)
    total = torch.mean(bd + distill_weight * fm)
    with torch.no_grad():
        metrics = {"bd_loss": bd.mean(), "feature_map_loss": fm.mean(),
                   "train_loss": total.detach(),
                   "bd_acc": classes_acc(batch["punc_labels"], logits)}
    return total, metrics


def make_punc_train_step(model: torch.nn.Module,
                         distill_weight: float = 10.0) -> Callable:
    """Returns (state, batch) -> (state, metrics), updating ``model`` (the
    state's) in place, dropout on; the metrics are device scalars."""

    def step(state: ASRTrainState, batch: Batch
             ) -> Tuple[ASRTrainState, Metrics]:
        if not model.training:
            model.train()
        total, metrics = loss_and_metrics(model, batch, distill_weight)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def make_punc_eval_step(model: torch.nn.Module) -> Callable:
    """Returns (state, batch) -> metrics in eval mode without gradients:
    bd_loss, bd_acc and, with teacher features, feature_map_loss."""

    @torch.no_grad()
    def step(state: ASRTrainState, batch: Batch) -> Metrics:
        if model.training:
            model.eval()
        logits, bert_out = model(batch["ids"])
        out = {"bd_loss": classes_loss(batch["punc_labels"], logits).mean(),
               "bd_acc": classes_acc(batch["punc_labels"], logits)}
        if "bert_features" in batch:
            out["feature_map_loss"] = bert_feature_loss(
                batch["bert_features"], bert_out).mean()
        return out

    return step


def punc_recover_ids(logits: torch.Tensor, threshold: float = 0.65
                     ) -> torch.Tensor:
    """Per-position punctuation decision: the argmax class where it is >= 2
    and its softmax probability >= ``threshold``, else 0 (no insertion)."""
    probs = torch.softmax(logits.to(torch.float32), -1)
    best = torch.argmax(probs, -1)
    p = torch.amax(probs, -1)
    return torch.where((best >= 2) & (p >= threshold), best,
                       torch.zeros_like(best)).to(torch.int32)
