"""VAD training step on one card.

Counterpart of ``tensorflowasr_tpu/train/vad_trainer.py``:

  loss = ((one_loss + zero_loss) * 10 + multi_res_stft(wav_target, masked))
         / batch_size

where one / zero are the class-balanced sigmoid cross-entropy means over
the voiced and the silent frames, and the STFT term trains the
masked-waveform denoising head. ``batch_size`` is the configured one, not
the step's array shape: the streaming variant folds the time axis into the
batch axis at random (:func:`streaming_reshape`, on the host), and a divisor
that followed the fold would make the effective learning rate jitter.

Batch: x [B, N, F] framed wav, labels [B, N, 1] in {0, 1}, wav_target
[B, N, F]. The VAD models have no dropout.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.ops.stft_loss import multi_resolution_stft_loss
from tensorflowasr_tpu_torch.train.state import ASRTrainState

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def vad_mask_loss(labels: torch.Tensor, logits: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-balanced sigmoid cross entropy: (mean over voiced frames, mean
    over silent frames)."""
    one = labels.squeeze(-1)
    ce = F.binary_cross_entropy_with_logits(
        logits.squeeze(-1).to(torch.float32), one, reduction="none")
    zero = 1.0 - one
    one_loss = torch.sum(ce * one) / (torch.sum(one) + 1e-6)
    zero_loss = torch.sum(ce * zero) / (torch.sum(zero) + 1e-6)
    return one_loss, zero_loss


def vad_accuracy(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    pred = (logits.squeeze(-1) >= 0.0).to(torch.float32)
    return torch.mean((pred == labels.squeeze(-1)).to(torch.float32))


def streaming_reshape(batch: dict, min_frames: int,
                      rng: np.random.Generator) -> dict:
    """Host-side streaming augmentation: fold the time axis into the batch
    axis in windows of k frames, k drawn from the divisors of N that are at
    least ``min_frames``."""
    n = batch["x"].shape[1]
    choices = [k for k in range(min_frames, n + 1) if n % k == 0]
    k = int(rng.choice(choices)) if choices else n

    def fold(a):
        b = a.shape[0]
        return a.reshape(b * (n // k), k, *a.shape[2:])
    return {name: fold(a) for name, a in batch.items()}


def _losses(model: torch.nn.Module, batch: Batch):
    logits, masked = model(batch["x"])
    one, zero = vad_mask_loss(batch["labels"], logits)
    stft = multi_resolution_stft_loss(batch["wav_target"], masked)
    return logits, one + zero, stft


def loss_and_metrics(model: torch.nn.Module, batch: Batch,
                     global_batch: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Metrics]:
    """Forward in the model's current mode and the train loss over
    ``global_batch`` (the array's first axis when None), with its
    metrics."""
    logits, vad_loss, stft = _losses(model, batch)
    total = (vad_loss * 10.0 + stft) / (global_batch or batch["x"].shape[0])
    with torch.no_grad():
        metrics = {"vad_loss": vad_loss.detach(), "wav_loss": stft.detach(),
                   "train_loss": total.detach(),
                   "vad_acc": vad_accuracy(batch["labels"], logits)}
    return total, metrics


def make_vad_train_step(model: torch.nn.Module,
                        global_batch: Optional[int] = None) -> Callable:
    """Returns (state, batch) -> (state, metrics), updating ``model`` (the
    state's) in place; the metrics are device scalars."""
    if global_batch is None:
        warnings.warn(
            "make_vad_train_step: global_batch not given; falling back to "
            "the step's array shape, which jitters the effective lr under "
            "streaming_reshape's random fold. Pass the configured "
            "running_config batch_size.", stacklevel=2)

    def step(state: ASRTrainState, batch: Batch
             ) -> Tuple[ASRTrainState, Metrics]:
        if not model.training:
            model.train()
        total, metrics = loss_and_metrics(model, batch, global_batch)
        total.backward()
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def make_vad_eval_step(model: torch.nn.Module) -> Callable:
    """Returns (state, batch) -> metrics (losses, frame accuracy and the F1
    of the voiced class), in eval mode without gradients."""

    @torch.no_grad()
    def step(state: ASRTrainState, batch: Batch) -> Metrics:
        if model.training:
            model.eval()
        logits, vad_loss, stft = _losses(model, batch)
        pred = (logits.squeeze(-1) >= 0.0).to(torch.float32)
        lab = batch["labels"].squeeze(-1)
        tp = torch.sum(pred * lab)
        f1 = 2 * tp / (torch.sum(pred) + torch.sum(lab) + 1e-6)
        return {"vad_loss": vad_loss, "wav_loss": stft,
                "vad_acc": vad_accuracy(batch["labels"], logits), "f1": f1}

    return step
