"""Training, evaluation and offline inference of the ChunkConformer (SMLTA2)
model on one card.

Counterpart of ``tensorflowasr_tpu/train/chunk_trainer.py``. The loss is

    loss = phone_ctc + txt_ctc + help_ctc

reduced over the batch by SUM (``loss_reduction: sum``, the default: the
reference's train step minimizes the [B] loss vector, which sums it) or by
mean. All three CTC terms floor each frame's probabilities at 1e-7 and take
the last class as blank:

- phone_ctc: the picker's phone logits over the encoder frames;
- txt_ctc: the char decoder on ``helper(feature_pick(...))``, over
  ``txt_ctc_length`` frames: "padded" (the default, the reference's) gives
  every row ``t_ref`` (or the pick buffer's full width when it is capped),
  "picked" each row's own picked count;
- help_ctc: the char decoder on ``helper.phone_call(extra_phones)``, over
  the extra phones' lengths.

``max_pick=None`` (the default) lets every encoder frame be picked and runs
the picked branch at the width ``t_ref = max(picked counts, longest phone
label)``; an int caps the pick buffer.

Batch dict (static shapes): wav [B, T], input_length [B] (encoder frames),
phones [B, L], phone_length [B], chars [B, U], char_length [B],
extra_phones [B, Le], extra_phone_length [B], extra_chars [B, Ue],
extra_char_length [B]. ``TrainerBase._prepare_batch`` also leaves the
length vectors on the host (``*_host``), which the CTC loss reads there; the
"padded" or "picked" char-CTC lengths depend on the picks, so the step
copies them to the host once (``ops/ctc.py::ctc_loss``): the one wait for
the device in a step.

The JAX package unrolls its scanned stacks for training (``scan_unroll``);
eager PyTorch runs every stack unrolled, so there is nothing to choose.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from tensorflowasr_tpu_torch.models.chunk_conformer import (
    ChunkConformer,
    ChunkConformerConfig,
    build_chunk_model,
)
from tensorflowasr_tpu_torch.models.layers import set_generator
from tensorflowasr_tpu_torch.ops.ctc import ctc_greedy_decode, ctc_loss
from tensorflowasr_tpu_torch.train.base import TrainerBase
from tensorflowasr_tpu_torch.train.state import ASRTrainState, make_optimizer
from tensorflowasr_tpu_torch.utils.config import cfg_get
from tensorflowasr_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]

TXT_DECODE_LENGTHS = ("padded", "picked")
LOSS_REDUCTIONS = ("sum", "mean")


def _check(name: str, value: str, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


def chunk_ctc_acc(labels: torch.Tensor, decoded: torch.Tensor
                  ) -> torch.Tensor:
    """Token match over the non-pad label positions of the shorter of the
    two widths, averaged per example, then over the batch."""
    t = min(labels.shape[1], decoded.shape[1])
    lab, pred = labels[:, :t], decoded[:, :t]
    mask = (lab != 0).to(torch.float32)
    match = (lab == pred).to(torch.float32)
    per_ex = torch.sum(match * mask, -1) / (torch.sum(mask, -1) + 1e-6)
    return per_ex.mean()


def _host(batch: Batch, key: str) -> torch.Tensor:
    return batch.get(key + "_host", batch[key])


def label_width(batch: Batch) -> int:
    """The batch's longest phone label (read on the host)."""
    return int(_host(batch, "phone_length").max())


def losses_from_outputs(fwd: Dict[str, Optional[torch.Tensor]],
                        batch: Batch, num_phone_classes: int,
                        num_char_classes: int,
                        txt_ctc_length: str = "padded",
                        loss_reduction: str = "sum"
                        ) -> Tuple[torch.Tensor, Metrics]:
    """``train_forward``'s outputs -> (total loss, the seven metrics)."""
    phone_blank, char_blank = num_phone_classes - 1, num_char_classes - 1
    counts, txt_logits = fwd["picked_counts"], fwd["txt_logits"]
    phone_loss = ctc_loss(fwd["phone_logits"], _host(batch, "input_length"),
                          batch["phones"], _host(batch, "phone_length"),
                          blank_id=phone_blank, prob_floor=1e-7)
    if txt_ctc_length == "padded":
        t_ref = fwd["t_ref"]
        if t_ref is None:
            txt_len = torch.full_like(counts, txt_logits.shape[1])
        else:
            txt_len = t_ref.to(counts.dtype).expand_as(counts)
    else:
        txt_len = counts
    txt_loss = ctc_loss(txt_logits, txt_len, batch["chars"],
                        _host(batch, "char_length"), blank_id=char_blank,
                        prob_floor=1e-7)
    help_loss = ctc_loss(fwd["help_logits"],
                         _host(batch, "extra_phone_length"),
                         batch["extra_chars"],
                         _host(batch, "extra_char_length"),
                         blank_id=char_blank, prob_floor=1e-7)
    per_ex = phone_loss + txt_loss + help_loss
    total = per_ex.sum() if loss_reduction == "sum" else per_ex.mean()
    with torch.no_grad():
        phone_dec, _ = ctc_greedy_decode(fwd["phone_logits"],
                                         batch["input_length"], phone_blank)
        txt_dec, _ = ctc_greedy_decode(txt_logits, txt_len, char_blank)
        help_dec, _ = ctc_greedy_decode(fwd["help_logits"],
                                        batch["extra_phone_length"],
                                        char_blank)
        metrics = {
            "phone_loss": phone_loss.mean(),
            "txt_loss": txt_loss.mean(),
            "help_loss": help_loss.mean(),
            "train_loss": per_ex.mean(),
            "phone_acc": chunk_ctc_acc(batch["phones"], phone_dec),
            "txt_acc": chunk_ctc_acc(batch["chars"], txt_dec),
            "help_acc": chunk_ctc_acc(batch["extra_chars"], help_dec),
        }
    return total, metrics


def loss_and_metrics(model: ChunkConformer, batch: Batch,
                     max_pick: Optional[int] = None,
                     txt_ctc_length: str = "padded",
                     loss_reduction: str = "sum"
                     ) -> Tuple[torch.Tensor, Metrics]:
    """Forward in the model's current mode (training: dropout, SpecAugment,
    batch statistics and their running update) and the losses."""
    fwd = model.train_forward(batch["wav"], batch["extra_phones"], max_pick,
                              label_width=label_width(batch))
    return losses_from_outputs(fwd, batch, model.num_phone_classes,
                               model.num_char_classes, txt_ctc_length,
                               loss_reduction)


def make_chunk_train_step(max_pick: Optional[int] = None,
                          txt_ctc_length: str = "padded",
                          loss_reduction: str = "sum",
                          mark: Optional[Callable[[str], None]] = None
                          ) -> Callable:
    """Returns (state, batch) -> (state, metrics): forward in training
    mode, the loss, backward and the optimizer's step (Adam, with the
    clipping and accumulation ``optimizer_config`` sets). The state is
    updated in place and handed back; the metrics are device scalars.
    ``mark``, when given, is called with "forward", "loss", "backward" and
    "optimizer" as each stage has been enqueued."""
    _check("txt_ctc_length", txt_ctc_length, TXT_DECODE_LENGTHS)
    _check("loss_reduction", loss_reduction, LOSS_REDUCTIONS)
    mark = mark or (lambda stage: None)

    def step(state: ASRTrainState, batch: Batch
             ) -> Tuple[ASRTrainState, Metrics]:
        model = state.model
        if not model.training:
            model.train()
        fwd = model.train_forward(batch["wav"], batch["extra_phones"],
                                  max_pick, label_width=label_width(batch))
        mark("forward")
        total, metrics = losses_from_outputs(
            fwd, batch, model.num_phone_classes, model.num_char_classes,
            txt_ctc_length, loss_reduction)
        del fwd
        mark("loss")
        total.backward()
        mark("backward")
        state.optimizer.step()
        mark("optimizer")
        state.step += 1
        return state, metrics

    return step


def make_chunk_eval_step(max_pick: Optional[int] = None,
                         txt_ctc_length: str = "padded") -> Callable:
    """Returns (state, batch) -> metrics, in eval mode without gradients."""
    _check("txt_ctc_length", txt_ctc_length, TXT_DECODE_LENGTHS)

    @torch.no_grad()
    def step(state: ASRTrainState, batch: Batch) -> Metrics:
        model = state.model
        if model.training:
            model.eval()
        return loss_and_metrics(model, batch, max_pick, txt_ctc_length)[1]

    return step


def make_chunk_predict_step(model: ChunkConformer,
                            max_pick: Optional[int] = None,
                            txt_decode_length: str = "padded") -> Callable:
    """(wav [B, T], input_length [B]) -> (char_ids, char_lens, phone_ids,
    phone_lens): offline chunk inference with greedy CTC decodes.

    ``max_pick=None`` lets every non-blank frame be picked.
    ``txt_decode_length`` "padded" decodes every row's char CTC over the
    batch's largest picked count (the reference tester's length, which
    training with padded char-CTC lengths needs); "picked" stops each row
    at its own count. Nothing is read back to the host."""
    _check("txt_decode_length", txt_decode_length, TXT_DECODE_LENGTHS)
    char_blank = model.num_char_classes - 1
    phone_blank = model.num_phone_classes - 1

    @torch.no_grad()
    def step(wav: torch.Tensor, input_length: torch.Tensor):
        char_logits, phone_logits, counts = model.predict(wav, max_pick)
        if txt_decode_length == "padded":
            dec_len = torch.clamp(counts.max(), 1, char_logits.shape[1])
            dec_len = dec_len.expand(counts.shape)
        else:
            dec_len = counts
        char_ids, char_lens = ctc_greedy_decode(char_logits, dec_len,
                                                blank_id=char_blank)
        phone_ids, phone_lens = ctc_greedy_decode(
            phone_logits, input_length, blank_id=phone_blank)
        return char_ids, char_lens, phone_ids, phone_lens

    return step


class ChunkTrainer(TrainerBase):
    """Config-driven ChunkConformer trainer: builds the model, the optimizer
    and the steps; the fit / eval / checkpoint loop lives in
    :class:`TrainerBase`. Reads ``running_config.txt_ctc_length`` and
    ``loss_reduction``. Runs on ``device`` ("cuda" unless asked for "cpu";
    a CUDA request without a card raises)."""

    def __init__(self, config, num_phone_classes: int,
                 num_char_classes: int, max_pick: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 compute_dtype: str = "float32"):
        self.config = config
        self.device = resolve_device(device)
        rc = config["running_config"] or {}
        self.model_cfg = ChunkConformerConfig.from_user_config(
            config, compute_dtype)
        self.num_phone_classes = num_phone_classes
        self.num_char_classes = num_char_classes
        self.max_pick = max_pick
        self.txt_ctc_length = cfg_get(rc, "txt_ctc_length", "padded")
        self.loss_reduction = cfg_get(rc, "loss_reduction", "sum")
        self.train_step = make_chunk_train_step(
            max_pick, self.txt_ctc_length, self.loss_reduction)
        self.eval_step = make_chunk_eval_step(max_pick, self.txt_ctc_length)
        self.log_interval = cfg_get(rc, "log_interval_steps", 100)
        self.save_interval = cfg_get(rc, "save_interval_steps", 500)
        self.eval_interval = cfg_get(rc, "eval_interval_steps", 500)
        self.outdir = cfg_get(rc, "outdir", "./chunk-logs")
        self.sample_rate = self.model_cfg.sample_rate
        self.state: Optional[ASRTrainState] = None

    def init_state(self, seed: int = 0) -> ASRTrainState:
        """Seeded random weights, a fresh optimizer and a generator for
        dropout and SpecAugment seeded with ``seed`` on the trainer's
        device."""
        model = build_chunk_model(self.model_cfg, self.num_phone_classes,
                                  self.num_char_classes, device=self.device,
                                  seed=seed)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        set_generator(model, generator)
        optimizer = make_optimizer(
            model.parameters(), dict(self.config["optimizer_config"] or {}),
            dmodel=self.model_cfg.dmodel)
        self.state = ASRTrainState(model, optimizer, generator)
        n = sum(p.numel() for p in model.parameters())
        logger.info("model params: %s", f"{n:,}")
        return self.state

    def predict_step(self, state: ASRTrainState, wav: torch.Tensor,
                     input_length: torch.Tensor):
        """``make_chunk_predict_step`` on the state's model in eval mode,
        decoding chars over ``txt_ctc_length``'s lengths."""
        model = state.model
        if model.training:
            model.eval()
        return make_chunk_predict_step(model, self.max_pick,
                                       self.txt_ctc_length)(wav,
                                                            input_length)

    # fit / evaluate / checkpoint machinery inherited from TrainerBase
