"""CTC training for the offline Conformer family on one card.

Counterpart of ``tensorflowasr_tpu/train/asr_trainer.py``. One train step is
encoder forward, CTC loss, greedy decode, translator on both the ground-truth
and the decoded phones, backward and the Adam update, all enqueued without
waiting for the device. Loss composition:

    mask_loss(l, p) = mean_t(CE) + sum(CE*need)/sum(need) + sum(CE*pad)/sum(pad)
    translate_loss  = 2 * mask_loss(chars, translator(GT phones + 5 pad))
                        + mask_loss(chars, translator(greedy CTC ids))
    train_loss      = mean(ctc + 2 * translate_loss)

Batch dict (all static shapes, the loader's buckets pad them):
  wav [B, T] f32 or i16, input_length [B] i32 (encoder frames),
  phones [B, L] i32, phone_length [B] i32, chars [B, U] i32.

Data parallelism over several cards comes with the parallelism slice.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.models.conformer import (
    ConformerConfig,
    ConformerCTC,
    build_model,
)
from tensorflowasr_tpu_torch.models.layers import set_generator
from tensorflowasr_tpu_torch.ops.ctc import ctc_loss
from tensorflowasr_tpu_torch.serve import engines
from tensorflowasr_tpu_torch.train.base import TrainerBase
from tensorflowasr_tpu_torch.train.state import ASRTrainState, make_optimizer
from tensorflowasr_tpu_torch.utils.config import cfg_get
from tensorflowasr_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def mask_loss(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Per-example mean cross entropy plus two batch-global balance terms
    (the mean over non-pad positions and the mean over pad positions),
    broadcast back onto the batch. labels [B, U], logits [B, U, V] -> [B]."""
    ce = F.cross_entropy(logits.to(torch.float32).transpose(1, 2),
                         labels.long(), reduction="none")
    need = (labels != 0).to(torch.float32)
    zero = (labels == 0).to(torch.float32)
    need_loss = torch.sum(ce * need) / (torch.sum(need) + 1e-6)
    zero_loss = torch.sum(ce * zero) / (torch.sum(zero) + 1e-6)
    return ce.mean(dim=-1) + need_loss + zero_loss


def ctc_acc(labels: torch.Tensor, decoded: torch.Tensor) -> torch.Tensor:
    """Token accuracy over non-pad label positions; the decoded ids are
    padded or cut to the labels' width."""
    u, t = labels.shape[1], decoded.shape[1]
    if t < u:
        decoded = F.pad(decoded, (0, u - t))
    pred = decoded[:, :u]
    maskv = (labels != 0).to(torch.float32)
    match = (labels == pred).to(torch.float32)
    per_ex = torch.sum(match * maskv, -1) / (torch.sum(maskv, -1) + 1e-6)
    return per_ex.mean()


def translate_acc(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(logits, -1)[:, :labels.shape[1]]
    need = (labels != 0).to(torch.float32)
    match = (labels == pred).to(torch.float32)
    return torch.sum(match * need) / (torch.sum(need) + 1e-6)


def losses_from_outputs(outputs, batch: Batch, blank_id: int
                        ) -> Tuple[torch.Tensor, Metrics]:
    """``train_forward``'s outputs -> (total loss, the five metrics)."""
    _, ctc_logits, decoded, label_out, ctc_out = outputs
    phones, chars = batch["phones"], batch["chars"]
    u = chars.shape[1]
    # prob_floor 1e-7: the reference's Keras loss computes log(p + epsilon)
    per_ex_ctc = ctc_loss(
        ctc_logits,
        batch.get("input_length_host", batch["input_length"]),
        phones,
        batch.get("phone_length_host", batch["phone_length"]),
        blank_id=blank_id, prob_floor=1e-7)
    # the decoded ids keep the encoder's width T'; only the first U
    # positions of that pass are scored
    tl_label = mask_loss(chars, label_out[:, :u])
    tl_ctc = mask_loss(chars, ctc_out[:, :u])
    translate_loss = tl_label * 2.0 + tl_ctc
    total = torch.mean(per_ex_ctc + translate_loss * 2.0)
    with torch.no_grad():
        metrics = {
            "ctc_loss": per_ex_ctc.mean(),
            "translate_loss": translate_loss.mean(),
            "train_loss": total.detach(),
            "ctc_acc": ctc_acc(phones, decoded),
            "translate_acc": translate_acc(chars, ctc_out),
        }
    return total, metrics


def loss_and_metrics(model: ConformerCTC, batch: Batch, blank_id: int
                     ) -> Tuple[torch.Tensor, Metrics]:
    """Forward in the model's current mode (training: dropout, batch
    statistics, running-statistics update) and the losses."""
    outputs = model.train_forward(batch["wav"], batch["phones"],
                                  batch["input_length"])
    return losses_from_outputs(outputs, batch, blank_id)


def make_train_step(blank_id: int,
                    mark: Optional[Callable[[str], None]] = None
                    ) -> Callable:
    """Returns (state, batch) -> (state, metrics). The state is updated in
    place and handed back; the metrics are device scalars. ``mark``, when
    given, is called with "forward", "loss", "backward" and "optimizer" as
    each stage has been enqueued (for timing a step's stages)."""
    mark = mark or (lambda stage: None)

    def step(state: ASRTrainState, batch: Batch
             ) -> Tuple[ASRTrainState, Metrics]:
        model = state.model
        if not model.training:
            model.train()
        outputs = model.train_forward(batch["wav"], batch["phones"],
                                      batch["input_length"])
        mark("forward")
        total, metrics = losses_from_outputs(outputs, batch, blank_id)
        # the char logits at the encoder's width are the step's largest
        # tensor and nothing in the backward needs them whole
        del outputs
        mark("loss")
        total.backward()
        mark("backward")
        state.optimizer.step()
        mark("optimizer")
        state.step += 1
        return state, metrics

    return step


def make_eval_step(blank_id: int) -> Callable:
    """Returns (state, batch) -> metrics, in eval mode without gradients."""

    @torch.no_grad()
    def step(state: ASRTrainState, batch: Batch) -> Metrics:
        model = state.model
        if model.training:
            model.eval()
        return loss_and_metrics(model, batch, blank_id)[1]

    return step


def make_predict_step(blank_id: int) -> Callable:
    """Returns (state, wav, input_length) -> (phone ids, phone lengths,
    char ids): the serving path's greedy ``predict_step`` in eval mode."""

    def step(state: ASRTrainState, wav, input_length):
        model = state.model
        if model.training:
            model.eval()
        return engines.predict_step(model, wav, input_length, blank_id)

    return step


def make_beam_predict_step(model: ConformerCTC, blank_id: int,
                           beam_width: int = 8, ngram_lm=None,
                           lm_weight: float = 0.3) -> Callable:
    """:func:`make_predict_step` with the CTC prefix beam search in place of
    the greedy decode (``ops/beam.py``; the best beam, over the top
    ``min(16, V)`` phones a frame, f32 log-softmax) and, with ``ngram_lm``
    (a ``utils/ngram_lm.py::DeviceNGramLM`` on the model's device), n-gram
    shallow fusion at ``lm_weight``. ``model`` gives the phone classes; the
    step runs ``state.model``."""
    decode = engines.phone_decoder(blank_id, model.num_phone_classes,
                                   beam_width, ngram_lm, lm_weight)

    def step(state: ASRTrainState, wav, input_length):
        model = state.model
        if model.training:
            model.eval()
        return engines.predict_step(model, wav, input_length, blank_id,
                                    decode)

    return step


class CTCTrainer(TrainerBase):
    """Config-driven trainer: builds the model, the optimizer and the steps;
    the fit / eval / checkpoint loop lives in :class:`TrainerBase`. Runs on
    ``device`` ("cuda" unless asked for "cpu"; a CUDA request without a card
    raises)."""

    def __init__(self, config, num_phone_classes: int,
                 num_char_classes: int, blank_id: int,
                 device: Union[str, torch.device] = "cuda",
                 use_warmup: bool = False,
                 compute_dtype: str = "float32"):
        self.config = config
        self.device = resolve_device(device)
        rc = config["running_config"] or {}
        self.model_cfg = ConformerConfig.from_user_config(config,
                                                          compute_dtype)
        if blank_id != num_phone_classes - 1:
            raise ValueError(
                "CTCTrainer requires blank as the last class "
                "(blank_at_zero: False, as in the shipped configs)")
        self.blank_id = blank_id
        self.num_phone_classes = num_phone_classes
        self.num_char_classes = num_char_classes
        self.use_warmup = use_warmup
        self.train_step = make_train_step(blank_id)
        self.eval_step = make_eval_step(blank_id)
        self.predict_step = make_predict_step(blank_id)
        self.log_interval = cfg_get(rc, "log_interval_steps", 100)
        self.save_interval = cfg_get(rc, "save_interval_steps", 500)
        self.eval_interval = cfg_get(rc, "eval_interval_steps", 500)
        self.outdir = cfg_get(rc, "outdir", "./asr-logs")
        self.sample_rate = self.model_cfg.sample_rate
        self.state: Optional[ASRTrainState] = None

    def init_state(self, seed: int = 0) -> ASRTrainState:
        """Seeded random weights, a fresh optimizer and a dropout generator
        seeded with ``seed`` on the trainer's device."""
        model = build_model(self.model_cfg, self.num_phone_classes,
                            self.num_char_classes, device=self.device,
                            seed=seed)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        set_generator(model, generator)
        optimizer = make_optimizer(
            model.parameters(), dict(self.config["optimizer_config"] or {}),
            dmodel=self.model_cfg.dmodel, use_warmup=self.use_warmup)
        self.state = ASRTrainState(model, optimizer, generator)
        n = sum(p.numel() for p in model.parameters())
        logger.info("model params: %s", f"{n:,}")
        return self.state

    # fit / evaluate / checkpoint machinery inherited from TrainerBase
