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

Data parallelism: with a data group (``parallel/mesh.py``; the trainer
makes a ``data`` mesh over every rank when a process group exists) each
rank holds its rows of the global batch, and every batch reduction is
global: the BatchNorm moments, the balance terms of ``mask_loss`` (their
sums all-reduced before dividing), the batch mean (each rank's sum over the
global batch size) and the logged metrics. The gradients are summed over
the group by the optimizer (``train/state.py``), so an N-rank step equals
the one-process step on the global batch.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.models.conformer import (
    ConformerCTC,
    build_model,
    count_params,
)
from tensorflowasr_tpu_torch.models.ebranchformer import offline_config
from tensorflowasr_tpu_torch.ops.ctc import ctc_loss
from tensorflowasr_tpu_torch.parallel import mesh as mesh_lib
from tensorflowasr_tpu_torch.parallel.mesh import global_sum
from tensorflowasr_tpu_torch.serve import engines
from tensorflowasr_tpu_torch.train.base import TrainerBase
from tensorflowasr_tpu_torch.train.state import ASRTrainState, make_optimizer
from tensorflowasr_tpu_torch.utils import telemetry
from tensorflowasr_tpu_torch.utils.config import cfg_get
from tensorflowasr_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


def mask_loss(labels: torch.Tensor, logits: torch.Tensor,
              group=None) -> torch.Tensor:
    """Per-example mean cross entropy plus two batch-global balance terms
    (the mean over non-pad positions and the mean over pad positions),
    broadcast back onto the batch. labels [B, U], logits [B, U, V] -> [B].
    With a data ``group`` the balance terms are those of the global batch:
    their sums and counts are all-reduced (one collective, the gradient
    flowing back through it) before dividing."""
    ce = F.cross_entropy(logits.to(torch.float32).transpose(1, 2),
                         labels.long(), reduction="none")
    need = (labels != 0).to(torch.float32)
    zero = (labels == 0).to(torch.float32)
    sums = global_sum(torch.stack([torch.sum(ce * need), torch.sum(ce * zero),
                                   torch.sum(need), torch.sum(zero)]),
                      group, differentiable=True)
    need_loss = sums[0] / (sums[2] + 1e-6)
    zero_loss = sums[1] / (sums[3] + 1e-6)
    return ce.mean(dim=-1) + need_loss + zero_loss


def _ctc_acc_sum(labels: torch.Tensor, decoded: torch.Tensor
                 ) -> torch.Tensor:
    """The sum over the batch of each example's token accuracy."""
    u, t = labels.shape[1], decoded.shape[1]
    if t < u:
        decoded = F.pad(decoded, (0, u - t))
    pred = decoded[:, :u]
    maskv = (labels != 0).to(torch.float32)
    match = (labels == pred).to(torch.float32)
    per_ex = torch.sum(match * maskv, -1) / (torch.sum(maskv, -1) + 1e-6)
    return per_ex.sum()


def ctc_acc(labels: torch.Tensor, decoded: torch.Tensor) -> torch.Tensor:
    """Token accuracy over non-pad label positions, averaged per example;
    the decoded ids are padded or cut to the labels' width."""
    return _ctc_acc_sum(labels, decoded) / labels.shape[0]


def _translate_match(labels: torch.Tensor, logits: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(matches, positions) over the non-pad label positions."""
    pred = torch.argmax(logits, -1)[:, :labels.shape[1]]
    need = (labels != 0).to(torch.float32)
    match = (labels == pred).to(torch.float32)
    return torch.sum(match * need), torch.sum(need)


def translate_acc(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    match, need = _translate_match(labels, logits)
    return match / (need + 1e-6)


def losses_from_outputs(outputs, batch: Batch, blank_id: int,
                        group=None) -> Tuple[torch.Tensor, Metrics]:
    """``train_forward``'s outputs -> (total loss, the five metrics). With a
    data ``group`` the total is this rank's share of the global mean (its
    rows' sum over the global batch size), so the ranks' gradients add up
    to the global one, and the metrics are those of the global batch."""
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
    tl_label = mask_loss(chars, label_out[:, :u], group)
    tl_ctc = mask_loss(chars, ctc_out[:, :u], group)
    translate_loss = tl_label * 2.0 + tl_ctc
    per_ex = per_ex_ctc + translate_loss * 2.0
    with torch.no_grad():
        match, need = _translate_match(chars, ctc_out)
        sums = global_sum(torch.stack([
            per_ex_ctc.sum(), translate_loss.sum(), per_ex.sum(),
            _ctc_acc_sum(phones, decoded), match, need,
            per_ex.new_tensor(float(per_ex.shape[0]))]), group)
    b = sums[6]
    total = torch.sum(per_ex) / b
    metrics = {"ctc_loss": sums[0] / b, "translate_loss": sums[1] / b,
               "train_loss": sums[2] / b, "ctc_acc": sums[3] / b,
               "translate_acc": sums[4] / (sums[5] + 1e-6)}
    return total, metrics


def loss_and_metrics(model: ConformerCTC, batch: Batch, blank_id: int,
                     group=None) -> Tuple[torch.Tensor, Metrics]:
    """Forward in the model's current mode (training: dropout, batch
    statistics, running-statistics update) and the losses, over the data
    ``group``'s global batch when one is given."""
    outputs = model.train_forward(batch["wav"], batch["phones"],
                                  batch["input_length"])
    return losses_from_outputs(outputs, batch, blank_id, group)


def make_train_step(blank_id: int,
                    mark: Optional[Callable[[str], None]] = None,
                    group=None) -> Callable:
    """Returns (state, batch) -> (state, metrics). The state is updated in
    place and handed back; the metrics are device scalars. ``mark``, when
    given, is called with "forward", "loss", "backward" and "optimizer" as
    each stage has been enqueued (for timing a step's stages); the
    recorder keeps each stage's host time as the spans ``step.forward``,
    ``step.loss``, ``step.backward`` and ``step.optimizer``. ``group``
    is the data group the losses reduce over (the model's BatchNorms and
    the optimizer carry it too)."""
    mark = mark or (lambda stage: None)

    def step(state: ASRTrainState, batch: Batch
             ) -> Tuple[ASRTrainState, Metrics]:
        model = state.model
        if not model.training:
            model.train()
        with telemetry.span("step.forward"):
            outputs = model.train_forward(batch["wav"], batch["phones"],
                                          batch["input_length"])
        mark("forward")
        with telemetry.span("step.loss"):
            total, metrics = losses_from_outputs(outputs, batch, blank_id,
                                                 group)
            # the char logits at the encoder's width are the step's
            # largest tensor and nothing in the backward needs them whole
            del outputs
        mark("loss")
        with telemetry.span("step.backward"):
            total.backward()
        mark("backward")
        with telemetry.span("step.optimizer"):
            state.optimizer.step()
        mark("optimizer")
        state.step += 1
        return state, metrics

    return step


def make_eval_step(blank_id: int, group=None) -> Callable:
    """Returns (state, batch) -> metrics, in eval mode without gradients
    (over the data ``group``'s global batch when one is given)."""

    @torch.no_grad()
    def step(state: ASRTrainState, batch: Batch) -> Metrics:
        model = state.model
        if model.training:
            model.eval()
        return loss_and_metrics(model, batch, blank_id, group)[1]

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
    """Config-driven trainer of the offline family (a ConformerCTC, or an
    EBranchformerCTC for ``model_config.name: EBranchformerCTC``): builds
    the model, the optimizer and the steps;
    the fit / eval / checkpoint loop lives in :class:`TrainerBase`. Runs on
    ``device`` ("cuda" unless asked for "cpu"; a CUDA request without a card
    raises).

    ``mesh`` defaults to ``parallel.mesh.make_data_mesh(batch_size)``: a
    ``data`` mesh over every rank when a process group exists (each rank
    then trains on its rows of every batch, and the step equals the
    one-process step on the whole batch), None in one process."""

    def __init__(self, config, num_phone_classes: int,
                 num_char_classes: int, blank_id: int,
                 device: Union[str, torch.device] = "cuda",
                 use_warmup: bool = False,
                 compute_dtype: str = "float32", mesh=None):
        self.config = config
        self.device = resolve_device(device)
        rc = config["running_config"] or {}
        self.set_mesh(mesh if mesh is not None else mesh_lib.make_data_mesh(
            int(cfg_get(rc, "batch_size", 16)), self.device))
        self.model_cfg = offline_config(config, compute_dtype)
        if blank_id != num_phone_classes - 1:
            raise ValueError(
                "CTCTrainer requires blank as the last class "
                "(blank_at_zero: False, as in the shipped configs)")
        self.blank_id = blank_id
        self.num_phone_classes = num_phone_classes
        self.num_char_classes = num_char_classes
        self.use_warmup = use_warmup
        self.train_step = make_train_step(blank_id, group=self.group)
        self.eval_step = make_eval_step(blank_id, self.group)
        self.predict_step = make_predict_step(blank_id)
        self.log_interval = cfg_get(rc, "log_interval_steps", 100)
        self.save_interval = cfg_get(rc, "save_interval_steps", 500)
        self.eval_interval = cfg_get(rc, "eval_interval_steps", 500)
        self.outdir = cfg_get(rc, "outdir", "./asr-logs")
        self.sample_rate = self.model_cfg.sample_rate
        self.frame_samples = (self.model_cfg.hop_size
                              * self.model_cfg.reduction_factor)
        self.state: Optional[ASRTrainState] = None

    def init_state(self, seed: int = 0) -> ASRTrainState:
        """Seeded random weights (broadcast from data rank 0), a fresh
        optimizer and a dropout generator on the trainer's device, seeded
        with ``seed`` (and this rank's data rank, ``rank_seed``)."""
        model = build_model(self.model_cfg, self.num_phone_classes,
                            self.num_char_classes, device=self.device,
                            seed=seed)
        optimizer = make_optimizer(
            model.parameters(), dict(self.config["optimizer_config"] or {}),
            dmodel=self.model_cfg.dmodel, use_warmup=self.use_warmup)
        self.state = self.new_state(model, optimizer, seed)
        logger.info("model params: %s", f"{count_params(model):,}")
        return self.state

    # fit / evaluate / checkpoint machinery inherited from TrainerBase
