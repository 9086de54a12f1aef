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

Data parallelism, as in ``train/asr_trainer.py``: with a data group each
rank holds its rows, ``t_ref`` is the global batch's (the model
all-reduces it, so the helper, the decoder, their attention keys and
their masked BatchNorm statistics see the global width), the ``sum`` /
``mean`` reduction and the metrics are taken over the global batch, and
the optimizer sums the gradients over the group.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from tensorflowasr_tpu_torch.models.chunk_conformer import (
    ChunkConformer,
    ChunkConformerConfig,
    build_chunk_model,
    count_params,
)
from tensorflowasr_tpu_torch.ops.ctc import ctc_greedy_decode, ctc_loss
from tensorflowasr_tpu_torch.parallel import mesh as mesh_lib
from tensorflowasr_tpu_torch.parallel.mesh import global_sum
from tensorflowasr_tpu_torch.train.base import TrainerBase
from tensorflowasr_tpu_torch.train.state import ASRTrainState, make_optimizer
from tensorflowasr_tpu_torch.utils import telemetry
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


def _chunk_ctc_acc_sum(labels: torch.Tensor, decoded: torch.Tensor
                       ) -> torch.Tensor:
    """The sum over the batch of each example's token match."""
    t = min(labels.shape[1], decoded.shape[1])
    lab, pred = labels[:, :t], decoded[:, :t]
    mask = (lab != 0).to(torch.float32)
    match = (lab == pred).to(torch.float32)
    per_ex = torch.sum(match * mask, -1) / (torch.sum(mask, -1) + 1e-6)
    return per_ex.sum()


def chunk_ctc_acc(labels: torch.Tensor, decoded: torch.Tensor
                  ) -> torch.Tensor:
    """Token match over the non-pad label positions of the shorter of the
    two widths, averaged per example, then over the batch."""
    return _chunk_ctc_acc_sum(labels, decoded) / labels.shape[0]


def _host(batch: Batch, key: str) -> torch.Tensor:
    return batch.get(key + "_host", batch[key])


def label_width(batch: Batch) -> int:
    """The batch's longest phone label (read on the host)."""
    return int(_host(batch, "phone_length").max())


def losses_from_outputs(fwd: Dict[str, Optional[torch.Tensor]],
                        batch: Batch, num_phone_classes: int,
                        num_char_classes: int,
                        txt_ctc_length: str = "padded",
                        loss_reduction: str = "sum", group=None
                        ) -> Tuple[torch.Tensor, Metrics]:
    """``train_forward``'s outputs -> (total loss, the seven metrics). With
    a data ``group`` the total is this rank's share of the global sum or
    mean (the ranks' gradients add up to the global one) and the metrics
    are the global batch's."""
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
    with torch.no_grad():
        phone_dec, _ = ctc_greedy_decode(fwd["phone_logits"],
                                         batch["input_length"], phone_blank)
        txt_dec, _ = ctc_greedy_decode(txt_logits, txt_len, char_blank)
        help_dec, _ = ctc_greedy_decode(fwd["help_logits"],
                                        batch["extra_phone_length"],
                                        char_blank)
        sums = global_sum(torch.stack([
            phone_loss.sum(), txt_loss.sum(), help_loss.sum(), per_ex.sum(),
            _chunk_ctc_acc_sum(batch["phones"], phone_dec),
            _chunk_ctc_acc_sum(batch["chars"], txt_dec),
            _chunk_ctc_acc_sum(batch["extra_chars"], help_dec),
            per_ex.new_tensor(float(per_ex.shape[0]))]), group)
        b = sums[7]
        metrics = dict(zip(("phone_loss", "txt_loss", "help_loss",
                            "train_loss", "phone_acc", "txt_acc",
                            "help_acc"), sums[:7] / b))
    total = per_ex.sum() if loss_reduction == "sum" else per_ex.sum() / b
    return total, metrics


def loss_and_metrics(model: ChunkConformer, batch: Batch,
                     max_pick: Optional[int] = None,
                     txt_ctc_length: str = "padded",
                     loss_reduction: str = "sum", group=None
                     ) -> Tuple[torch.Tensor, Metrics]:
    """Forward in the model's current mode (training: dropout, SpecAugment,
    batch statistics and their running update) and the losses, over the
    data ``group``'s global batch when one is given."""
    fwd = model.train_forward(batch["wav"], batch["extra_phones"], max_pick,
                              label_width=label_width(batch))
    return losses_from_outputs(fwd, batch, model.num_phone_classes,
                               model.num_char_classes, txt_ctc_length,
                               loss_reduction, group)


def make_chunk_train_step(max_pick: Optional[int] = None,
                          txt_ctc_length: str = "padded",
                          loss_reduction: str = "sum",
                          mark: Optional[Callable[[str], None]] = None,
                          group=None) -> Callable:
    """Returns (state, batch) -> (state, metrics): forward in training
    mode, the loss, backward and the optimizer's step (Adam, with the
    clipping and accumulation ``optimizer_config`` sets). The state is
    updated in place and handed back; the metrics are device scalars.
    ``mark``, when given, is called with "forward", "loss", "backward" and
    "optimizer" as each stage has been enqueued; the recorder keeps each
    stage's host time as the spans ``step.<stage>``. ``group`` is the data
    group the losses reduce over (the model and the optimizer carry it
    too)."""
    _check("txt_ctc_length", txt_ctc_length, TXT_DECODE_LENGTHS)
    _check("loss_reduction", loss_reduction, LOSS_REDUCTIONS)
    mark = mark or (lambda stage: None)

    def step(state: ASRTrainState, batch: Batch
             ) -> Tuple[ASRTrainState, Metrics]:
        model = state.model
        if not model.training:
            model.train()
        with telemetry.span("step.forward"):
            fwd = model.train_forward(batch["wav"], batch["extra_phones"],
                                      max_pick,
                                      label_width=label_width(batch))
        mark("forward")
        with telemetry.span("step.loss"):
            total, metrics = losses_from_outputs(
                fwd, batch, model.num_phone_classes, model.num_char_classes,
                txt_ctc_length, loss_reduction, group)
            del fwd
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


def make_chunk_eval_step(max_pick: Optional[int] = None,
                         txt_ctc_length: str = "padded",
                         group=None) -> Callable:
    """Returns (state, batch) -> metrics, in eval mode without gradients
    (over the data ``group``'s global batch when one is given)."""
    _check("txt_ctc_length", txt_ctc_length, TXT_DECODE_LENGTHS)

    @torch.no_grad()
    def step(state: ASRTrainState, batch: Batch) -> Metrics:
        model = state.model
        if model.training:
            model.eval()
        return loss_and_metrics(model, batch, max_pick, txt_ctc_length,
                                group=group)[1]

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
    a CUDA request without a card raises). ``mesh`` as in ``CTCTrainer``:
    a ``data`` mesh over every rank when a process group exists."""

    def __init__(self, config, num_phone_classes: int,
                 num_char_classes: int, max_pick: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 compute_dtype: str = "float32", mesh=None):
        self.config = config
        self.device = resolve_device(device)
        rc = config["running_config"] or {}
        self.set_mesh(mesh if mesh is not None else mesh_lib.make_data_mesh(
            int(cfg_get(rc, "batch_size", 16)), self.device))
        self.model_cfg = ChunkConformerConfig.from_user_config(
            config, compute_dtype)
        self.num_phone_classes = num_phone_classes
        self.num_char_classes = num_char_classes
        self.max_pick = max_pick
        self.txt_ctc_length = cfg_get(rc, "txt_ctc_length", "padded")
        self.loss_reduction = cfg_get(rc, "loss_reduction", "sum")
        self.train_step = make_chunk_train_step(
            max_pick, self.txt_ctc_length, self.loss_reduction,
            group=self.group)
        self.eval_step = make_chunk_eval_step(max_pick, self.txt_ctc_length,
                                              self.group)
        self.log_interval = cfg_get(rc, "log_interval_steps", 100)
        self.save_interval = cfg_get(rc, "save_interval_steps", 500)
        self.eval_interval = cfg_get(rc, "eval_interval_steps", 500)
        self.outdir = cfg_get(rc, "outdir", "./chunk-logs")
        self.sample_rate = self.model_cfg.sample_rate
        self.frame_samples = (self.model_cfg.chunk_samples
                              // self.model_cfg.sub_length)
        self.state: Optional[ASRTrainState] = None

    def init_state(self, seed: int = 0) -> ASRTrainState:
        """Seeded random weights (broadcast from data rank 0), a fresh
        optimizer and a generator for dropout and SpecAugment on the
        trainer's device, seeded with ``seed`` (and this rank's data rank,
        ``rank_seed``)."""
        model = build_chunk_model(self.model_cfg, self.num_phone_classes,
                                  self.num_char_classes, device=self.device,
                                  seed=seed)
        optimizer = make_optimizer(
            model.parameters(), dict(self.config["optimizer_config"] or {}),
            dmodel=self.model_cfg.dmodel)
        self.state = self.new_state(model, optimizer, seed)
        logger.info("model params: %s", f"{count_params(model):,}")
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
