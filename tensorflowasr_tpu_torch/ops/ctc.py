"""CTC loss and greedy CTC decoding with static shapes.

Counterpart of ``tensorflowasr_tpu/ops/ctc.py``:

- :func:`ctc_loss` - per-example negative log likelihood with the reference's
  probability floor;
- ``compact_kept`` / ``collapse_and_remove_blank`` / ``ctc_greedy_decode`` /
  ``merge_repeated`` - argmax -> collapse repeats -> drop blanks,
  left-justified by a stable sort so the output keeps the input's [B, T]
  shape (padded with ``pad_id``). Argmax ties go to the first index, as in
  JAX.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int, zero_infinity: bool = True,
             prob_floor: float = 0.0) -> torch.Tensor:
    """Per-example negative log likelihood, shape [B].

    logits [B, T, V] are unnormalized scores; ``logit_lengths`` [B] valid
    frames; labels [B, L] padded arbitrarily past ``label_lengths`` [B].
    ``prob_floor`` floors each frame's probabilities before the log,
    ``log(softmax(x) + floor)``: the reference's Keras loss uses 1e-7, which
    caps a frame's -log p near 16.1. With ``zero_infinity`` an infeasible
    example (too few frames for its labels) gives loss 0 and gradient 0.

    The alpha/beta recursion is ``F.ctc_loss``'s. Its backward hands back
    ``exp(logp) - occupancy``, which is the loss's gradient only once it has
    also gone through the backward of the normalization in front of it; so
    ``log_softmax`` and the floor stay inside this function, and callers
    pass logits. Lengths given as CPU tensors avoid a device-to-host copy
    (``F.ctc_loss`` reads them on the host).
    """
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    if prob_floor:
        logp = torch.logaddexp(
            logp, logp.new_full((), math.log(prob_floor)))
    return F.ctc_loss(logp.transpose(0, 1), labels.long(),
                      logit_lengths.long(), label_lengths.long(),
                      blank=blank_id, reduction="none",
                      zero_infinity=zero_infinity)


def compact_kept(ids: torch.Tensor, keep: torch.Tensor, pad_id: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-justify the ``keep``-masked entries of each row (stable).
    Returns (compacted [B, T] padded with ``pad_id``, counts [B] int32)."""
    order = torch.argsort((~keep).to(torch.int32), dim=1, stable=True)
    gathered = torch.gather(ids, 1, order)
    kept_sorted = torch.gather(keep, 1, order)
    out = torch.where(kept_sorted, gathered, torch.full_like(gathered, pad_id))
    return out, keep.sum(dim=1).to(torch.int32)


def _previous(ids: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)


def _valid(ids: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    tpos = torch.arange(ids.shape[1], device=ids.device)[None, :]
    return tpos < lengths.to(ids.device)[:, None]


def collapse_and_remove_blank(ids: torch.Tensor, lengths: torch.Tensor,
                              blank_id: int, pad_id: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids [B, T] frame-wise, lengths [B] valid frames -> (decoded [B, T]
    padded with ``pad_id``, decoded lengths [B])."""
    keep = _valid(ids, lengths) & (ids != blank_id) & (ids != _previous(ids))
    return compact_kept(ids, keep, pad_id)


def ctc_greedy_decode(logits: torch.Tensor, lengths: torch.Tensor,
                      blank_id: int, pad_id: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, T, V] -> (ids [B, T] padded, lengths [B])."""
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    return collapse_and_remove_blank(ids, lengths, blank_id, pad_id)


def merge_repeated(ids: torch.Tensor, lengths: torch.Tensor,
                   pad_id: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Collapse adjacent repeats only (no blank removal)."""
    keep = _valid(ids, lengths) & (ids != _previous(ids))
    return compact_kept(ids, keep, pad_id)
