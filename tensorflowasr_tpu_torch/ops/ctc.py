"""Greedy CTC decoding with static shapes.

Counterpart of ``compact_kept`` / ``collapse_and_remove_blank`` /
``ctc_greedy_decode`` / ``merge_repeated`` in ``tensorflowasr_tpu/ops/ctc.py``:
argmax -> collapse repeats -> drop blanks, left-justified by a stable sort
so the output keeps the input's [B, T] shape (padded with ``pad_id``).
Argmax ties go to the first index, as in JAX. ``ctc_loss`` comes with the
training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
