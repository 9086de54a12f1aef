"""Offline inference step of the ChunkConformer (SMLTA2) model.

Counterpart of ``make_chunk_predict_step`` in
``tensorflowasr_tpu/train/chunk_trainer.py``. ``ChunkTrainer`` and the
chunk training and eval steps are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from tensorflowasr_tpu_torch.models.chunk_conformer import ChunkConformer
from tensorflowasr_tpu_torch.ops.ctc import ctc_greedy_decode

TXT_DECODE_LENGTHS = ("padded", "picked")


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
    if txt_decode_length not in TXT_DECODE_LENGTHS:
        raise ValueError(f"txt_decode_length must be one of "
                         f"{TXT_DECODE_LENGTHS}, got {txt_decode_length!r}")
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
