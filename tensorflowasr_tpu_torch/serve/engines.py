"""Inference engines for serving (greedy decode).

Counterpart of ``tensorflowasr_tpu/serve/engines.py::ASREngine`` and of the
predict step in ``tensorflowasr_tpu/train/asr_trainer.py``. Chunk and
utterance lengths are padded to the same small set of shapes as in the JAX
package, so both produce the same ids from the same weights. The beam and
n-gram LM decoders are not ported yet and raise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflowasr_tpu_torch.models.conformer import ConformerCTC
from tensorflowasr_tpu_torch.ops.ctc import ctc_greedy_decode

TRANSLATOR_PAD = 10     # zero phones appended before the translator


@torch.no_grad()
def predict_step(model: ConformerCTC, wav: torch.Tensor,
                 input_length: torch.Tensor,
                 blank_id: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(wav [B, T], input_length [B]) -> (phone ids [B, T'], phone lengths
    [B], char ids [B, T' + 10]): encode, CTC logits, greedy decode, pad the
    decoded phones with 10 zeros, translate, argmax."""
    if blank_id is None:
        blank_id = model.num_phone_classes - 1
    enc = model.encode(wav)
    logits = model.ctc_logits(enc)
    phone_ids, phone_lens = ctc_greedy_decode(logits, input_length,
                                              blank_id=blank_id)
    padded = torch.nn.functional.pad(phone_ids, (0, TRANSLATOR_PAD))
    char_logits = model.translate(padded, enc)
    char_ids = torch.argmax(char_logits, dim=-1).to(torch.int32)
    return phone_ids, phone_lens, char_ids


class ASREngine:
    """Block-streaming ASR over a model whose weights are loaded.

    ``extract_feature`` pads a wav chunk to ``chunk_samples`` (one shape);
    ``decode`` pads the concatenated encoder outputs to the next multiple
    of ``pad_chunks`` chunks, then runs CTC greedy + the translator.
    """

    def __init__(self, model: ConformerCTC, chunk_seconds: float = 0.5,
                 sample_rate: int = 16000, text_featurizer=None,
                 phone_featurizer=None, pad_chunks: int = 4,
                 beam_width: int = 0, ngram_lm=None):
        if beam_width or ngram_lm is not None:
            raise NotImplementedError(
                "beam search and the n-gram LM are not ported yet")
        self.model = model
        self.device = next(model.parameters()).device
        self.sample_rate = sample_rate
        cfg = model.cfg
        quantum = cfg.hop_size * cfg.reduction_factor
        raw = int(chunk_seconds * sample_rate)
        self.chunk_samples = max(quantum, (raw // quantum) * quantum)
        self.chunk_frames = self.chunk_samples // quantum
        self.blank = model.num_phone_classes - 1
        self.text_featurizer = text_featurizer
        self.phone_featurizer = phone_featurizer
        self.pad_chunks = pad_chunks

    @torch.no_grad()
    def extract_feature(self, audio: np.ndarray) -> np.ndarray:
        """wav chunk [n] -> encoder output [valid_frames, dmodel]; inputs
        longer than ``chunk_samples`` run piece by piece and concatenate."""
        n = len(audio)
        if n > self.chunk_samples:
            parts = [self.extract_feature(audio[i:i + self.chunk_samples])
                     for i in range(0, n, self.chunk_samples)]
            return np.concatenate(parts, axis=0)
        n_valid = max(1, int(np.ceil(n / (self.chunk_samples
                                          / self.chunk_frames))))
        buf = np.zeros((1, self.chunk_samples), np.float32)
        buf[0, :n] = audio
        enc = self.model.encode(torch.from_numpy(buf).to(self.device))
        enc = enc[0].cpu().numpy()
        return enc[:min(n_valid, enc.shape[0])]

    def _decode(self, enc_outputs: Sequence[np.ndarray], pad_chunks: int):
        enc = np.concatenate([np.asarray(e) for e in enc_outputs], axis=0)
        t = enc.shape[0]
        cap_chunks = -(-t // self.chunk_frames)
        cap_chunks = -(-cap_chunks // pad_chunks) * pad_chunks
        buf = np.zeros((1, cap_chunks * self.chunk_frames, enc.shape[1]),
                       np.float32)
        buf[0, :t] = enc
        with torch.no_grad():
            enc_t = torch.from_numpy(buf).to(self.device)
            length = torch.tensor([t], dtype=torch.int32, device=self.device)
            logits = self.model.ctc_logits(enc_t)
            ids, lens = ctc_greedy_decode(logits, length, blank_id=self.blank)
            padded = torch.nn.functional.pad(ids, (0, TRANSLATOR_PAD))
            char_ids = torch.argmax(self.model.translate(padded, enc_t), -1)
        return ids.cpu().numpy(), lens.cpu().numpy(), char_ids.cpu().numpy()

    def decode(self, enc_outputs: Sequence[np.ndarray]) -> List[str]:
        """Concatenated encoder outputs -> decoded char tokens (stops at 0
        or ``</S>``)."""
        if not enc_outputs:
            return []
        _, _, char_ids = self._decode(enc_outputs, self.pad_chunks)
        chars = []
        tf = self.text_featurizer
        for v in char_ids[0]:
            if v == 0 or (tf is not None and v == tf.endid()):
                break
            chars.append(tf.iextract(int(v)) if tf is not None else str(v))
        return chars

    def decode_phones(self, enc_outputs: Sequence[np.ndarray]) -> List[str]:
        if not enc_outputs:
            return []
        ids, lens, _ = self._decode(enc_outputs, 1)
        seq = list(ids[0, :int(lens[0])])
        if self.phone_featurizer is not None:
            return self.phone_featurizer.iextract(seq)
        return [str(s) for s in seq]
