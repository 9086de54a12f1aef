"""Inference engines for serving (greedy decode).

Counterpart of ``tensorflowasr_tpu/serve/engines.py`` (``ASREngine``,
``VADEngine``, ``PuncEngine``) and of the predict step in
``tensorflowasr_tpu/train/asr_trainer.py``. Chunk and utterance lengths are
padded to the same small set of shapes as in the JAX package, so both
produce the same ids from the same weights. Every engine runs under
``torch.no_grad`` and returns numpy. The beam and n-gram LM decoders are not
ported yet and raise.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tensorflowasr_tpu_torch.models.conformer import ConformerCTC
from tensorflowasr_tpu_torch.ops.ctc import ctc_greedy_decode
from tensorflowasr_tpu_torch.utils.device import resolve_device

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


class VADEngine:
    """VAD logits over framed waveform windows (vad/src/vad.py). The model
    moves to ``device`` in eval mode; its ``frame_input`` is the
    engine's."""

    def __init__(self, model: torch.nn.Module,
                 device: Union[str, torch.device] = "cuda"):
        self.frame_input = model.frame_input
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def inference(self, frames: np.ndarray) -> np.ndarray:
        """[1, n_frames, frame_input] -> [n_frames] logits."""
        x = torch.tensor(np.asarray(frames, np.float32), device=self.device)
        return self.model(x)[0].cpu().numpy().flatten()


class PuncEngine:
    """Punctuation recovery (punc_recover.py:46-62): insert the punctuation
    token after char i when the argmax class is >= 2 with probability >=
    ``threshold``. The model moves to ``device`` in eval mode."""

    def __init__(self, model: torch.nn.Module, char_featurizer,
                 punc_tokens: Sequence[str], threshold: float = 0.65,
                 max_len: int = 64,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.char_featurizer = char_featurizer
        self.punc_tokens = list(punc_tokens)
        self.threshold = threshold
        # the PE table bounds the usable sequence length
        pe_cap = getattr(getattr(model, "cfg", None), "pe_input", max_len)
        self.max_len = min(max_len, pe_cap)

    @torch.no_grad()
    def _infer(self, ids: np.ndarray) -> np.ndarray:
        """[1, max_len] ids -> [max_len, C] logits."""
        x = torch.tensor(ids, dtype=torch.int32, device=self.device)
        return self.model(x)[0][0].cpu().numpy()

    def _window_probs(self, ids: np.ndarray) -> np.ndarray:
        """[L] ids -> [L, C] probs. Inputs longer than ``max_len`` run
        through half-overlapping windows of ``max_len`` whose probabilities
        are blended with a triangular vote (a position trusts the window
        it is nearest the centre of)."""
        t = self.max_len
        length = len(ids)
        starts = [0]
        if length > t:
            stride = max(t // 2, 1)
            starts = list(range(0, length - t, stride)) + [length - t]
        prob_sum = np.zeros((length, 0), np.float32)
        weight_sum = np.zeros((length,), np.float32)
        for s in starts:
            buf = np.zeros((1, t), np.int32)
            n = min(length - s, t)
            buf[0, :n] = ids[s:s + n]
            logits = self._infer(buf)
            probs = np.exp(logits - logits.max(-1, keepdims=True))
            probs /= probs.sum(-1, keepdims=True)
            if prob_sum.shape[1] == 0:
                prob_sum = np.zeros((length, probs.shape[-1]), np.float32)
            w = np.minimum(np.arange(1, n + 1),
                           np.arange(n, 0, -1)).astype(np.float32)
            prob_sum[s:s + n] += probs[:n] * w[:, None]
            weight_sum[s:s + n] += w
        return prob_sum / np.maximum(weight_sum[:, None], 1e-6)

    def punc_recover(self, chars: Sequence[str]) -> List[str]:
        """Every input char comes out; chars outside the vocabulary (digits,
        latin, rare hanzi) do not feed the model and get no punctuation
        after them."""
        f = self.char_featurizer
        known = [c for c in chars if f.has(c)]
        if not known:
            return list(chars)
        ids = np.asarray([f.startid()] + f.extract(known) + [f.endid()],
                         np.int32)
        probs = self._window_probs(ids)
        out: List[str] = []
        pos = 0                         # model position of the next known
        for ch in chars:                # char
            out.append(ch)
            if not f.has(ch):
                continue
            pos += 1
            if pos >= len(ids):
                continue
            best = int(np.argmax(probs[pos]))
            if best >= 2 and probs[pos, best] >= self.threshold:
                idx = best - 2
                if idx < len(self.punc_tokens):
                    out.append(self.punc_tokens[idx])
        return out
