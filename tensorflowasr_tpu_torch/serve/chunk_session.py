"""Chunk-streaming (SMLTA2) serving session for one stream.

Counterpart of ``tensorflowasr_tpu/serve/chunk_session.py``. The host keeps
the audio that does not fill a chunk yet; each complete chunk of
``chunk_samples`` goes through ``ChunkConformer.fused_stream_step`` (front,
encoder, picker, feature pick and the char-decoder micro-steps, with all
streaming state on the device) and comes back as ONE int32 tensor of phone
ids, char ids, provisional ids and ``n_final``: one device-to-host copy per
chunk. Streaming output equals the offline decode.
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from tensorflowasr_tpu_torch.models.chunk_conformer import ChunkConformer
from tensorflowasr_tpu_torch.utils.device import resolve_device


def collapse(ids: List[int], blank: int) -> List[int]:
    """Merge repeats, then drop blanks."""
    out: List[int] = []
    prev = -1
    for i in ids:
        if i != prev and i != blank:
            out.append(i)
        prev = i
    return out


class StreamDecode:
    """The host side of one stream's decode: the remainder buffer and the
    ids gathered from each chunk's packed row."""

    def __init__(self, sub_length: int, n_prov: int, phone_blank: int):
        self._t, self._wb, self._blank = sub_length, n_prov, phone_blank
        self.wav_rem = np.zeros((0,), np.float32)
        self.phone_ids: List[int] = []
        self.char_ids: List[int] = []
        self.provisional_ids: List[int] = []

    def add(self, row: np.ndarray) -> None:
        """One chunk's packed row [t phone | t char | wb prov | n_final]."""
        t, wb = self._t, self._wb
        phone_ids = row[:t]
        n = int(row[2 * t + wb])
        if n <= 0:
            return
        self.phone_ids.extend(int(i) for i in phone_ids[-n:])
        self.char_ids.extend(int(i) for i in row[t:2 * t] if i >= 0)
        if np.any(phone_ids[-n:] != self._blank):
            self.provisional_ids = [int(i) for i in row[2 * t:2 * t + wb]
                                    if i >= 0]

    def result(self, phone_blank: int, char_blank: int, phone_featurizer,
               text_featurizer) -> dict:
        phone_seq = collapse(self.phone_ids, phone_blank)
        char_seq = collapse(self.char_ids + self.provisional_ids, char_blank)
        out = {"phone_ids": phone_seq, "char_ids": char_seq}
        if phone_featurizer is not None:
            out["phones"] = phone_featurizer.iextract(phone_seq)
        if text_featurizer is not None:
            out["text"] = "".join(text_featurizer.iextract(char_seq))
        return out


def packed_step(model: ChunkConformer, wav_chunks: torch.Tensor, caches,
                reset=None, advance=None):
    """``batched_stream_step`` with its ids packed into one int32 tensor
    [S, t + t + max(L_d, 1) + 1] -> (packed, new caches)."""
    phone_ids, char_ids, prov_ids, n_final, new = model.batched_stream_step(
        wav_chunks, caches, reset, advance)
    packed = torch.cat([phone_ids, char_ids, prov_ids, n_final[:, None]],
                       dim=1)
    return packed, new


class ChunkStreamSession:
    """One stream: ``feed`` audio of any length, ``flush`` at its end,
    ``result`` at any time. Runs on ``cuda`` unless given
    ``device="cpu"``; a CUDA request without CUDA raises."""

    def __init__(self, model: ChunkConformer, phone_featurizer=None,
                 text_featurizer=None,
                 device: Union[str, torch.device, None] = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.phone_featurizer = phone_featurizer
        self.text_featurizer = text_featurizer
        self.phone_blank = model.num_phone_classes - 1
        self.char_blank = model.num_char_classes - 1
        self._n_prov = max(self.cfg.decoder.lookahead, 1)
        self.reset()

    def reset(self) -> None:
        with torch.no_grad():
            self.caches = self.model.init_stream_caches(1)
        self._decode = StreamDecode(self.cfg.sub_length, self._n_prov,
                                    self.phone_blank)

    def feed(self, wav: np.ndarray) -> dict:
        """Buffer float32 audio, run every complete chunk, return the live
        result."""
        d = self._decode
        d.wav_rem = np.concatenate([d.wav_rem, np.asarray(wav, np.float32)])
        cs = self.cfg.chunk_samples
        while len(d.wav_rem) >= cs:
            self._process_chunk(d.wav_rem[:cs])
            d.wav_rem = d.wav_rem[cs:]
        return self.result()

    def flush(self) -> dict:
        """End of stream: zero-pad the remainder to one chunk. Frames still
        in the decoder's lookahead ring show through the provisional ids."""
        d = self._decode
        if len(d.wav_rem) > 0:
            chunk = np.zeros((self.cfg.chunk_samples,), np.float32)
            chunk[:len(d.wav_rem)] = d.wav_rem
            d.wav_rem = np.zeros((0,), np.float32)
            self._process_chunk(chunk)
        return self.result()

    def result(self) -> dict:
        return self._decode.result(self.phone_blank, self.char_blank,
                                   self.phone_featurizer,
                                   self.text_featurizer)

    def _process_chunk(self, chunk: np.ndarray) -> None:
        x = torch.from_numpy(np.ascontiguousarray(chunk[None, :]))
        with torch.no_grad():
            packed, self.caches = packed_step(
                self.model, x.to(self.device), self.caches)
        self._decode.add(packed[0].cpu().numpy())      # one fetch a chunk
