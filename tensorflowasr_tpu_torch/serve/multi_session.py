"""Many concurrent chunk streams on one card.

Counterpart of ``MultiStreamChunkServer`` in
``tensorflowasr_tpu/serve/multi_session.py``. One stream at a time leaves
the card almost idle, so the pool advances the 160 ms chunks of every open
stream in one ``ChunkConformer.batched_stream_step`` over a fixed number of
slots:

- ``open()`` leases a slot; its state is zeroed on the slot's next
  advancing tick through the step's ``reset`` mask (no extra dispatch);
- ``feed(slot, wav)`` buffers audio on the host; ``tick()`` advances every
  slot with a full chunk buffered, and the ``advance`` mask keeps the
  others' state as it was;
- ``close(slot)`` pads the remainder to a chunk, drains it and returns the
  final result.

A tick is one dispatch and one fetch of a packed int32 tensor. Each slot
gathers its ids exactly as ``ChunkStreamSession`` does, so a pool of
interleaved streams gives each the result it would get alone. The threaded
batching front and the socket ops are not ported yet.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from tensorflowasr_tpu_torch.models.chunk_conformer import ChunkConformer
from tensorflowasr_tpu_torch.serve.chunk_session import (
    StreamDecode,
    packed_step,
)
from tensorflowasr_tpu_torch.utils.device import resolve_device


class _SlotState(StreamDecode):
    def __init__(self, sub_length: int, n_prov: int, phone_blank: int):
        super().__init__(sub_length, n_prov, phone_blank)
        self.active = False
        self.pending_reset = False


class MultiStreamChunkServer:
    """A pool of ``n_slots`` streams on ``cuda`` (or ``device="cpu"``); a
    CUDA request without CUDA raises."""

    def __init__(self, model: ChunkConformer, n_slots: int = 16,
                 phone_featurizer=None, text_featurizer=None,
                 device: Union[str, torch.device, None] = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.n_slots = n_slots
        self.phone_featurizer = phone_featurizer
        self.text_featurizer = text_featurizer
        self.phone_blank = model.num_phone_classes - 1
        self.char_blank = model.num_char_classes - 1
        self._n_prov = max(self.cfg.decoder.lookahead, 1)
        with torch.no_grad():
            self.caches = model.init_multi_stream_caches(n_slots)
        self._slots = [self._new_slot() for _ in range(n_slots)]
        self._free = list(range(n_slots - 1, -1, -1))

    def _new_slot(self) -> _SlotState:
        return _SlotState(self.cfg.sub_length, self._n_prov,
                          self.phone_blank)

    # -- stream lifecycle ---------------------------------------------------
    def open(self) -> int:
        """Lease a slot for a new stream; raises if the pool is full."""
        if not self._free:
            raise RuntimeError(f"all {self.n_slots} stream slots busy")
        slot = self._free.pop()
        s = self._slots[slot] = self._new_slot()
        s.active = True
        s.pending_reset = True
        return slot

    def feed(self, slot: int, wav: np.ndarray) -> None:
        """Buffer audio for a slot (no device work until ``tick``)."""
        s = self._checked(slot)
        s.wav_rem = np.concatenate([s.wav_rem, np.asarray(wav, np.float32)])

    def tick(self) -> None:
        """Advance every slot with a full chunk buffered, until none has
        one left."""
        cs = self.cfg.chunk_samples
        while True:
            adv = np.array([s.active and len(s.wav_rem) >= cs
                            for s in self._slots], bool)
            if not adv.any():
                return
            self._dispatch(adv)

    def close(self, slot: int) -> dict:
        """Pad the remainder to a chunk, drain, return the final result and
        release the slot."""
        s = self._checked(slot)
        pad = (-len(s.wav_rem)) % self.cfg.chunk_samples
        if pad:
            s.wav_rem = np.concatenate([s.wav_rem,
                                        np.zeros((pad,), np.float32)])
        self.tick()
        out = self.result(slot)
        s.active = False
        self._free.append(slot)
        return out

    def result(self, slot: int) -> dict:
        return self._checked(slot).result(
            self.phone_blank, self.char_blank, self.phone_featurizer,
            self.text_featurizer)

    @property
    def n_active(self) -> int:
        return sum(s.active for s in self._slots)

    # -- internals ----------------------------------------------------------
    def _checked(self, slot: int) -> _SlotState:
        s = self._slots[slot]
        if not s.active:
            raise ValueError(f"slot {slot} is not an open stream")
        return s

    def _dispatch(self, adv: np.ndarray) -> None:
        cs = self.cfg.chunk_samples
        wavs = np.zeros((self.n_slots, cs), np.float32)
        reset = np.zeros((self.n_slots,), bool)
        for i, s in enumerate(self._slots):
            if adv[i]:
                wavs[i] = s.wav_rem[:cs]
                s.wav_rem = s.wav_rem[cs:]
                reset[i] = s.pending_reset
        dev = self.device
        with torch.no_grad():
            packed, self.caches = packed_step(
                self.model, torch.from_numpy(wavs).to(dev), self.caches,
                torch.from_numpy(reset).to(dev),
                torch.from_numpy(adv).to(dev))
        packed = packed.cpu().numpy()                 # one fetch a tick
        for i, s in enumerate(self._slots):
            if adv[i]:
                s.pending_reset = False
                s.add(packed[i])
