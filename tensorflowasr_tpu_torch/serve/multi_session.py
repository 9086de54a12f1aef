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
interleaved streams gives each the result it would get alone.

``BatchingStreamFront`` puts the pool behind concurrent clients: each
client's ``feed`` buffers its audio and blocks, and one ticker thread
advances every slot with a full chunk in one tick (chunks that arrive within
``max_wait_ms`` of each other share it) and does all of the card's work.
``build_stream_ops`` is its op table for ``serve/model_server.py``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Union

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


class BatchingStreamFront:
    """Thread-safe dynamic batching over a ``MultiStreamChunkServer``.

    Connection threads call ``feed`` concurrently; one ticker thread
    coalesces the chunks that arrive within ``max_wait_ms`` of each other
    and advances them in one tick, under its own ``torch.no_grad`` (grad
    mode is thread-local). A caller blocks on a condition until its slot's
    complete chunks have been consumed.
    """

    def __init__(self, server: MultiStreamChunkServer,
                 max_wait_ms: float = 8.0, feed_deadline_s: float = 120.0):
        self._srv = server
        self._cv = threading.Condition()
        self._max_wait = max_wait_ms / 1000.0
        self._feed_deadline = feed_deadline_s
        self._stop = False
        self._dead: Optional[BaseException] = None    # the ticker's crash
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- client API (any thread) --------------------------------------------
    def open(self) -> int:
        with self._cv:
            return self._srv.open()

    def feed(self, slot: int, wav: np.ndarray) -> dict:
        """Buffer audio and block until every complete chunk of the slot's
        buffer has been processed; returns the live result.

        The wait is a heartbeat: every second it re-checks, wakes the ticker
        again (so a lost wakeup costs one beat, never a hang) and checks
        that the ticker is alive. A ticker crash is raised here, and after
        ``feed_deadline_s`` without progress a diagnostic of the pool's
        state is."""
        cs = self._srv.cfg.chunk_samples
        s = self._srv._slots[slot]
        with self._cv:
            self._srv.feed(slot, wav)
            self._cv.notify_all()                     # wake the ticker
            deadline = time.monotonic() + self._feed_deadline
            last_rem = len(s.wav_rem)
            while len(s.wav_rem) >= cs:
                self._check_ticker()
                if len(s.wav_rem) < last_rem:
                    # progress: the deadline bounds stalls, not the drain
                    # time of a large feed
                    last_rem = len(s.wav_rem)
                    deadline = time.monotonic() + self._feed_deadline
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"feed(slot={slot}) made no progress for "
                        f"{self._feed_deadline:.0f}s; pool state: "
                        + self._debug_state())
                if not self._cv.wait(timeout=1.0):
                    self._cv.notify_all()             # heartbeat
            return self._srv.result(slot)

    def result(self, slot: int) -> dict:
        with self._cv:
            return self._srv.result(slot)

    def close(self, slot: int) -> dict:
        with self._cv:
            out = self._srv.close(slot)
            # close() ran a drain tick that may have consumed other slots'
            # chunks: their feeders wait on the condition and must wake
            self._cv.notify_all()
            return out

    def shutdown(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _check_ticker(self) -> None:
        if self._dead is not None:
            raise RuntimeError("batching ticker thread crashed") \
                from self._dead
        if self._stop:
            raise RuntimeError("BatchingStreamFront is shut down")
        if not self._thread.is_alive():
            raise RuntimeError("batching ticker thread is not running")

    def _debug_state(self) -> str:
        cs = self._srv.cfg.chunk_samples
        slots = [
            f"slot{i}(active={s.active}, buffered={len(s.wav_rem)}/{cs})"
            for i, s in enumerate(self._srv._slots)]
        return (f"ticker_alive={self._thread.is_alive()} "
                f"stop={self._stop} " + " ".join(slots))

    # -- ticker --------------------------------------------------------------
    def _has_full_chunk(self) -> bool:
        cs = self._srv.cfg.chunk_samples
        return any(s.active and len(s.wav_rem) >= cs
                   for s in self._srv._slots)

    def _loop(self) -> None:
        try:
            with torch.no_grad(), self._cv:
                while True:
                    self._cv.wait_for(
                        lambda: self._stop or self._has_full_chunk())
                    if self._stop:
                        return
                    # the coalescing window: feeds arriving now join this
                    # tick (the lock is released while waiting)
                    if self._max_wait > 0:
                        self._cv.wait(timeout=self._max_wait)
                        if self._stop:
                            return
                    self._srv.tick()
                    self._cv.notify_all()
        except BaseException as e:                    # reaches the feeders
            with self._cv:
                self._dead = e
                self._cv.notify_all()
            raise


def build_stream_ops(front: BatchingStreamFront) -> Dict[str, Callable]:
    """The socket op table (``serve/model_server.py``'s wire) of chunk
    streaming. Results are ids: the client maps them to text (the C++ host
    owns the tokener, ``cpp/serving/include/tokener.h``)."""

    def _pair(out: dict):
        return [np.asarray(out["phone_ids"], np.int32),
                np.asarray(out["char_ids"], np.int32)]

    def stream_info() -> np.ndarray:
        """[chunk_samples, sample_rate, n_slots]: clients pace their feeds
        from it."""
        srv = front._srv
        return np.asarray([srv.cfg.chunk_samples, srv.cfg.sample_rate,
                           srv.n_slots], np.int32)

    def stream_open() -> np.ndarray:
        return np.asarray([front.open()], np.int32)

    def stream_feed(slot: np.ndarray, wav: np.ndarray):
        return _pair(front.feed(int(slot.reshape(-1)[0]),
                                wav.reshape(-1)))

    def stream_result(slot: np.ndarray):
        return _pair(front.result(int(slot.reshape(-1)[0])))

    def stream_close(slot: np.ndarray):
        return _pair(front.close(int(slot.reshape(-1)[0])))

    return {"stream_info": stream_info, "stream_open": stream_open,
            "stream_feed": stream_feed, "stream_result": stream_result,
            "stream_close": stream_close}
