"""VAD dataloader: self-supervised voice labels from energy segmentation.

Counterpart of ``tensorflowasr_tpu/data/vad_dataloader.py``, with the same
batches for the same seed and lists (host numpy, the same draws from one
``np.random.Generator`` in the same order):

- 2-5 clean utterances joined by 3200-sample silence gaps;
- voice labels from :func:`effects_split` (``librosa.effects.split(top_db=
  20, frame_length=800, hop_length=80)``);
- a random gain (p = 0.45) and the configured augmentation on the noisy
  input, while the clean, peak-normalised signal stays the denoising
  target;
- a crop or a pad to ``max_frames`` samples, cut into ``frame_input``-sample
  frames; a frame is voiced when its mean label exceeds ``voice_thread``.

Batch: x [B, N, F], labels [B, N, 1], wav_target [B, N, F], all f32.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

from tensorflowasr_tpu_torch.data.augment import Augmentation
from tensorflowasr_tpu_torch.utils.audio import read_wav
from tensorflowasr_tpu_torch.utils.config import cfg_get


def effects_split(y: np.ndarray, top_db: float = 20.0,
                  frame_length: int = 800, hop_length: int = 80
                  ) -> np.ndarray:
    """Non-silent intervals [[start, end], ...] in samples, by
    ``librosa.effects.split``'s rule (frame RMS in dB against the loudest
    frame's)."""
    n = len(y)
    if n < frame_length:
        return np.zeros((0, 2), np.int64)
    n_frames = 1 + (n - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(n_frames)[:, None])
    rms = np.sqrt(np.mean(y[idx] ** 2, axis=1))
    db = 20.0 * np.log10(np.maximum(rms, 1e-10)
                         / max(float(rms.max()), 1e-10))
    non_silent = db > -top_db
    edges = np.diff(non_silent.astype(np.int8), prepend=0, append=0)
    starts = np.nonzero(edges == 1)[0]
    ends = np.nonzero(edges == -1)[0]
    if not len(starts):
        return np.zeros((0, 2), np.int64)
    return np.stack([starts * hop_length,
                     np.minimum(ends * hop_length + frame_length, n)],
                    axis=1)


class VADDataLoader:
    def __init__(self, config, seed: int = 0):
        sc = config["speech_config"] or {}
        rc = config["running_config"] or {}
        self.speech_config = sc
        self.sample_rate = int(cfg_get(sc, "sample_rate", 8000))
        self.frame_input = int(cfg_get(sc, "frame_input", 80))
        self.max_frames = int(cfg_get(sc, "max_frames", 80 * 80))
        self.voice_thread = float(cfg_get(sc, "voice_thread", 0.4))
        self.batch = int(cfg_get(rc, "batch_size", 8))
        self.augment = Augmentation(config["augments_config"] or {},
                                    seed=seed)
        self.rng = np.random.default_rng(seed)
        self.epochs = 0
        # the lists may sit in running_config or, as in the reference's
        # layout, in speech_config
        train_list = cfg_get(rc, "train_list") or cfg_get(sc, "train_list")
        eval_list = cfg_get(rc, "eval_list") or cfg_get(sc, "eval_list")
        self.train_list: List[str] = self._read(train_list) \
            if train_list else []
        self.test_list: List[str] = self._read(eval_list) \
            if eval_list else []
        self.train_offset = 0
        self.test_offset = 0

    @staticmethod
    def _read(path: str) -> List[str]:
        with open(path, encoding="utf-8") as f:
            return [line.strip() for line in f if line.strip()]

    def _next(self, train: bool) -> str:
        if train:
            line = self.train_list[self.train_offset]
            self.train_offset += 1
            if self.train_offset >= len(self.train_list):
                self.train_offset = 0
                self.rng.shuffle(self.train_list)
                self.epochs += 1
        else:
            line = self.test_list[self.test_offset]
            self.test_offset += 1
            if self.test_offset >= len(self.test_list):
                self.test_offset = 0
        return line

    def _one_item(self, train: bool):
        # an empty list would make every item pure silence (all-zero
        # labels), which trains on nothing
        if not (self.train_list if train else self.test_list):
            raise ValueError(
                f"VADDataLoader: {'train' if train else 'eval'} list is "
                "empty; set running_config.train_list/eval_list (or "
                "speech_config's)")
        maxlen = self.max_frames
        wav = np.zeros(1, np.float32)
        wav_target = np.zeros(1, np.float32)
        label = np.zeros(1, np.float32)
        n_utts = int(self.rng.choice([2, 3, 4, 5]))
        for _ in range(n_utts):
            try:
                data, _ = read_wav(self._next(train),
                                   target_sr=self.sample_rate)
            except Exception:
                continue
            to_cut = data / (np.abs(data).max() + 1e-6)
            data_label = np.zeros_like(data)
            for s, e in effects_split(to_cut, top_db=20, frame_length=800,
                                      hop_length=80):
                data_label[int(s):int(e)] = 1.0
            if self.rng.random() < 0.45:
                data = data / (np.abs(data).max() + 1e-6)
                data = np.clip(data * (self.rng.random() * 2.0 + 0.1),
                               -1.0, 1.0)
            if self.augment.available():
                data = self.augment.process(data)
            gap = np.zeros(3200, np.float32)
            wav = np.hstack((wav, gap, data)).astype(np.float32)
            wav_target = np.hstack((wav_target, gap, to_cut)).astype(
                np.float32)
            label = np.hstack((label, np.zeros(3200), data_label)).astype(
                np.float32)
        if len(wav) > maxlen:
            start = int(self.rng.integers(0, len(wav) - maxlen))
            sl = slice(start, start + maxlen)
            wav, wav_target, label = wav[sl], wav_target[sl], label[sl]
        else:
            # the noise lead is clamped so that a short max_frames still
            # keeps the speech
            lead_len = min(8000, max(0, maxlen - len(wav)))
            lead = self.rng.random(lead_len).astype(np.float32) * 0.001
            tail = self.rng.random(maxlen).astype(np.float32) * 0.001
            wav = np.hstack((lead, wav, tail))[:maxlen]
            wav_target = np.hstack((lead, wav_target, tail))[:maxlen]
            label = np.hstack((np.zeros(lead_len, np.float32), label,
                               np.zeros(maxlen, np.float32)))[:maxlen]
        f = self.frame_input
        frame_label = label.reshape(-1, f).mean(-1, keepdims=True)
        return (wav.reshape(-1, f),
                (frame_label > self.voice_thread).astype(np.float32),
                wav_target.reshape(-1, f))

    def generate(self, train: bool = True) -> Dict[str, np.ndarray]:
        items = [self._one_item(train) for _ in range(self.batch)]
        xs, ys, y2s = zip(*items)
        return {"x": np.asarray(xs, np.float32),
                "labels": np.asarray(ys, np.float32),
                "wav_target": np.asarray(y2s, np.float32)}

    def generator(self, train: bool = True) -> Iterator[Dict]:
        while True:
            yield self.generate(train)
