"""Acoustic-model dataloader: host-side batcher with LENGTH BUCKETING.

Counterpart of ``tensorflowasr_tpu/data/am_dataloader.py``, with the same
buckets, static shapes and batch keys, so the same seed and corpus give
the same batches. Utterances are binned into a small set of duration
buckets and every batch is padded to its bucket's FIXED wav/phone/char
capacities: a handful of shapes, ever, which keeps the device allocator's
cache and any later graph capture stable.

Per-line processing:
- ``path<TAB>TEXT`` lists; wav load at target sr; skip on load error,
  on < 400 samples, on > wav_max_duration
- optional only_chinese text cleanup
- offline: wav normalized by max |x|; in_len = samples // (rf * hop);
  streaming: chunk-quantized in_len
- text -> pinyin (pypinyin w/ phrase overrides or lexicon) -> phone ids;
  char ids + ``</S>`` appended; skip when any token is out of vocabulary
  or in_len < phone length
- in train mode, ~25% of the batch is re-drawn through ``Augmentation``

Emitted batch dict (numpy; the trainer moves it to the device):
  wav [B, Tcap] i16, input_length [B] i32, phones [B, Lcap] i32,
  phone_length [B] i32, chars [B, Ucap] i32, char_length [B] i32.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tensorflowasr_tpu_torch.data.augment import Augmentation
from tensorflowasr_tpu_torch.data.prefetch import (
    PrefetchIterator,
    parallel_map,
)
from tensorflowasr_tpu_torch.utils.audio import SpeechFeaturizer
from tensorflowasr_tpu_torch.utils.config import cfg_get
from tensorflowasr_tpu_torch.utils.text import (
    PinyinConverter,
    TextFeaturizer,
    only_chinese,
    tokens_to_phones,
)

logger = logging.getLogger(__name__)


class BucketSpec:
    """One duration bucket: fixed wav/label capacities."""

    def __init__(self, seconds: float, sample_rate: int, hop: int,
                 reduction_factor: int, phones_per_sec: float,
                 chars_per_sec: float, chunk_samples: int = 0):
        self.seconds = seconds
        quantum = hop * reduction_factor
        raw = int(seconds * sample_rate)
        self.wav_cap = ((raw + quantum - 1) // quantum) * quantum
        if chunk_samples:
            self.wav_cap = ((self.wav_cap + chunk_samples - 1)
                            // chunk_samples) * chunk_samples
        self.phone_cap = max(int(seconds * phones_per_sec) + 5, 8)
        self.char_cap = max(int(seconds * chars_per_sec) + 5, 8)

    def __repr__(self):
        return (f"Bucket({self.seconds}s wav={self.wav_cap} "
                f"L={self.phone_cap} U={self.char_cap})")


class AMDataLoader:
    def __init__(self, config, phone_featurizer: TextFeaturizer,
                 text_featurizer: TextFeaturizer,
                 pinyin: Optional[PinyinConverter] = None,
                 pinyin2phone: Optional[dict] = None,
                 transcripts_are_pinyin: bool = False,
                 bucket_seconds: Sequence[float] = (4.0, 8.0, 12.0, 16.0),
                 phones_per_sec: float = 12.0,
                 chars_per_sec: float = 10.0,
                 seed: int = 0):
        sc = config["speech_config"] or {}
        rc = config["running_config"] or {}
        self.speech_config = sc
        self.featurizer = SpeechFeaturizer(sc)
        self.phone_featurizer = phone_featurizer
        self.text_featurizer = text_featurizer
        self.pinyin = pinyin
        self.pinyin2phone = pinyin2phone or {}
        self.transcripts_are_pinyin = transcripts_are_pinyin
        self.batch = int(cfg_get(rc, "batch_size", 16))
        self.only_chinese = bool(sc.get("only_chinese", False))
        # translator targets end in </S>; a chunk-model loader built on
        # this class would turn it off
        self.append_char_endid = True
        self.wav_max_duration = float(sc.get("wav_max_duration", 16))
        self.streaming = bool(sc.get("streaming", False))
        self.rng = np.random.default_rng(seed)

        sr = self.featurizer.sample_rate
        hop = self.featurizer.hop_size
        rf = self.featurizer.reduction_factor
        self.reduce = rf * hop
        if self.streaming:
            quantum = self.reduce
            raw = int(float(sc.get("streaming_bucket", 0.5)) * sr)
            self.chunk = max(quantum, (raw // quantum) * quantum)
        else:
            self.chunk = 0
        # YAML override: speech_config.bucket_seconds — match the bucket
        # grid to the corpus' duration distribution (everything pads up to
        # its bucket cap, so a 4s smallest bucket wastes 2-4x loader +
        # frontend work on short-utterance corpora)
        cfg_secs = sc.get("bucket_seconds")
        if cfg_secs:
            bucket_seconds = [float(s) for s in cfg_secs]
        secs = [s for s in sorted(bucket_seconds)
                if s <= self.wav_max_duration + 1e-9]
        if not secs:
            # nothing fits under wav_max_duration: one bucket at the cap
            secs = [self.wav_max_duration]
        self.buckets = [BucketSpec(s, sr, hop, rf, phones_per_sec,
                                   chars_per_sec, self.chunk)
                        for s in secs]

        aug_cfg = config["augments_config"]
        self.augment = Augmentation(aug_cfg if aug_cfg else {}, seed=seed)

        # the list paths live in speech_config (configs/am_data.yml);
        # running_config is accepted as a fallback
        train_list = sc.get("train_list") or rc.get("train_list") \
            if hasattr(rc, "get") else sc.get("train_list")
        eval_list = sc.get("eval_list") or rc.get("eval_list") \
            if hasattr(rc, "get") else sc.get("eval_list")
        self.train_list: List[str] = self._read_list(train_list) \
            if train_list else []
        self.test_list: List[str] = self._read_list(eval_list) \
            if eval_list else []
        self.train_offset = 0
        self.test_offset = 0
        self.epochs = 0
        # samples that loaded fine but needed a larger bucket than the batch
        # being assembled; queued here and drained first by later batches so
        # no loadable data is ever discarded
        self._carry: List[Tuple[np.ndarray, List[int], List[int],
                                BucketSpec]] = []
        self._line_lock = threading.Lock()

    @staticmethod
    def _read_list(path: str) -> List[str]:
        with open(path, encoding="utf-8") as f:
            return [line.strip() for line in f if line.strip()]

    # -- text pipeline ------------------------------------------------------
    def text_to_phones(self, txt: str) -> List[str]:
        if self.transcripts_are_pinyin:
            pins = txt.split()
        elif self.pinyin is not None and self.pinyin.available:
            pins = self.pinyin.convert(txt)
        else:
            raise RuntimeError("no hanzi->pinyin backend configured")
        if self.pinyin2phone:
            return tokens_to_phones(pins, self.pinyin2phone,
                                    self.phone_featurizer)
        return pins

    def _check_valid(self, tokens: Sequence[str],
                     featurizer: TextFeaturizer) -> bool:
        return all(featurizer.has(t) for t in tokens)

    # -- sample pipeline ----------------------------------------------------
    def _next_line(self, train: bool) -> str:
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

    def _input_length(self, n_samples: int) -> int:
        if not self.streaming:
            return int(n_samples // self.reduce)
        in_len = n_samples // self.chunk + (1 if n_samples % self.chunk
                                            else 0)
        chunk_times = self.chunk // self.reduce + (
            1 if self.chunk % self.reduce else 0)
        return int(in_len * chunk_times)

    def load_one(self, line: str, augment: bool = False
                 ) -> Optional[Tuple[np.ndarray, List[int], List[int]]]:
        """line -> (wav, phone ids, char ids+</S>) or None to skip."""
        try:
            wp, txt = line.split("\t", 1)
        except ValueError:
            return None
        try:
            wav = self.featurizer.load_wav(wp)
        except Exception:
            logger.info("%s load data failed, skip", wp)
            return None
        if len(wav) < 400:
            return None
        if len(wav) > self.featurizer.sample_rate * self.wav_max_duration:
            logger.info("%s duration > wav_max_duration, skip", wp)
            return None
        if augment and self.augment.available():
            wav = self.augment.process(wav)
        if self.only_chinese:
            txt = only_chinese(txt)
        try:
            py = self.text_to_phones(txt)
        except Exception:
            return None
        if not self._check_valid(py, self.phone_featurizer):
            logger.info("%s phones not all in vocab, skip", txt)
            return None
        chars = (txt.split() if self.transcripts_are_pinyin else list(txt))
        if not self._check_valid(chars, self.text_featurizer):
            logger.info("%s chars not all in vocab, skip", txt)
            return None
        if not self.streaming:
            peak = np.abs(wav).max()
            if peak > 0:
                wav = wav / peak
        phone_ids = self.phone_featurizer.extract(py)
        char_ids = self.text_featurizer.extract(chars)
        if self.append_char_endid:
            char_ids = char_ids + [self.text_featurizer.endid()]
        if self._input_length(len(wav)) < len(phone_ids):
            return None
        return wav, phone_ids, char_ids

    def _bucket_for(self, wav_len: int, n_phones: int, n_chars: int
                    ) -> Optional[BucketSpec]:
        for b in self.buckets:
            if (wav_len <= b.wav_cap and n_phones <= b.phone_cap
                    and n_chars <= b.char_cap):
                return b
        return None

    def generate(self, train: bool = True,
                 bucket: Optional[BucketSpec] = None,
                 num_workers: int = 1) -> Dict[str, np.ndarray]:
        """One padded batch; all samples share one bucket (the bucket of
        the first accepted sample unless pinned via ``bucket``).
        ``num_workers`` > 1 loads wavs through a thread pool (line drawing
        stays ordered under a lock)."""
        source = self.train_list if train else self.test_list
        if not source:
            raise RuntimeError("empty data list")
        wavs, phones, chars = [], [], []
        chosen = bucket
        # drain carried-over samples first; when the bucket is not pinned,
        # start from the largest carried bucket so the queue always empties
        if self._carry:
            if chosen is None:
                chosen = max((it[3] for it in self._carry),
                             key=lambda b: b.wav_cap)
            keep = []
            for it in self._carry:
                if (len(wavs) < self.batch
                        and it[3].wav_cap <= chosen.wav_cap):
                    wavs.append(it[0])
                    phones.append(it[1])
                    chars.append(it[2])
                else:
                    keep.append(it)
            self._carry = keep
        guard = 0
        while len(wavs) < self.batch:
            guard += 1
            if guard > 100 * self.batch:
                raise RuntimeError("too many rejected samples; check vocab "
                                   "and bucket settings")
            need = self.batch - len(wavs)
            with self._line_lock:
                lines = [self._next_line(train) for _ in range(need)]
            augs = [train and self.augment.available()
                    and self.rng.random() < 0.25 for _ in lines]
            items = parallel_map(
                lambda la: self.load_one(la[0], augment=la[1]),
                list(zip(lines, augs)), num_workers=num_workers)
            for item in items:
                if item is None:
                    continue
                wav, ph, ch = item
                b = self._bucket_for(len(wav), len(ph), len(ch))
                if b is None:
                    continue
                if chosen is None:
                    chosen = b
                if b.wav_cap > chosen.wav_cap or len(wavs) >= self.batch:
                    # keep for a later batch instead of dropping, which
                    # would bias against long utterances
                    self._carry.append((wav, ph, ch, b))
                    continue
                wavs.append(wav)
                phones.append(ph)
                chars.append(ch)
        return self._pack(wavs, phones, chars, chosen)

    def _pack(self, wavs, phones, chars, b: BucketSpec
              ) -> Dict[str, np.ndarray]:
        n = len(wavs)
        # int16 wire format: wav floats are k/32768 already (PCM16 source
        # or the int16-quantizing augment pipeline), so this is lossless
        # and HALVES the host-to-device batch transfer; the model
        # dequantizes on the device (ops/frontend.wav_to_float)
        wav_arr = np.zeros((n, b.wav_cap), np.int16)
        ph_arr = np.zeros((n, b.phone_cap), np.int32)
        ch_arr = np.zeros((n, b.char_cap), np.int32)
        in_len = np.zeros((n,), np.int32)
        ph_len = np.zeros((n,), np.int32)
        ch_len = np.zeros((n,), np.int32)
        for i, (w, p, c) in enumerate(zip(wavs, phones, chars)):
            wav_arr[i, :len(w)] = np.clip(
                np.round(np.asarray(w, np.float32) * 32768.0),
                -32768, 32767).astype(np.int16)
            ph_arr[i, :len(p)] = p
            ch_arr[i, :len(c)] = c
            in_len[i] = self._input_length(len(w))
            ph_len[i] = len(p)
            ch_len[i] = len(c)
        return {
            "wav": wav_arr, "input_length": in_len,
            "phones": ph_arr, "phone_length": ph_len,
            "chars": ch_arr, "char_length": ch_len,
        }

    def generator(self, train: bool = True, num_workers: int = 1,
                  prefetch_depth: int = 0
                  ) -> Iterator[Dict[str, np.ndarray]]:
        """Endless batch iterator. ``prefetch_depth`` > 0 moves batch
        production to a background thread (host prep overlaps device
        compute). One producer thread: :meth:`generate` draws from the
        list cursor, the carried-over samples and the augmentation stream
        in turn, so batches from several producers would depend on thread
        timing, and the ranks of a data-parallel run, which each run this
        loader from one seed, would see different batches. A batch's wav
        loading still runs on ``num_workers`` threads."""
        if prefetch_depth > 0:
            return PrefetchIterator(
                lambda: self.generate(train, num_workers=num_workers),
                depth=prefetch_depth, num_workers=1)

        def gen():
            while True:
                yield self.generate(train, num_workers=num_workers)

        return gen()
