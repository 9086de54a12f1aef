"""Punctuation-recovery dataloader.

Counterpart of ``tensorflowasr_tpu/data/punc_dataloader.py`` (numpy text
processing, copied), itself a port of the reference Punc_DataLoader
(punc_recover/dataloaders/punc_dataloader.py in Z-yq/TensorflowASR):

- raw punctuated text lines -> (char sequence, per-char punctuation label)
  via ``get_target`` (:170-183): a char's label is the punctuation that
  FOLLOWS it (label semantics: 0 = pad, 1 = no punctuation, >= 2 = index
  into the punctuation vocab + 2);
- char ids via a TextFeaturizer with ``<S>``/``</S>`` wrapping;
- optional BERT teacher features for distillation: the reference runs a
  keras-bert teacher online (:157-168); here teacher features are either
  precomputed ``.npy`` files named by line hash or absent (loss term
  drops to 0 in the trainer);
- resumable iteration state (epoch/offset) as an .npz snapshot (:26-44).

Batch: ids [B, T] i32, punc_labels [B, T] i32
(+ bert_features [B, T, 768] when available).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from tensorflowasr_tpu_torch.utils.config import cfg_get
from tensorflowasr_tpu_torch.utils.text import TextFeaturizer


class PuncDataLoader:
    def __init__(self, config, char_featurizer: TextFeaturizer,
                 punc_tokens: List[str], max_len: int = 64,
                 bert_feature_dir: Optional[str] = None, seed: int = 0):
        rc = config["running_config"] or {}
        self.char_featurizer = char_featurizer
        self.punc_tokens = list(punc_tokens)
        self.punc_to_label = {p: i + 2 for i, p in enumerate(self.punc_tokens)}
        self.num_punc_classes = len(self.punc_tokens) + 2
        self.max_len = max_len
        self.batch = int(cfg_get(rc, "batch_size", 32))
        self.bert_feature_dir = bert_feature_dir
        self.rng = np.random.default_rng(seed)
        outdir = cfg_get(rc, "outdir")
        self.state_path = os.path.join(outdir, "dg_state.npz") \
            if outdir else None

        train_list = cfg_get(rc, "train_list")
        eval_list = cfg_get(rc, "eval_list")
        self.train_list = self._read(train_list) if train_list else []
        self.test_list = self._read(eval_list) if eval_list else []
        self.train_offset = 0
        self.test_offset = 0
        self.epochs = 0
        self._try_resume()

    @staticmethod
    def _read(path: str) -> List[str]:
        with open(path, encoding="utf-8") as f:
            return [line.strip() for line in f if line.strip()]

    # -- resumable state (punc_dataloader.py:26-44) -------------------------
    def save_state(self):
        if self.state_path:
            os.makedirs(os.path.dirname(self.state_path), exist_ok=True)
            np.savez(self.state_path, epoch=self.epochs,
                     offset=self.train_offset)

    def _try_resume(self):
        if self.state_path and os.path.exists(self.state_path):
            snap = np.load(self.state_path)
            self.epochs = int(snap["epoch"])
            self.train_offset = min(int(snap["offset"]),
                                    max(len(self.train_list) - 1, 0))

    # -- target extraction --------------------------------------------------
    def get_target(self, text: str) -> Tuple[List[str], List[int]]:
        """punctuated text -> (chars, per-char labels). A char's label is
        the punctuation immediately following it (1 if none)."""
        chars: List[str] = []
        labels: List[int] = []
        for ch in text:
            if ch in self.punc_to_label:
                if labels:
                    labels[-1] = self.punc_to_label[ch]
                continue
            chars.append(ch)
            labels.append(1)
        return chars, labels

    def encode(self, text: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        enc = self.encode_windows(text)
        return enc[0] if enc else None

    def encode_windows(self, text: str
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Lines longer than max_len-2 chars become MULTIPLE training
        windows (stride max_len-2) instead of losing the tail to
        truncation — the reference pads to the batch max (pe_input 1024)
        but TPU batches need a static length."""
        chars, labels = self.get_target(text)
        if not chars:
            return []
        if not all(self.char_featurizer.has(c) for c in chars):
            return []
        body = self.max_len - 2
        out = []
        for s in range(0, len(chars), body):
            cw = chars[s:s + body]
            lw = labels[s:s + body]
            ids = ([self.char_featurizer.startid()]
                   + self.char_featurizer.extract(cw)
                   + [self.char_featurizer.endid()])
            labs = [1] + lw + [1]
            out.append((np.asarray(ids, np.int32),
                        np.asarray(labs, np.int32)))
        return out

    def _bert_path(self, line: str) -> Optional[str]:
        if not self.bert_feature_dir:
            return None
        h = hashlib.sha1(line.encode("utf-8")).hexdigest()[:16]
        return os.path.join(self.bert_feature_dir, f"{h}.npy")

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

    def generate(self, train: bool = True) -> Dict[str, np.ndarray]:
        ids_list, labs_list, feats_list = [], [], []
        have_feats = self.bert_feature_dir is not None
        guard = 0
        while len(ids_list) < self.batch:
            guard += 1
            if guard > 100 * self.batch:
                raise RuntimeError("too many rejected punc lines")
            line = self._next(train)
            windows = self.encode_windows(line)
            if not windows:
                continue
            feat = None
            if have_feats:
                p = self._bert_path(line)
                if p and os.path.exists(p):
                    feat = np.load(p).astype(np.float32)
                else:
                    have_feats = False
            body = self.max_len - 2
            for w, (ids, labs) in enumerate(windows):
                if len(ids_list) >= self.batch:
                    break
                fw = None
                if feat is not None:
                    s = w * body
                    n = len(ids) - 2
                    fw = np.full((len(ids), feat.shape[-1]), -10.0,
                                 np.float32)
                    if w == 0:
                        fw[0] = feat[0]            # CLS aligns with <S>
                    rows = feat[1 + s:1 + s + n]
                    fw[1:1 + len(rows)] = rows
                ids_list.append(ids)
                labs_list.append(labs)
                feats_list.append(fw)

        t = self.max_len
        n = len(ids_list)
        ids_arr = np.zeros((n, t), np.int32)
        labs_arr = np.zeros((n, t), np.int32)
        for i, (ids, labs) in enumerate(zip(ids_list, labs_list)):
            ids_arr[i, :len(ids)] = ids
            labs_arr[i, :len(labs)] = labs
        batch = {"ids": ids_arr, "punc_labels": labs_arr}
        if have_feats and all(f is not None for f in feats_list):
            feats = np.full((n, t, feats_list[0].shape[-1]), -10.0,
                            np.float32)
            for i, f in enumerate(feats_list):
                m = min(t, f.shape[0])
                feats[i, :m] = f[:m]
            batch["bert_features"] = feats
        return batch

    def generator(self, train: bool = True) -> Iterator[Dict]:
        while True:
            yield self.generate(train)
