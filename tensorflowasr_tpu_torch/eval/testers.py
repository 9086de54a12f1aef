"""Evaluation harness: phone and char SER / CER with S/I/D breakdowns.

Counterpart of ``AMTester``, ``ChunkTester``, ``VADTester`` and
``PuncTester`` in ``tensorflowasr_tpu/eval/testers.py``: drives a predict
or eval step over an eval iterator and accumulates metrics on the host.

    tester.run(batch_iter, max_batches) -> dict of final metrics
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from tensorflowasr_tpu_torch.utils.metrics import ErrorRateAccumulator

logger = logging.getLogger(__name__)


def _trim_pad(ids: np.ndarray, length: int) -> list:
    return list(ids[:length])


def _result(phone_acc: ErrorRateAccumulator,
            char_acc: ErrorRateAccumulator) -> dict:
    return {**{f"phone_{k}": v for k, v in phone_acc.result().items()},
            **{f"char_{k}": v for k, v in char_acc.result().items()}}


class AMTester:
    """Offline ConformerCTC eval: phone SER/CER from greedy CTC + char
    SER/CER from the translator."""

    def __init__(self, trainer, log_every: int = 20,
                 char_end_id: Optional[int] = None):
        self.trainer = trainer
        self.log_every = log_every
        self.char_end_id = char_end_id
        self.phone_acc = ErrorRateAccumulator("cer")
        self.char_acc = ErrorRateAccumulator("cer")

    def run(self, batch_iter: Iterable[Dict[str, np.ndarray]],
            max_batches: Optional[int] = None) -> dict:
        self.phone_acc.reset()
        self.char_acc.reset()
        device = self.trainer.device
        for step, batch in enumerate(batch_iter):
            if max_batches is not None and step >= max_batches:
                break
            wav = torch.from_numpy(np.asarray(batch["wav"])).to(device)
            in_len = torch.from_numpy(
                np.asarray(batch["input_length"])).to(device)
            phone_ids, phone_lens, char_ids = self.trainer.predict_step(
                self.trainer.state, wav, in_len)
            phone_ids = phone_ids.cpu().numpy()
            phone_lens = phone_lens.cpu().numpy()
            char_ids = char_ids.cpu().numpy()
            for i in range(wav.shape[0]):
                ref_p = _trim_pad(batch["phones"][i],
                                  int(batch["phone_length"][i]))
                hyp_p = _trim_pad(phone_ids[i], int(phone_lens[i]))
                self.phone_acc.update(ref_p, hyp_p)
                # the end id is stripped from BOTH sides: references carry
                # </S> but the translator hypothesis stops AT it, and
                # counting it would score one deletion per utterance
                ref_c = [v for v in _trim_pad(batch["chars"][i],
                                              int(batch["char_length"][i]))
                         if v != self.char_end_id]
                hyp_c = self._trim_chars(char_ids[i])
                self.char_acc.update(ref_c, hyp_c)
            if (step + 1) % self.log_every == 0:
                logger.info("eval step %d: %s", step + 1, self.result())
        return self.result()

    def _trim_chars(self, ids: np.ndarray) -> list:
        """Stop at the first pad (0) or the </S> end id when configured."""
        out = []
        for v in ids:
            if v == 0 or (self.char_end_id is not None
                          and v == self.char_end_id):
                break
            out.append(int(v))
        return out

    def result(self) -> dict:
        return _result(self.phone_acc, self.char_acc)


class ChunkTester:
    """ChunkConformer offline eval: phone SER/CER from the picker's greedy
    CTC and char SER/CER from the decoder on the picked frames.
    ``predict_step`` is ``ChunkTrainer.predict_step``: (state, wav,
    input_length) -> (char_ids, char_lens, phone_ids, phone_lens)."""

    def __init__(self, predict_step: Callable, state, log_every: int = 20):
        self.predict_step = predict_step
        self.state = state
        self.log_every = log_every
        self.phone_acc = ErrorRateAccumulator("cer")
        self.char_acc = ErrorRateAccumulator("cer")

    def run(self, batch_iter: Iterable[Dict[str, np.ndarray]],
            max_batches: Optional[int] = None) -> dict:
        self.phone_acc.reset()
        self.char_acc.reset()
        device = next(self.state.model.parameters()).device
        for step, batch in enumerate(batch_iter):
            if max_batches is not None and step >= max_batches:
                break
            wav = torch.from_numpy(np.asarray(batch["wav"])).to(device)
            in_len = torch.from_numpy(
                np.asarray(batch["input_length"])).to(device)
            char_ids, char_lens, phone_ids, phone_lens = (
                x.cpu().numpy() for x in self.predict_step(self.state, wav,
                                                           in_len))
            for i in range(wav.shape[0]):
                self.phone_acc.update(
                    _trim_pad(batch["phones"][i],
                              int(batch["phone_length"][i])),
                    _trim_pad(phone_ids[i], int(phone_lens[i])))
                self.char_acc.update(
                    _trim_pad(batch["chars"][i],
                              int(batch["char_length"][i])),
                    _trim_pad(char_ids[i], int(char_lens[i])))
            if (step + 1) % self.log_every == 0:
                logger.info("eval step %d: %s", step + 1, self.result())
        return self.result()

    def result(self) -> dict:
        return _result(self.phone_acc, self.char_acc)


def _run_eval_step(eval_step: Callable, state, batch_iter,
                   max_batches: Optional[int], keys) -> dict:
    """The mean of each of ``keys`` over the eval step's batch metrics."""
    device = next(state.model.parameters()).device
    seen = {k: [] for k in keys}
    for step, batch in enumerate(batch_iter):
        if max_batches is not None and step >= max_batches:
            break
        m = eval_step(state, {k: torch.from_numpy(np.asarray(v)).to(device)
                              for k, v in batch.items()})
        for k in keys:
            seen[k].append(float(m[k]))
    return {k: float(np.mean(v)) for k, v in seen.items()}


class VADTester:
    """Frame accuracy and F1 of the voiced class, averaged over batches."""

    def __init__(self, eval_step: Callable, state):
        self.eval_step = eval_step
        self.state = state

    def run(self, batch_iter, max_batches: Optional[int] = None) -> dict:
        m = _run_eval_step(self.eval_step, self.state, batch_iter,
                           max_batches, ("vad_acc", "f1"))
        return {"acc": m["vad_acc"], "f1": m["f1"]}


class PuncTester:
    """Masked punctuation accuracy and loss, averaged over batches."""

    def __init__(self, eval_step: Callable, state):
        self.eval_step = eval_step
        self.state = state

    def run(self, batch_iter, max_batches: Optional[int] = None) -> dict:
        return _run_eval_step(self.eval_step, self.state, batch_iter,
                              max_batches, ("bd_acc", "bd_loss"))
