"""Shared trainer machinery: checkpointing + fit/eval loops.

Counterpart of ``tensorflowasr_tpu/train/base.py``: an interval-driven fit
loop with ``metrics.jsonl`` logging, throughput metering, full-state
checkpoints and a guarded eval pass. Subclasses provide ``state``,
``device``, ``outdir``, ``train_step`` / ``eval_step`` and the interval
attributes.

The loop never waits for the device between steps: the step counter lives
on the host, and the metrics (device scalars) are fetched only at log steps,
in one copy.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from tensorflowasr_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowasr_tpu_torch.utils.config import cfg_get
from tensorflowasr_tpu_torch.utils.telemetry import ThroughputMeter

logger = logging.getLogger(__name__)


def fetch_mean(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """Mean of each metric over a list of per-step dicts of device scalars,
    brought to the host in one copy (which waits for those steps)."""
    keys = list(metrics[0])
    table = torch.stack([torch.stack([m[k].detach().float() for k in keys])
                         for m in metrics])
    return dict(zip(keys, table.mean(dim=0).cpu().tolist()))


class TrainerBase:
    """Requires subclass attributes: state, device, outdir, train_step,
    eval_step, log_interval, save_interval, eval_interval, and a
    ``sample_rate`` for throughput accounting (0 disables it)."""

    sample_rate: int = 0
    _ckpt_mgr = None

    @property
    def checkpoint_manager(self) -> CheckpointManager:
        if self._ckpt_mgr is None:
            self._ckpt_mgr = CheckpointManager(
                os.path.join(self.outdir, "checkpoints"))
        return self._ckpt_mgr

    def save(self) -> None:
        self.checkpoint_manager.save(int(self.state.step), self.state)

    def restore(self) -> bool:
        return self.checkpoint_manager.restore_latest(self.state) is not None

    def _prepare_batch(self, batch) -> Dict[str, torch.Tensor]:
        """numpy batch -> tensors on the trainer's device. The length
        vectors the CTC losses read on the host also stay behind as
        ``*_host`` CPU tensors, so the step needs no copy back for them."""
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k.endswith("_length"):
                out[k + "_host"] = t
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def fit(self, train_iter: Iterator, eval_iter: Optional[Iterator] = None,
            total_steps: int = 1000, metrics_path: Optional[str] = None):
        if self.state is None:
            raise RuntimeError("call init_state first")
        os.makedirs(self.outdir, exist_ok=True)
        metrics_path = metrics_path or os.path.join(self.outdir,
                                                    "metrics.jsonl")
        t0 = time.time()
        accum = []
        meter = ThroughputMeter()
        step0 = int(self.state.step)
        with open(metrics_path, "a") as mf:
            for i in range(total_steps):
                batch = self._prepare_batch(next(train_iter))
                self.state, metrics = self.train_step(self.state, batch)
                if self.sample_rate and "wav" in batch:
                    b, t = batch["wav"].shape
                    meter.update(b, b * t / self.sample_rate)
                accum.append(metrics)
                step = step0 + i + 1
                if step % self.log_interval == 0:
                    m = fetch_mean(accum)
                    m.update(step=step, wall_s=time.time() - t0,
                             **meter.rates())
                    logger.info("train %s", m)
                    mf.write(json.dumps(m) + "\n")
                    mf.flush()
                    accum = []
                if eval_iter is not None and step % self.eval_interval == 0:
                    em = self.evaluate(eval_iter)
                    if em:
                        em.update(step=step, split="eval")
                        logger.info("eval %s", em)
                        mf.write(json.dumps(em) + "\n")
                        mf.flush()
                if step % self.save_interval == 0:
                    self.save()
        return self.state

    def evaluate(self, eval_iter, max_batches: int = 50) -> dict:
        out = []
        for i, batch in enumerate(eval_iter):
            if i >= max_batches:
                break
            out.append(self.eval_step(self.state,
                                      self._prepare_batch(batch)))
        if not out:
            logger.warning("evaluate: eval iterator yielded no batches")
            return {}
        return fetch_mean(out)


class GenericTrainer(TrainerBase):
    """Built train and eval steps and a train state, wired into the shared
    fit / eval / checkpoint loop (the VAD and punctuation CLIs use it). The
    trainer runs on the device the state's model lives on."""

    def __init__(self, state, train_step, eval_step, outdir: str,
                 running_config=None):
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.outdir = outdir or "."
        self.device = next(state.model.parameters()).device
        rc = running_config
        self.log_interval = cfg_get(rc, "log_interval_steps", 100)
        self.save_interval = cfg_get(rc, "save_interval_steps", 500)
        self.eval_interval = cfg_get(rc, "eval_interval_steps",
                                     self.log_interval)
