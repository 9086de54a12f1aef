"""Shared trainer machinery: checkpointing + fit/eval loops.

Counterpart of ``tensorflowasr_tpu/train/base.py``: an interval-driven fit
loop with ``metrics.jsonl`` logging, throughput metering, full-state
checkpoints and a guarded eval pass. Subclasses provide ``state``,
``device``, ``outdir``, ``train_step`` / ``eval_step`` and the interval
attributes.

The loop never waits for the device between steps: the step counter lives
on the host, and the metrics (device scalars) are fetched only at log steps,
in one copy.

A ``metrics.jsonl`` line keeps the JAX package's keys and adds two: the
rate of audio without the padding, ``audio_seconds_unpadded_per_s`` (each
row's ``input_length`` encoder frames at ``frame_samples`` samples a frame,
so exact to one frame a row), and ``telemetry``, the recorder's summary
(``utils/telemetry.py::summary``: each span's count, median and p95 in ms,
each counter's count and sum) of what was recorded since the last log line.

Under data parallelism (a trainer's ``mesh``, ``parallel/mesh.py``) every
rank runs the same loader and keeps its rows of each batch; the metrics are
global, only global rank 0 writes ``metrics.jsonl`` and the checkpoints
(the format of one process, so any number of ranks, or one, restores
them), and every rank restores. Throughput counts the global batch.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from tensorflowasr_tpu_torch.models.layers import set_generator
from tensorflowasr_tpu_torch.parallel import mesh as mesh_lib
from tensorflowasr_tpu_torch.parallel.multihost import process_index
from tensorflowasr_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowasr_tpu_torch.train.state import ASRTrainState
from tensorflowasr_tpu_torch.utils import telemetry
from tensorflowasr_tpu_torch.utils.config import cfg_get

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
    ``sample_rate`` for throughput accounting (0 disables it) with the
    samples of an encoder frame, ``frame_samples``, for the unpadded audio
    (0 leaves it out). A data-parallel subclass calls :meth:`set_mesh` and
    builds its state with :meth:`new_state`."""

    sample_rate: int = 0
    frame_samples: int = 0
    _ckpt_mgr = None
    mesh = None        # a DeviceMesh whose data axes split the batch
    group = None       # the process group of those axes
    seed = 0

    def set_mesh(self, mesh) -> None:
        self.mesh = mesh
        self.group = mesh_lib.data_group(mesh)

    def new_state(self, model: torch.nn.Module, optimizer,
                  seed: int) -> ASRTrainState:
        """The train state of a freshly built ``model``: its weights
        broadcast from data rank 0, the data group handed to its BatchNorms
        and to the optimizer, and a generator for dropout and SpecAugment
        seeded with ``rank_seed(seed, data rank)``."""
        self.seed = seed
        generator = torch.Generator(device=self.device).manual_seed(
            mesh_lib.rank_seed(seed, mesh_lib.data_rank(self.mesh)))
        set_generator(model, generator)
        mesh_lib.set_data_group(model, self.group)
        optimizer.group = self.group
        return mesh_lib.replicate(ASRTrainState(model, optimizer, generator),
                                  self.mesh)

    @property
    def checkpoint_manager(self) -> CheckpointManager:
        if self._ckpt_mgr is None:
            self._ckpt_mgr = CheckpointManager(
                os.path.join(self.outdir, "checkpoints"))
        return self._ckpt_mgr

    def save(self) -> None:
        """Every rank takes part (the pending gradients of an accumulation
        are reduced); global rank 0 writes, and the others wait for it."""
        saved = self.state.state_dict()
        if process_index() == 0:
            self.checkpoint_manager.write(int(self.state.step), saved)
        if self.group is not None:
            dist.barrier()

    def restore(self) -> bool:
        """Every rank loads the newest checkpoint. Under data parallelism
        each then re-seeds its generator from (seed, its data rank, the
        step) rather than keep the saved one, which is rank 0's."""
        if self.checkpoint_manager.restore_latest(self.state) is None:
            return False
        if self.group is not None:
            self.state.generator.manual_seed(mesh_lib.rank_seed(
                self.seed, mesh_lib.data_rank(self.mesh), self.state.step))
        return True

    def _prepare_batch(self, batch) -> Dict[str, torch.Tensor]:
        """numpy batch -> this rank's rows as tensors on the trainer's
        device (every row in one process). The length vectors the CTC
        losses read on the host also stay behind as ``*_host`` CPU
        tensors, so the step needs no copy back for them."""
        return mesh_lib.shard_batch(batch, self.mesh, self.device)

    def fit(self, train_iter: Iterator, eval_iter: Optional[Iterator] = None,
            total_steps: int = 1000, metrics_path: Optional[str] = None):
        if self.state is None:
            raise RuntimeError("call init_state first")
        os.makedirs(self.outdir, exist_ok=True)
        metrics_path = metrics_path or os.path.join(self.outdir,
                                                    "metrics.jsonl")
        t0 = time.time()
        accum = []
        meter = telemetry.ThroughputMeter()
        step0 = int(self.state.step)
        writer = process_index() == 0
        mf = open(metrics_path, "a") if writer else None
        t_log = time.perf_counter()

        def record(m: dict) -> None:
            if mf is not None:
                mf.write(json.dumps(m) + "\n")
                mf.flush()

        try:
            for i in range(total_steps):
                host_batch = next(train_iter)
                batch = self._prepare_batch(host_batch)
                self.state, metrics = self.train_step(self.state, batch)
                if self.sample_rate and "wav" in host_batch:
                    # the global batch: every rank ran its rows of it
                    b, t = np.shape(host_batch["wav"])
                    frames = (np.sum(host_batch["input_length"])
                              if self.frame_samples else 0)
                    meter.update(b, b * t / self.sample_rate,
                                 float(frames) * self.frame_samples
                                 / self.sample_rate)
                accum.append(metrics)
                step = step0 + i + 1
                if step % self.log_interval == 0:
                    m = fetch_mean(accum)
                    now = time.perf_counter()
                    m.update(step=step, wall_s=time.time() - t0,
                             **meter.rates(),
                             telemetry=telemetry.summary(t_log, now))
                    t_log = now
                    logger.info("train %s", m)
                    record(m)
                    accum = []
                if eval_iter is not None and step % self.eval_interval == 0:
                    em = self.evaluate(eval_iter)
                    if em:
                        em.update(step=step, split="eval")
                        logger.info("eval %s", em)
                        record(em)
                if step % self.save_interval == 0:
                    self.save()
        finally:
            if mf is not None:
                mf.close()
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
