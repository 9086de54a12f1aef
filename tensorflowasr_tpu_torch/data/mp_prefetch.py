"""Batch production in worker processes (host parallelism past the GIL).

Counterpart of ``tensorflowasr_tpu/data/mp_prefetch.py``. The thread pool
of :mod:`tensorflowasr_tpu_torch.data.prefetch` overlaps wav IO with device
work, but the Python-heavy parts of batch prep (pinyin, token mapping,
augmentation, packing) serialise on the GIL. Here N spawned worker
PROCESSES each own a full dataloader over a shard of the train list and
stream packed numpy batches through a bounded queue; the parent moves them
to the device.

Each worker:
- hides every CUDA device from itself before anything else
  (``CUDA_VISIBLE_DEVICES=""``: a child must never open a context on the
  card the parent trains on), and fails if CUDA was initialised in it all
  the same;
- builds its loader through a picklable ``factory(worker_id, num_workers)``
  (``functools.partial`` over the module-level stream functions of
  ``cli/common.py``) and iterates it forever, putting only numpy batches on
  the queue (a torch tensor there is refused);
- forwards its exception to the consumer instead of dying silently.

Each worker has its own bounded queue and the consumer takes from them in
turn, so the sequence of batches is a function of the workers' seeds and
shards alone: every rank of a data-parallel run that starts the same
workers sees the same batches in the same order.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as pyqueue
import sys
import traceback
from typing import Callable, Iterator

_ERR_KEY = "__mp_worker_error__"


def _check_host_batch(batch) -> None:
    """Raise if the worker put the card to use or made torch tensors."""
    torch = sys.modules.get("torch")
    if torch is None:
        return
    if torch.cuda.is_initialized():
        raise RuntimeError("a data worker initialised CUDA")
    values = batch.values() if isinstance(batch, dict) else (batch,)
    if any(isinstance(v, torch.Tensor) for v in values):
        raise TypeError("a data worker made torch tensors; batches cross "
                        "the queue as numpy arrays")


def _worker_main(factory, worker_id: int, num_workers: int, q, stop_evt):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        for batch in factory(worker_id, num_workers):
            _check_host_batch(batch)
            while not stop_evt.is_set():
                try:
                    q.put(batch, timeout=0.2)
                    break
                except pyqueue.Full:
                    continue
            if stop_evt.is_set():
                return
    except Exception:  # noqa: BLE001 - forwarded to the consumer
        try:
            q.put({_ERR_KEY: traceback.format_exc()}, timeout=5)
        except pyqueue.Full:
            pass


class MPBatchIterator:
    """Endless batch iterator backed by ``num_workers`` spawned processes.

    ``factory(worker_id, num_workers)`` must be picklable (a top-level
    function or a ``functools.partial`` over one) and return an iterator of
    numpy batches; each worker should shard its data by ``worker_id`` so
    that the union covers the corpus. ``close()`` stops and joins the
    workers.
    """

    def __init__(self, factory: Callable[[int, int], Iterator],
                 num_workers: int = 2, depth: int = 4):
        ctx = mp.get_context("spawn")
        n = max(1, num_workers)
        # ``depth`` batches in flight over all workers, each in its queue
        self._queues = [ctx.Queue(maxsize=max(1, depth // n))
                        for _ in range(n)]
        self._stop = ctx.Event()
        self._turn = 0
        self._procs = [
            ctx.Process(target=_worker_main,
                        args=(factory, i, num_workers, self._queues[i],
                              self._stop),
                        daemon=True)
            for i in range(n)]
        for p in self._procs:
            p.start()

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        i = self._turn
        while True:
            try:
                item = self._queues[i].get(timeout=0.5)
            except pyqueue.Empty:
                if not self._procs[i].is_alive():
                    raise RuntimeError(
                        f"data worker process {i} exited") from None
                continue
            if isinstance(item, dict) and _ERR_KEY in item:
                self.close()
                raise RuntimeError(f"data worker failed:\n{item[_ERR_KEY]}")
            self._turn = (i + 1) % len(self._queues)
            return item

    def close(self) -> None:
        self._stop.set()
        # drain, so that workers blocked on put() see the stop event
        for q in self._queues:
            try:
                while True:
                    q.get_nowait()
            except pyqueue.Empty:
                pass
        for p in self._procs:
            p.join(timeout=3)
            if p.is_alive():
                p.terminate()
                p.join(timeout=3)

    def __del__(self):  # noqa: D105
        try:
            self._stop.set()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
