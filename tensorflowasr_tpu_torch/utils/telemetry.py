"""Observability: the program's recorder, profiler traces, throughput and
RTF counters.

Counterpart of ``tensorflowasr_tpu/utils/telemetry.py``, extended by a
recorder of the port's own:

- :func:`span` (a context manager), :func:`count`, :func:`between` and
  :func:`summary`: named host-clock spans and counters recorded inside the
  program (the stream pool's dispatch phases, the train step's phases, the
  Conformer's stages, the file engine's encodes and their pieces), each
  name kept in a preallocated ring of its newest ``RING`` records. ``fit``
  writes :func:`summary` of each log interval under ``telemetry`` in
  ``metrics.jsonl``;
- :func:`trace`: a context manager around ``torch.profiler`` writing a
  Chrome / Perfetto trace file into a directory; while a profiler records,
  each span also opens a ``record_function`` range, so the trace shows the
  program's phases on the kernels' timeline;
- :class:`ThroughputMeter`: streaming audio-seconds/s (padded and
  unpadded), steps/s and examples/s over a sliding window;
- :class:`RTFMeter`: real-time-factor accounting for serving;
- :func:`start_profiler_server`: raises, PyTorch has no on-demand profiling
  endpoint.

The recorder and the meters read the host clock (``time.perf_counter``);
the device works asynchronously, so a span around work that does not wait
for the device times its enqueue, and the meters' rates are steady-state
rates only over a window of many steps (or calls that fetch their
results).
"""

from __future__ import annotations

import array
import contextlib
import os
import threading
import time
from collections import deque
from typing import Deque, Dict, Iterator, Tuple

import numpy as np
import torch

RING = 65536            # records kept a name; the oldest are overwritten
_MASK = RING - 1
_clock = time.perf_counter
_profiling = torch._C._autograd._profiler_enabled
_record_function = torch.profiler.record_function


class _Ring:
    """One name's records: (start, end) of a span or (at, value) of a
    counter, as float64 pairs in a preallocated ring. A record stores two
    floats and keeps no Python object. Rings written from more than one
    thread take a lock."""

    __slots__ = ("buf", "n", "lock", "kind", "mirror")

    def __init__(self, kind: str, mirror: str, shared: bool):
        self.buf = array.array("d", bytes(16 * RING))
        self.n = 0
        self.lock = threading.Lock() if shared else None
        self.kind = kind
        self.mirror = mirror

    def put(self, a: float, b: float) -> None:
        lock = self.lock
        if lock is not None:
            lock.acquire()
        i = (self.n & _MASK) << 1
        self.buf[i] = a
        self.buf[i + 1] = b
        self.n += 1
        if lock is not None:
            lock.release()

    def records(self) -> np.ndarray:
        """The kept records [n, 2], oldest first (a copy)."""
        pairs = np.frombuffer(self.buf, np.float64).reshape(RING, 2)
        n = self.n
        if n <= RING:
            return pairs[:n].copy()
        return np.roll(pairs, -(n & _MASK), axis=0)


class _Span:
    """``with``-block of one span: two clock reads and one ring record; a
    ``record_function`` range around it only while a profiler records."""

    __slots__ = ("ring", "mirror", "t0", "rf")

    def __init__(self, ring: _Ring, mirror: str):
        self.ring = ring
        self.mirror = mirror
        self.rf = None

    def __enter__(self):
        if _profiling():
            self.rf = _record_function(self.mirror)
            self.rf.__enter__()
        self.t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.ring.put(self.t0, _clock())
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        return False


class Recorder:
    """Named spans and counters, a ring of ``RING`` records a name.

    A span's trace range is named ``tasr::<name>`` for a leaf model stage
    (``leaf=True``: a range that holds no other ``tasr::`` range or op, so
    a trace's reduction can credit it with the device time of the kernels
    launched inside it, as it does the ``tasr::`` custom ops) and
    ``tasr.<name>`` for every other span. ``linked=False`` names a leaf
    stage's range ``tasr.<name>`` too, for a region whose kernels a trace
    does not link to the ops inside it (a replayed CUDA graph links only a
    few), so that no reduction credits it with part of its device time.
    ``shared=True`` marks a name that more than one thread may write (a
    model's stages, a served engine); it takes a lock. A name is a span or
    a counter, fixed by its first use."""

    def __init__(self):
        self._rings: Dict[str, _Ring] = {}

    def _ring(self, name: str, kind: str, leaf: bool, shared: bool
              ) -> _Ring:
        ring = self._rings.get(name)
        if ring is None:
            mirror = ("tasr::" if leaf else "tasr.") + name
            ring = self._rings.setdefault(name, _Ring(kind, mirror, shared))
        return ring

    def span(self, name: str, leaf: bool = False, shared: bool = False,
             linked: bool = True) -> _Span:
        ring = self._ring(name, "span", leaf, shared)
        return _Span(ring, ring.mirror if linked else "tasr." + name)

    def count(self, name: str, value: float, shared: bool = False) -> None:
        """Record ``value`` under the counter ``name``; ``shared`` as for
        :meth:`span`."""
        self._ring(name, "count", False, shared).put(_clock(), value)

    def between(self, name: str, lo: float = -np.inf, hi: float = np.inf
                ) -> np.ndarray:
        """[n, 2] float64 of the name's kept records that started (a span)
        or were counted in ``[lo, hi)``, by start; empty for an unknown
        name."""
        ring = self._rings.get(name)
        if ring is None:
            return np.zeros((0, 2))
        rec = ring.records()
        rec = rec[(rec[:, 0] >= lo) & (rec[:, 0] < hi)]
        return rec[np.argsort(rec[:, 0], kind="stable")]

    def summary(self, lo: float = -np.inf, hi: float = np.inf) -> dict:
        """Each name with records in ``[lo, hi)``: a span's count, median
        and p95 in ms; a counter's count and sum."""
        out = {}
        for name in sorted(self._rings):
            rec = self.between(name, lo, hi)
            if not len(rec):
                continue
            if self._rings[name].kind == "span":
                ms = 1e3 * (rec[:, 1] - rec[:, 0])
                out[name] = {"count": len(rec),
                             "median_ms": float(np.median(ms)),
                             "p95_ms": float(np.percentile(ms, 95))}
            else:
                out[name] = {"count": len(rec),
                             "sum": float(rec[:, 1].sum())}
        return out

    def reset(self) -> None:
        self._rings.clear()


RECORDER = Recorder()       # the process's recorder, read by the functions
span = RECORDER.span
count = RECORDER.count
between = RECORDER.between
summary = RECORDER.summary
reset = RECORDER.reset


@contextlib.contextmanager
def trace(logdir: str) -> Iterator:
    """Capture a ``torch.profiler`` trace of the block (host operators, and
    the CUDA kernels and copies when a card is present) into ``logdir`` as
    a Chrome trace JSON file (open it in Perfetto or ``chrome://tracing``).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def start_profiler_server(port: int = 9999) -> None:
    """Not available: ``jax.profiler.start_server`` opens an endpoint that
    TensorBoard connects to and captures on demand from a running process;
    PyTorch has no such server (``torch.profiler`` records only between
    ``start`` and ``stop`` in the process itself). Use :func:`trace`."""
    raise NotImplementedError(
        "start_profiler_server: PyTorch has no on-demand profiler server "
        f"(port {port}); wrap the code to profile in "
        "utils.telemetry.trace(logdir) instead")


class ThroughputMeter:
    """Sliding-window throughput: call ``update(n_examples,
    audio_seconds, unpadded_seconds)`` once per step, with the batch's
    padded audio and, where known, its audio without the padding."""

    def __init__(self, window: int = 100):
        self.window = window
        self._events: Deque[Tuple[float, int, float, float]] = deque()
        self.total_steps = 0
        self.total_examples = 0
        self.total_audio_seconds = 0.0
        self.total_unpadded_seconds = 0.0
        self._t0 = time.perf_counter()

    def update(self, n_examples: int, audio_seconds: float,
               unpadded_seconds: float = 0.0) -> None:
        now = time.perf_counter()
        self._events.append((now, n_examples, audio_seconds,
                             unpadded_seconds))
        while len(self._events) > self.window:
            self._events.popleft()
        self.total_steps += 1
        self.total_examples += n_examples
        self.total_audio_seconds += audio_seconds
        self.total_unpadded_seconds += unpadded_seconds

    def rates(self) -> dict:
        keys = ("steps_per_s", "examples_per_s", "audio_seconds_per_s",
                "audio_seconds_unpadded_per_s")
        dt = (self._events[-1][0] - self._events[0][0]
              if len(self._events) >= 2 else 0.0)
        if dt <= 0:
            return dict.fromkeys(keys, 0.0)
        later = list(self._events)[1:]
        sums = [len(later)] + [sum(e[k] for e in later) for k in (1, 2, 3)]
        return {k: v / dt for k, v in zip(keys, sums)}

    def summary(self) -> dict:
        wall = time.perf_counter() - self._t0
        out = self.rates()
        out.update(total_steps=self.total_steps,
                   total_examples=self.total_examples,
                   total_audio_seconds=self.total_audio_seconds,
                   total_unpadded_seconds=self.total_unpadded_seconds,
                   wall_s=wall)
        return out


class RTFMeter:
    """Per-stream real-time factor: ``add(compute_seconds,
    audio_seconds)`` per inference call."""

    def __init__(self):
        self.compute_s = 0.0
        self.audio_s = 0.0
        self.calls = 0

    def add(self, compute_seconds: float, audio_seconds: float) -> None:
        self.compute_s += compute_seconds
        self.audio_s += audio_seconds
        self.calls += 1

    @property
    def rtf(self) -> float:
        return self.compute_s / max(self.audio_s, 1e-9)

    def result(self) -> dict:
        return {"rtf": self.rtf, "compute_s": self.compute_s,
                "audio_s": self.audio_s, "calls": self.calls}
