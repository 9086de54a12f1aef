"""Observability: profiler traces, throughput and RTF counters.

Counterpart of ``tensorflowasr_tpu/utils/telemetry.py``:

- :func:`trace`: a context manager around ``torch.profiler`` writing a
  Chrome / Perfetto trace file into a directory;
- :class:`ThroughputMeter`: streaming audio-seconds/s, steps/s and
  examples/s over a sliding window;
- :class:`RTFMeter`: real-time-factor accounting for serving;
- :func:`start_profiler_server`: raises, PyTorch has no on-demand profiling
  endpoint.

The meters read the host clock; the device works asynchronously, so their
rates are steady-state rates only over a window of many steps (or calls
that fetch their results).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Deque, Iterator, Tuple


@contextlib.contextmanager
def trace(logdir: str) -> Iterator:
    """Capture a ``torch.profiler`` trace of the block (host operators, and
    the CUDA kernels and copies when a card is present) into ``logdir`` as
    a Chrome trace JSON file (open it in Perfetto or ``chrome://tracing``).
    Yields the profiler."""
    import torch
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
    audio_seconds)`` once per step."""

    def __init__(self, window: int = 100):
        self.window = window
        self._events: Deque[Tuple[float, int, float]] = deque()
        self.total_steps = 0
        self.total_examples = 0
        self.total_audio_seconds = 0.0
        self._t0 = time.perf_counter()

    def update(self, n_examples: int, audio_seconds: float) -> None:
        now = time.perf_counter()
        self._events.append((now, n_examples, audio_seconds))
        while len(self._events) > self.window:
            self._events.popleft()
        self.total_steps += 1
        self.total_examples += n_examples
        self.total_audio_seconds += audio_seconds

    def rates(self) -> dict:
        if len(self._events) < 2:
            return {"steps_per_s": 0.0, "examples_per_s": 0.0,
                    "audio_seconds_per_s": 0.0}
        dt = self._events[-1][0] - self._events[0][0]
        if dt <= 0:
            return {"steps_per_s": 0.0, "examples_per_s": 0.0,
                    "audio_seconds_per_s": 0.0}
        n = len(self._events) - 1
        ex = sum(e[1] for e in list(self._events)[1:])
        au = sum(e[2] for e in list(self._events)[1:])
        return {"steps_per_s": n / dt, "examples_per_s": ex / dt,
                "audio_seconds_per_s": au / dt}

    def summary(self) -> dict:
        wall = time.perf_counter() - self._t0
        out = self.rates()
        out.update(total_steps=self.total_steps,
                   total_examples=self.total_examples,
                   total_audio_seconds=self.total_audio_seconds,
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
