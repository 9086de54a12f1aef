"""Throughput accounting for the training loop.

Counterpart of ``ThroughputMeter`` in ``tensorflowasr_tpu/utils/telemetry.py``:
streaming audio-seconds/s, steps/s and examples/s over a sliding window.
The meter reads the host clock at each ``update``; the device works
asynchronously, so the rates are steady-state rates only over a window of
many steps.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Tuple


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
