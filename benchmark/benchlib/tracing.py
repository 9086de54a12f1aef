"""The harness's spans around its calls into the program, the window clock
that switches the profiler on for a traced run's last seconds, and the
reduction of a ``torch.profiler`` trace to the numbers the per-layer
readers take.

The device-busy time is the union of the device operations' intervals
(kernels, copies, sets), without the profiler's annotation ranges, which
cover the kernels inside them: a copy of the port's
``utils/profiling.py::trace`` arithmetic, with intervals in place of a sum
so that overlapping operations count once.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

TRACE_SECONDS = 6.0      # a traced run profiles the window's last seconds
TOP = 10


class Spans:
    """Named host-clock intervals, each also a ``record_function`` range so
    that a trace can say what the host was doing."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.counts: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        with torch.profiler.record_function(f"bench.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans[name].append((t0, time.perf_counter()))

    def count(self, name: str, value: float = 1.0, at: Optional[float] = None
              ) -> None:
        self.counts[name].append((time.perf_counter() if at is None else at,
                                  float(value)))

    def between(self, name: str, lo: float, hi: float, counts: bool = False):
        src = self.counts if counts else self.spans
        return [s for s in src.get(name, ()) if lo <= s[0] < hi]


class Phases(dict):
    """Seconds of each named phase of a set-up, in order."""

    def __init__(self):
        super().__init__()
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self[name] = now - self.t
        self.t = now


class WindowClock:
    """The measured window: ``poll()`` from the runner's loop says whether
    the window is still open and, in a traced run, starts the profiler
    ``TRACE_SECONDS`` before the end."""

    def __init__(self, seconds: float, trace: bool, device: torch.device):
        self.seconds = float(seconds)
        self.trace = trace and device.type == "cuda"
        self.t0 = self.t_end = None
        self.trace_from = None
        self.trace_to = None
        self.prof = None

    def start(self) -> float:
        self.t0 = time.perf_counter()
        self.t_end = self.t0 + self.seconds
        return self.t0

    def poll(self) -> bool:
        now = time.perf_counter()
        if self.trace and self.prof is None and \
                now >= self.t_end - min(TRACE_SECONDS, self.seconds):
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.trace_from = time.perf_counter()
        return now < self.t_end

    def stop_trace(self) -> None:
        if self.prof is not None and self.trace_to is None:
            torch.cuda.synchronize()
            self.trace_to = time.perf_counter()
            self.prof.__exit__(None, None, None)


def summarize(prof) -> dict:
    """busy_s, the device operations a name (seconds), the device time under
    each ``tasr::`` op (its kernels and those of the ops inside it), and the
    longest idle gaps labelled by the innermost ``bench.*`` range open on
    the host when each began. Reads the profiler's raw events."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and not name.startswith(
                    ("Optimizer.", "bench.")):
                dev.append((e.start_ns(), e.end_ns(), name,
                            e.linked_correlation_id()))
        else:
            cpu.append((e.start_ns(), e.end_ns(), name, e.start_thread_id(),
                        e.correlation_id()))
    if not dev:
        raise RuntimeError("the trace holds no device operation")
    ivals = sorted((s, e) for s, e, _, _ in dev)
    busy, gaps = 0, []
    cur_s, cur_e = ivals[0]
    for s, e in ivals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name = defaultdict(float)
    for s, e, name, _ in dev:
        by_name[name] += (e - s) / 1e9
    # the device time under each tasr:: op: ops inside its range on its
    # thread, then the device operations linked to any of them
    ops = defaultdict(list)
    for s, e, name, t, _ in cpu:
        if name.startswith("tasr::"):
            ops[t].append((s, e, name))
    for lst in ops.values():
        lst.sort()
    under = {}
    for s, e, _, t, corr in cpu:
        lst = ops.get(t)
        if lst:
            i = bisect.bisect_right(lst, (s, float("inf"), "")) - 1
            if i >= 0 and lst[i][1] >= e:
                under[corr] = lst[i][2]
    op_device = defaultdict(float)
    for s, e, _, link in dev:
        if link in under:
            op_device[under[link]] += (e - s) / 1e9
    ranges = sorted((s, e, name[6:]) for s, e, name, _, _ in cpu
                    if name.startswith("bench."))

    def label(t: int) -> str:
        best = "host"
        for s, e, name in ranges:
            if s > t:
                break
            if e >= t:
                best = name
        return best

    gaps.sort(key=lambda g: -(g[1] - g[0]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": busy / 1e9,
        "launches": len(dev),
        "op_device_s": dict(op_device),
        "device_ops": [[name, secs] for name, secs in top],
        "idle_gaps": [[label(s), (e - s) / 1e9] for s, e in gaps[:TOP]],
    }
