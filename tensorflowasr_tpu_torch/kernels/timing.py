"""CUDA-event timing of a callable on the card, for ``chip_smoke.py`` and
the kernel sweeps. Each returns the median, the minimum and the spread
(largest minus smallest sample) in ms."""

from __future__ import annotations

import statistics

import torch


def cuda_times(fn, reps: int, inner: int, warmup: int = 3) -> dict:
    """CUDA-event times of ``fn()`` in ms: ``reps`` samples, each the time
    of ``inner`` back-to-back calls over ``inner``. Returns the median, the
    minimum and the spread (largest minus smallest sample)."""
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return {"median": statistics.median(samples), "min": min(samples),
            "spread": max(samples) - min(samples), "reps": reps,
            "inner": inner}


def graph_times(fn, reps: int, inner: int) -> dict:
    """As :func:`cuda_times`, with the ``inner`` calls captured once in a CUDA
    graph and replayed: the device's own back-to-back time, free of the
    host's enqueue rate, for kernels of a few microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    stats = cuda_times(graph.replay, reps, 1)
    for key in ("median", "min", "spread"):
        stats[key] /= inner
    stats["inner"] = inner
    return stats
