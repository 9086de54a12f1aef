"""The card line and CUDA-event timing of a callable on the card, for the
kernel sweeps and ``serve/bench_ebf_buckets.py``. Each timer returns the
median, the minimum and the spread (largest minus smallest sample) in
ms."""

from __future__ import annotations

import statistics
import subprocess

import torch


def card_line() -> str:
    """Turns TF32 off and prints the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them. Raises without
    CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    return line


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
