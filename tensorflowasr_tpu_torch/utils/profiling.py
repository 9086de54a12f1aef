"""The card line and the trace summary of the port's profiling scripts
(``train/profile_step.py``, ``serve/profile_chunk.py``; the K1 sweep prints
the card line too), kept in one place so that their device-busy shares are
reckoned alike."""

from __future__ import annotations

import subprocess
import time
from typing import Callable

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


def trace(run: Callable[[], None], n: int, what: str, unit: str,
          top: int) -> dict:
    """Runs ``run`` (``n`` steps enqueued back to back) once as it is, then
    once under ``torch.profiler``, and prints the wall time a step of each
    run, the device time a step (the summed device time of all kernels and
    copies in the trace), the device-busy share of each run's wall time (the
    rest is the card waiting for the host), the kernels and copies a step,
    the wall time a kernel or copy, and the ``top`` kernels by device time.
    Returns the kernels and copies, the device ms and the wall ms (without
    the profiler) a step. Raises if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side events only, without the profiler's own annotation spans
    # (such as "Optimizer.step#Adam.step"), which cover the kernels in them
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms <= 0:
        raise RuntimeError("the trace holds no device time")
    launches = sum(e.count for e in kernels)
    print(f"{what}, {n} {unit}s: {launches / n:.0f} kernels and copies and "
          f"{device_ms / n:.3f} ms of device time a {unit}; without the "
          f"profiler {bare_ms / n:.3f} ms a {unit} by the host clock, device "
          f"busy {100 * device_ms / bare_ms:.1f} %, "
          f"{bare_ms / launches * 1e3:.1f} us a kernel or copy; under it "
          f"{wall_ms / n:.3f} ms, {100 * device_ms / wall_ms:.1f} %, "
          f"{wall_ms / launches * 1e3:.1f} us")
    print(f"{'device ms/' + unit:>14} {'share':>7} {'calls/' + unit:>10}  "
          f"kernel")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        ms = e.self_device_time_total / 1e3 / n
        print(f"{ms:14.3f} {100 * ms * n / device_ms:6.1f}% "
              f"{e.count / n:10.1f}  {e.key[:110]}")
    return {"launches": launches / n, "device_ms": device_ms / n,
            "wall_ms": bare_ms / n}
