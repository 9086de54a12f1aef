"""Profile the full-width CTC train step on one CUDA card.

    python3 -m tensorflowasr_tpu_torch.train.profile_step [--dtype bfloat16]

Builds ``CTCTrainer`` from ``configs/am_data.yml`` + ``configs/conformerS.yml``
with seeded weights, takes warm steps on the training benchmark's batch
(B = 128 x 8 s of noise, 64 phones, 32 chars), then traces ``--steps`` steps
enqueued back to back with ``torch.profiler``. Prints the card's name and
power limit, the wall time a step, the device-busy share (the summed device
time of all kernels and copies over the traced wall time; the rest is the
card waiting for the host), the number of kernels a step, and the kernels
that take the most device time. Raises without CUDA, and if the trace holds
no device time.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from tensorflowasr_tpu_torch.train.bench_batch import (
    TRAIN_B,
    TRAIN_SECONDS,
    new_trainer,
    train_batch,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--top", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)

    trainer = new_trainer(args.dtype, "cuda")
    state = trainer.state
    batch = trainer._prepare_batch(train_batch())
    for _ in range(3):
        trainer.train_step(state, batch)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(state, batch)
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
    print(f"train_step {args.dtype} B={TRAIN_B} x {TRAIN_SECONDS} s, {args.steps} steps "
          f"back to back under the profiler: {wall_ms / args.steps:.3f} ms a "
          f"step by the host clock; device busy "
          f"{device_ms / args.steps:.3f} ms a step = "
          f"{100 * device_ms / wall_ms:.1f} % of the wall time; "
          f"{launches / args.steps:.0f} kernels and copies a step")
    print(f"{'device ms/step':>14} {'share':>7} {'calls/step':>10}  kernel")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:args.top]:
        ms = e.self_device_time_total / 1e3 / args.steps
        print(f"{ms:14.3f} {100 * ms * args.steps / device_ms:6.1f}% "
              f"{e.count / args.steps:10.1f}  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
