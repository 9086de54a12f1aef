"""Profile the full-width train step on one CUDA card.

    python3 -m tensorflowasr_tpu_torch.train.profile_step \
        [--model offline|chunk] [--dtype bfloat16|float32]

``--model offline`` (the default) builds ``CTCTrainer`` from
``configs/am_data.yml`` + ``configs/conformerS.yml`` with seeded weights on
the training benchmark's batch (``train/bench_batch.py``: B = 128 x 8 s of
noise, 64 phones, 32 chars); ``--model chunk`` builds ``ChunkTrainer`` from
``configs/chunk_conformerS.yml`` on the chunk training benchmark's batch
(``train/bench_chunk_batch.py``: B = 128 x 8 s of gated tones, 64 + 64
phones, 32 + 32 chars, the picker calibrated). Takes warm steps, then traces
``--steps`` steps enqueued back to back with ``torch.profiler`` and prints
``utils/profiling.py::trace``'s summary (wall and device time a step,
device-busy share, kernels a step, the top kernels) after the card's name
and power limit. Raises without CUDA, and if the trace holds no device time.
"""

from __future__ import annotations

import argparse
import sys

from tensorflowasr_tpu_torch.train.bench_batch import (
    TRAIN_B,
    TRAIN_SECONDS,
    new_trainer,
    train_batch,
)
from tensorflowasr_tpu_torch.train.bench_chunk_batch import (
    chunk_train_batch,
    new_chunk_trainer,
)
from tensorflowasr_tpu_torch.utils.profiling import card_line, trace


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", default="offline",
                        choices=["offline", "chunk"])
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--top", type=int, default=25)
    args = parser.parse_args(argv)
    card_line()

    if args.model == "chunk":
        trainer = new_chunk_trainer(args.dtype, "cuda")
        batch = trainer._prepare_batch(chunk_train_batch())
    else:
        trainer = new_trainer(args.dtype, "cuda")
        batch = trainer._prepare_batch(train_batch())
    state = trainer.state
    for _ in range(3):
        trainer.train_step(state, batch)

    def run():
        for _ in range(args.steps):
            trainer.train_step(state, batch)

    trace(run, args.steps, f"{args.model} train_step {args.dtype} "
          f"B={TRAIN_B} x {TRAIN_SECONDS} s, back to back", "step", args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
