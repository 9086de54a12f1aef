"""Profile the chunk-streaming step on one CUDA card.

    python3 -m tensorflowasr_tpu_torch.serve.profile_chunk \\
        [--dtype float32|bfloat16] [--slots 1] [--steps 10]

Builds ``serve/bench_chunk.py``'s full-width ChunkConformer(S), takes warm
steps of ``batched_stream_step`` over ``--slots`` streams (1 is the one
stream of ``ChunkStreamSession``, 256 the pool of
``MultiStreamChunkServer``), then traces ``--steps`` steps chained on their
caches with ``torch.profiler`` and prints ``utils/profiling.py::trace``'s
summary (wall and device time a chunk, device-busy share, kernels a chunk,
the top kernels) after the card's name and power limit. Raises without
CUDA, and if the trace holds no device time.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tensorflowasr_tpu_torch.serve.bench_chunk import (
    CHUNK_S,
    CHUNK_SAMPLES,
    chunk_models,
    tones,
)
from tensorflowasr_tpu_torch.utils.profiling import card_line, trace


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--slots", type=int, default=1)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--top", type=int, default=15)
    args = parser.parse_args(argv)
    card_line()

    model = chunk_models("cuda")[0][args.dtype]
    wav = np.stack([tones(CHUNK_S * (args.steps + 3), seed=300 + i)
                    for i in range(args.slots)])
    chunks = torch.from_numpy(wav.reshape(args.slots, -1, CHUNK_SAMPLES)
                              .transpose(1, 0, 2).copy()).cuda()
    with torch.no_grad():
        caches = model.init_multi_stream_caches(args.slots)
        for i in range(3):
            *_, caches = model.batched_stream_step(chunks[i], caches)

        def run():
            nonlocal caches
            for i in range(3, 3 + args.steps):
                *_, caches = model.batched_stream_step(chunks[i], caches)

        trace(run, args.steps, f"batched_stream_step {args.dtype} over "
              f"{args.slots} slot(s), chained", "chunk", args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
