"""Profile the chunk-streaming step on one CUDA card.

    python3 -m tensorflowasr_tpu_torch.serve.profile_chunk \\
        [--dtype float32|bfloat16] [--slots 1] [--steps 10] [--fused]

Builds ``serve/bench_chunk.py``'s full-width ChunkConformer(S) (with
``--fused``, the same weights with ``fused_decoder`` set: the decoder phase
as one pass a chunk instead of ``sub_length`` micro-steps), takes warm
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
    with_fused_decoder,
)
from tensorflowasr_tpu_torch.utils.profiling import card_line, trace


def profile(model, slots: int, steps: int = 10, top: int = 15) -> dict:
    """Trace ``steps`` chained ``batched_stream_step`` calls of ``model``
    over ``slots`` streams after 3 warm ones; returns ``trace``'s
    numbers."""
    wav = np.stack([tones(CHUNK_S * (steps + 3), seed=300 + i)
                    for i in range(slots)])
    chunks = torch.from_numpy(wav.reshape(slots, -1, CHUNK_SAMPLES)
                              .transpose(1, 0, 2).copy()).to(model.device)
    decoder = "fused" if model.cfg.fused_decoder else "sequential"
    with torch.no_grad():
        caches = model.init_multi_stream_caches(slots)
        for i in range(3):
            *_, caches = model.batched_stream_step(chunks[i], caches)

        def run():
            nonlocal caches
            for i in range(3, 3 + steps):
                *_, caches = model.batched_stream_step(chunks[i], caches)

        return trace(run, steps, f"batched_stream_step "
                     f"{model.cfg.dtype_str}, {decoder} decoder, over "
                     f"{slots} slot(s), chained", "chunk", top)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--slots", type=int, default=1)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--fused", action="store_true",
                        help="the fused decoder phase (fused_decoder: true)")
    args = parser.parse_args(argv)
    card_line()

    model = chunk_models("cuda")[0][args.dtype]
    if args.fused:
        model = with_fused_decoder(model)
    profile(model, args.slots, args.steps, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
