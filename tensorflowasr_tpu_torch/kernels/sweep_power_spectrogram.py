"""Time K1 (the power-spectrogram kernel) under each tile of its ladder, on
one CUDA card, to settle ``ops/power_spectrogram.py::TILE_LADDER``:

    python3 -m tensorflowasr_tpu_torch.kernels.sweep_power_spectrogram

For the batched serving shape (B = 128 x 7 s, more than the L2 holds) and
the one-chunk request shape (B = 1 x 7680 samples, L2-resident) it forces
every (tile_frames, groups) pair in turn, checks the power against the plain
version, and prints the median and minimum time of launches replayed from a
CUDA graph, so that the host's enqueue rate does not hide a short kernel.
The rule's own choice is marked. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

SHAPES = (("same", 128, 7 * 16000), ("same", 1, 7680), ("valid", 16, 7680))
PAIRS = ((64, 4), (32, 4), (16, 4), (8, 4), (4, 4), (4, 2), (2, 2), (2, 1),
         (1, 1))
REPS, INNER = 30, 10


def main() -> int:
    from tensorflowasr_tpu_torch.kernels.timing import card_line, graph_times
    from tensorflowasr_tpu_torch.ops import frontend as fe
    from tensorflowasr_tpu_torch.ops import power_spectrogram as k1

    card_line()
    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    ladder = k1.TILE_LADDER
    for padding, b, t in SHAPES:
        cfg = fe.LogMelFrontendConfig(padding=padding)
        wav = torch.from_numpy((np.random.default_rng(t).standard_normal(
            (b, t)) * 0.1).astype(np.float32)).to(dev)
        want = fe.power_spectrogram_reference(wav, cfg)
        chosen = k1.launch_plan(b, t, cfg.hop, fe._left_pad(t, cfg), sm_count)
        for pair in PAIRS:
            k1.TILE_LADDER = (pair,)      # the rule has this one choice
            try:
                got = fe.power_spectrogram(wav, cfg)
                torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-3)
                times = graph_times(
                    lambda: fe.power_spectrogram(wav, cfg), REPS, INNER)
            finally:
                k1.TILE_LADDER = ladder
            mark = " <- the rule's choice" if pair == chosen[:2] else ""
            blocks = b * k1.num_frames(want.shape[1], pair[0])
            print(f"{padding} B={b} T={t}: tile {pair[0]:2d} frames, "
                  f"{pair[1] * 64:3d} threads, {blocks} "
                  f"blocks: median {times['median']:.4f} min "
                  f"{times['min']:.4f} ms{mark}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
