"""Time K1b (the log-mel kernel) on one CUDA card: its tiles, a given dense
mel matrix, and the paths it replaced:

    python3 -m tensorflowasr_tpu_torch.kernels.sweep_log_mel

At the serving shape (B = 128 x 7 s, 'same' and 'valid') and the train
shape (B = 128 x 8 s 'same') it checks K1b against its plain version and
prints its median and minimum time by CUDA events and replayed from a CUDA
graph, beside K1 + the plain dB and mel matmul (the path before K1b) and K1
alone. At the serving shape it also times a given dense [513, 80] matrix
(the trainable basis: K1, then the dense product kernel) and every tile of
K1's ladder. Prints the card's name and power limit first.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

SHAPES = (("serve", 128, 7 * 16000), ("train", 128, 8 * 16000))
PAIRS = ((32, 4), (16, 4), (8, 4), (4, 4))
REPS, INNER = 30, 10
# K1b against its plain version (tests/test_torch_kernels_cuda.py)
KERNEL_LOGMEL_TOL = dict(rtol=1e-4, atol=5e-4)


def main() -> int:
    from tensorflowasr_tpu_torch.kernels.timing import (
        card_line,
        cuda_times,
        graph_times,
    )
    from tensorflowasr_tpu_torch.ops import frontend as fe
    from tensorflowasr_tpu_torch.ops import power_spectrogram as k1

    card_line()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    def line(what, fn):
        events = cuda_times(fn, REPS, INNER)
        graph = graph_times(fn, REPS, INNER)
        print(f"{what}: events median {events['median']:.4f} min "
              f"{events['min']:.4f} ms; graph median {graph['median']:.4f} "
              f"min {graph['min']:.4f} ms", flush=True)

    for name, b, t in SHAPES:
        for padding in ("same", "valid") if name == "serve" else ("same",):
            cfg = fe.LogMelFrontendConfig(padding=padding)
            wav = torch.from_numpy((np.random.default_rng(t).standard_normal(
                (b, t)) * 0.1).astype(np.float32)).to(dev)
            want = fe.log_mel_spectrogram_reference(wav, cfg)
            mel = fe._device_mel(cfg, dev)
            tag = f"{name} {padding} B={b} T={t}"

            def fused():
                return fe.log_mel_spectrogram(wav, cfg)

            torch.testing.assert_close(fused(), want, **KERNEL_LOGMEL_TOL)
            line(f"{tag}: K1b", fused)
            line(f"{tag}: K1 + plain dB + mel matmul", lambda: torch.matmul(
                fe._to_db(fe.power_spectrogram(wav, cfg), cfg), mel))
            line(f"{tag}: K1 alone", lambda: fe.power_spectrogram(wav, cfg))
            if name != "serve":
                continue
            dense = mel + 1e-3
            dense_want = fe.log_mel_spectrogram_reference(wav, cfg, dense)
            torch.testing.assert_close(fe.log_mel_spectrogram(wav, cfg, dense),
                                       dense_want, **KERNEL_LOGMEL_TOL)
            line(f"{tag}: K1b with a given dense [513, 80] matrix",
                 lambda: fe.log_mel_spectrogram(wav, cfg, dense))
            ladder = k1.TILE_LADDER
            for pair in PAIRS:
                k1.TILE_LADDER = (pair,)     # the rule has this choice
                try:
                    torch.testing.assert_close(fused(), want,
                                               **KERNEL_LOGMEL_TOL)
                    graph = graph_times(fused, REPS, INNER)
                finally:
                    k1.TILE_LADDER = ladder
                print(f"{tag}: K1b tile {pair[0]:2d} frames, {pair[1] * 64} "
                      f"threads: graph median {graph['median']:.4f} min "
                      f"{graph['min']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
