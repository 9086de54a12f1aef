"""E-Branchformer (L)'s predict step at the batch-decode buckets, shared by
``chip_smoke.py`` and run alone to time a checkout's predict step by bucket:

    python3 -m tensorflowasr_tpu_torch.serve.bench_ebf_buckets

The model is ``configs/am_data.yml`` + ``configs/ebranchformerL.yml`` of
this checkout (dmodel 512, 17 blocks of 8 x 64 heads) in bf16 with seeded
random weights, 231 phone and 9161 char classes. A batch is B = 32 rows of
noise at one bucket (8 / 12 / 16 / 20 s, T' = 200 / 300 / 400 / 500 encoder
frames), each row's frame length drawn from the bucket's last 4 s, the
first row whole, as the decode cell's segments fill their buckets. For each
bucket it prints the host-clock time of ``predict_step`` with its ids
fetched (median and minimum of 25, after 3 warm), after the card's name and
power limit. It uses only ``build_model``, ``offline_config`` and
``predict_step``, so a copy times an older checkout with the E-Branchformer
the same way.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

import numpy as np
import torch

from tensorflowasr_tpu_torch.models.conformer import build_model
from tensorflowasr_tpu_torch.models.ebranchformer import offline_config
from tensorflowasr_tpu_torch.serve.engines import predict_step
from tensorflowasr_tpu_torch.train.bench_batch import N_CHAR, N_PHONE, SR
from tensorflowasr_tpu_torch.utils.config import UserConfig

B = 32
BUCKETS = (8, 12, 16, 20)                # seconds
FRAME_SAMPLES = 640                      # a 40 ms encoder frame
WARM, REPS = 3, 25


def model(dtype: str = "bfloat16", device: str = "cuda"):
    """The shipped E-Branchformer (L) of this checkout in eval mode."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg = offline_config(UserConfig(
        os.path.join(root, "configs", "am_data.yml"),
        os.path.join(root, "configs", "ebranchformerL.yml")), dtype)
    return build_model(cfg, N_PHONE, N_CHAR, device=device, seed=0)


def batch(seconds: int, seed: int, device: str = "cuda"):
    """(wav [B, seconds x SR] f32, frame lengths [B] int32) of one bucket."""
    rng = np.random.default_rng(seed)
    n = seconds * SR
    wav = (0.1 * rng.standard_normal((B, n))).astype(np.float32)
    dur = rng.uniform(seconds - 4, seconds, B)
    dur[0] = seconds
    lengths = (dur * SR // FRAME_SAMPLES).astype(np.int32)
    return (torch.from_numpy(wav).to(device),
            torch.from_numpy(lengths).to(device))


def decode(m, wav, lengths) -> list:
    """One predict step with its ids fetched to the host."""
    return [x.cpu() for x in predict_step(m, wav, lengths)]


def main() -> int:
    from tensorflowasr_tpu_torch.utils.profiling import card_line

    card_line()
    m = model()
    for seconds in BUCKETS:
        wav, lengths = batch(seconds, seed=seconds)
        for _ in range(WARM):
            decode(m, wav, lengths)
        ms = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            decode(m, wav, lengths)
            ms.append(1e3 * (time.perf_counter() - t0))
        print(f"{seconds} s (T' = {seconds * SR // FRAME_SAMPLES}): median "
              f"{statistics.median(ms):.2f} min {min(ms):.2f} ms a batch",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
