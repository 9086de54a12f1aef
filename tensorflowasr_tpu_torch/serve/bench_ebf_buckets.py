"""Time E-Branchformer (L)'s predict step at the batch-decode buckets on one
CUDA card:

    python3 -m tensorflowasr_tpu_torch.serve.bench_ebf_buckets

The model and batches are ``testing.py``'s: ``configs/am_data.yml`` +
``configs/ebranchformerL.yml`` of this checkout (dmodel 512, 17 blocks of 8
x 64 heads) in bf16 with seeded random weights, 231 phone and 9161 char
classes; a batch is B = 32 rows of noise at one bucket (8 / 12 / 16 / 20 s,
T' = 200 / 300 / 400 / 500 encoder frames), each row's frame length drawn
from the bucket's last 4 s, the first row whole. For each bucket it prints
the host-clock time of ``predict_step`` with its ids fetched (median and
minimum of 25, after 3 warm), after the card's name and power limit. Of the
program it calls only ``build_model``, ``offline_config`` and
``predict_step``, so a copy times another checkout that has ``testing.py``
the same way.
"""

from __future__ import annotations

import statistics
import sys
import time

from tensorflowasr_tpu_torch.kernels.timing import card_line
from tensorflowasr_tpu_torch.testing import (
    EBF_BUCKETS,
    FRAME_SAMPLES,
    SR,
    ebf_batch,
    ebf_decode,
    ebranchformer_l,
)

WARM, REPS = 3, 25


def main() -> int:
    card_line()
    m = ebranchformer_l()
    for seconds in EBF_BUCKETS:
        wav, lengths = ebf_batch(seconds, seed=seconds)
        for _ in range(WARM):
            ebf_decode(m, wav, lengths)
        ms = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            ebf_decode(m, wav, lengths)
            ms.append(1e3 * (time.perf_counter() - t0))
        print(f"{seconds} s (T' = {seconds * SR // FRAME_SAMPLES}): median "
              f"{statistics.median(ms):.2f} min {min(ms):.2f} ms a batch",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
