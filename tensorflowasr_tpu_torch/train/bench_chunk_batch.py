"""The chunk (SMLTA2) training benchmark's batch and trainer, shared by
``chip_smoke.py`` and ``train/profile_step.py --model chunk`` so both time
the same step.

The batch has the offline training batch's size (``train/bench_batch.py``,
the JAX package's ``bench.py:333-349``): B = 128 x 8 s, 64 phones and 32
chars of full length, 231 phone and 9161 char classes, and for the
text-only branch 64 extra phones and 32 extra chars; ``input_length`` 200
(50 chunks of 4 encoder frames). The wav is ``serve/bench_chunk.py``'s gated
tones, not noise: the trainer's model is ChunkConformer(S) from
``configs/am_data.yml`` + ``configs/chunk_conformerS.yml`` at full width
with seeded weights, calibrated as the serving benchmark's (first conv
x10, the picker's blank bias at the median margin, here in training mode on
rows of the batch), so that it picks about half of the frames at the
first step. A random picker keeps every frame or none, and ``t_ref``
would then be the whole width or the label width.
"""

from __future__ import annotations

import numpy as np

from tensorflowasr_tpu_torch.serve.bench_chunk import (
    calibrate,
    chunk_config,
    shipped_chunk_config,
    tones,
)
from tensorflowasr_tpu_torch.train.bench_batch import (
    N_CHAR,
    N_PHONE,
    SR,
    TRAIN_B,
    TRAIN_CHARS,
    TRAIN_PHONES,
    TRAIN_SECONDS,
)
from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer

EXTRA_PHONES, EXTRA_CHARS = 64, 32
CALIBRATION_ROWS = 8


def bench_wav(b: int, seconds: float) -> np.ndarray:
    """[b, seconds * SR] of gated tones, row i seeded with 1000 + i."""
    return np.stack([tones(seconds, seed=1000 + i) for i in range(b)])


def chunk_train_batch(b: int = TRAIN_B, seconds: float = TRAIN_SECONDS,
                      n_phones: int = TRAIN_PHONES,
                      n_chars: int = TRAIN_CHARS,
                      n_extra_phones: int = EXTRA_PHONES,
                      n_extra_chars: int = EXTRA_CHARS) -> dict:
    """A seeded numpy batch: gated tones, full-length labels. ``seconds``
    must be whole 0.16 s chunks."""
    n = int(round(seconds * SR))
    if n % 2560:
        raise ValueError(f"{seconds} s is not whole 0.16 s chunks")
    rng = np.random.default_rng(0)

    def ids(width, top):
        return rng.integers(1, top, (b, width)).astype(np.int32)

    def full(width):
        return np.full((b,), width, np.int32)

    return {
        "wav": bench_wav(b, seconds),
        "input_length": full(n // 640),
        "phones": ids(n_phones, N_PHONE - 1), "phone_length": full(n_phones),
        "chars": ids(n_chars, N_CHAR - 1), "char_length": full(n_chars),
        "extra_phones": ids(n_extra_phones, N_PHONE - 1),
        "extra_phone_length": full(n_extra_phones),
        "extra_chars": ids(n_extra_chars, N_CHAR - 1),
        "extra_char_length": full(n_extra_chars),
    }


def new_chunk_trainer(dtype: str, device: str) -> ChunkTrainer:
    """A full-width ``ChunkTrainer`` with seeded weights (seed 0) and the
    serving benchmark's calibration, taken in training mode on the first
    ``CALIBRATION_ROWS`` rows of the benchmark batch (BatchNorm's batch
    statistics set the margins, so the calibration set matches the batch
    the model trains on)."""
    trainer = ChunkTrainer(shipped_chunk_config(), N_PHONE, N_CHAR,
                           device=device, compute_dtype=dtype)
    if trainer.model_cfg != chunk_config(dtype):
        raise ValueError(f"not the full-width chunk config: "
                         f"{trainer.model_cfg}")
    trainer.init_state(seed=0)
    calibrate(trainer.state.model, training=True,
              wav=bench_wav(CALIBRATION_ROWS, TRAIN_SECONDS))
    return trainer
