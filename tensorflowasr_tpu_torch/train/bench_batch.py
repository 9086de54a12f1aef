"""The training benchmark's batch and a trainer built from the shipped
configs, shared by ``chip_smoke.py`` and ``train/profile_step.py`` so both
time the same step.

The batch is the JAX package's ``bench.py`` training batch: B = 128 x 8 s of
0.1-scaled noise, 64 phones and 32 chars of full length, 231 phone and 9161
char classes, ``input_length`` 200.
"""

from __future__ import annotations

import os

import numpy as np

from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer
from tensorflowasr_tpu_torch.utils.config import UserConfig

SR = 16000
N_PHONE, N_CHAR = 231, 9161
TRAIN_B, TRAIN_SECONDS, TRAIN_PHONES, TRAIN_CHARS = 128, 8, 64, 32


def train_batch(b: int = TRAIN_B, seconds: float = TRAIN_SECONDS,
                n_phones: int = TRAIN_PHONES, n_chars: int = TRAIN_CHARS
                ) -> dict:
    """A seeded numpy batch: noise, full-length labels."""
    rng = np.random.default_rng(0)
    return {
        "wav": (rng.standard_normal((b, int(seconds * SR))) * 0.1).astype(
            np.float32),
        "input_length": np.full((b,), int(seconds * 100) // 4, np.int32),
        "phones": rng.integers(1, N_PHONE - 1, (b, n_phones)).astype(
            np.int32),
        "phone_length": np.full((b,), n_phones, np.int32),
        "chars": rng.integers(1, N_CHAR, (b, n_chars)).astype(np.int32),
    }


def shipped_config(extra=None) -> UserConfig:
    """``configs/am_data.yml`` + ``configs/conformerS.yml`` of this checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return UserConfig(os.path.join(root, "configs", "am_data.yml"),
                      os.path.join(root, "configs", "conformerS.yml"),
                      extra=extra)


def new_trainer(dtype: str, device: str, extra=None) -> CTCTrainer:
    """A full-width ``CTCTrainer`` with seeded weights (seed 0)."""
    trainer = CTCTrainer(shipped_config(extra), N_PHONE, N_CHAR,
                         blank_id=N_PHONE - 1, device=device,
                         compute_dtype=dtype)
    trainer.init_state(seed=0)
    return trainer
