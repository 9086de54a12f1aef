"""The chunk-serving benchmark's model and signals, shared by
``chip_smoke.py`` and ``serve/profile_chunk.py`` so both measure the same
steps.

The model is ChunkConformer(S) from ``configs/am_data.yml`` +
``configs/chunk_conformerS.yml`` at full width (dmodel 144, 15 encoder
blocks, 1 picker, 2 helper and 1 decoder block with win_back 8, 4 x 36
heads, kernel 32), 231 phone and 9161 char classes as ``bench.py:149``,
seeded random weights with two changes that make it pick like a trained
model: the 'valid' log-mel is not normalized and spans about 0.1, so the
first conv's weights gain 10x (else every frame looks alike to the
encoder); and a random picker keeps every frame or none, so the blank bias
moves by the median margin of the blank logit over the other classes on
warm-up signals, after which about half the frames are picked and the
decoder micro-steps run on real rows.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tensorflowasr_tpu_torch.models.chunk_conformer import (
    ChunkConformer,
    ChunkConformerConfig,
    build_chunk_model,
)
from tensorflowasr_tpu_torch.models.layers import BatchNorm
from tensorflowasr_tpu_torch.train.bench_batch import N_CHAR, N_PHONE, SR
from tensorflowasr_tpu_torch.utils.config import UserConfig

CHUNK_SAMPLES = 2560                 # one 160 ms chunk
CHUNK_S = CHUNK_SAMPLES / SR
FULL_WIDTH = dict(dmodel=144, encoder_blocks=15, picker_blocks=1,
                  helper_blocks=2, decoder_blocks=1, decoder_win_back=8,
                  win_front=36, chunk_samples=CHUNK_SAMPLES)


def tones(seconds: float, seed: int) -> np.ndarray:
    """50 ms segments of two random tones at one of three loudness levels:
    frames that a random-weight model tells apart."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    wav = np.zeros(n)
    for s in range(0, n, 800):
        f = rng.uniform(100, 6000, 2)
        wav[s:s + 800] = (np.sin(2 * np.pi * f[0] * t[s:s + 800])
                          + np.sin(2 * np.pi * f[1] * t[s:s + 800])) \
            * rng.choice([0.001, 0.05, 1.0])
    return (0.3 * wav).astype(np.float32)


def shipped_chunk_config() -> UserConfig:
    """``configs/am_data.yml`` + ``configs/chunk_conformerS.yml`` of this
    checkout."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return UserConfig(os.path.join(root, "configs", "am_data.yml"),
                      os.path.join(root, "configs", "chunk_conformerS.yml"))


def chunk_config(dtype: str) -> ChunkConformerConfig:
    """The shipped chunk config of this checkout; raises unless it has the
    full width."""
    cfg = ChunkConformerConfig.from_user_config(shipped_chunk_config(),
                                                dtype)
    got = dict(dmodel=cfg.dmodel, encoder_blocks=cfg.encoder.num_blocks,
               picker_blocks=cfg.picker.num_blocks,
               helper_blocks=cfg.helper.num_blocks,
               decoder_blocks=cfg.decoder.num_blocks,
               decoder_win_back=cfg.decoder.win_back,
               win_front=cfg.encoder.win_front,
               chunk_samples=cfg.chunk_samples)
    if got != FULL_WIDTH:
        raise ValueError(f"not the full-width chunk config: {got}")
    return cfg


@torch.no_grad()
def calibrate(model: ChunkConformer, training: bool = False,
              wav: Optional[np.ndarray] = None) -> float:
    """Gain the first conv 10x and move the picker's blank bias by the
    median margin of the blank logit over the other classes on ``wav``
    (4 x 4 s of warm-up signals by default). The margin is taken in eval
    mode, or with ``training`` in training mode (BatchNorm on the batch's
    statistics, its running statistics left alone), the mode the model is
    then used in. Returns the bias's move."""
    mode = model.training
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    model.train(training)
    for m in norms:
        m.track_stats = False
    blank = model.phone_blank
    if wav is None:
        wav = np.stack([tones(4.0, seed=60 + i) for i in range(4)])
    warm = torch.from_numpy(wav).to(model.device)
    model.front.conv_subsampling.conv1.weight.mul_(10.0)
    logits, _ = model.encode_to_phones(warm)
    margin = (logits[..., blank] - logits[..., :blank].amax(-1)).median()
    model.phone_picker.fully_connected.bias[blank] -= margin
    for m in norms:
        m.track_stats = True
    model.train(mode)
    return -float(margin)


def chunk_models(device="cuda", seed: int = 0
                 ) -> Tuple[Dict[str, ChunkConformer], float]:
    """-> ({"float32": model, "bfloat16": model} with the same weights, the
    blank bias's move)."""
    f32 = build_chunk_model(chunk_config("float32"), N_PHONE, N_CHAR,
                            device=device, seed=seed)
    dev = f32.device
    moved = calibrate(f32)
    bf16 = ChunkConformer(chunk_config("bfloat16"), N_PHONE, N_CHAR)
    bf16.load_state_dict(f32.state_dict())
    return {"float32": f32, "bfloat16": bf16.to(dev).eval()}, moved
