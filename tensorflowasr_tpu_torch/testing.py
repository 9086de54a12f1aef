"""Synthetic inputs and calibrated untrained models at the shipped widths,
for the CPU tests, the card tests, ``chip_smoke.py`` and
``serve/bench_ebf_buckets.py``. No program module imports this one.

A model with seeded random weights decides nothing: an untrained CTC head
argmaxes one class everywhere, a random picker keeps every frame or none,
and a random VAD or punctuation head sits on one side of its threshold.
The helpers here move a few weights so that the decisions follow the
signal, as training would, and make the signals that they follow:

- :func:`tones`: 50 ms segments of two random tones at one of three
  loudness levels, frames that a random-weight model tells apart;
- :func:`calibrate`: the chunk model's first conv x10 and its picker's
  blank bias moved by the median margin, so that about half the frames are
  picked;
- :func:`tone_bursts`, :func:`calibrate_vad`, :func:`calibrate_punc`: tone
  bursts between quiet gaps, a VAD head that says loud >= 0 and quiet < 0,
  and a punctuation head that inserts at a chosen share of positions.

The training batches are the JAX package's ``bench.py`` training batch, B =
128 x 8 s, 64 phones and 32 chars of full length, over 231 phone and 9161
char classes. :data:`MAIN_PATH` lists the shapes the main path gives the
frontend kernels, and :func:`ebranchformer_l`, :func:`ebf_batch` and
:func:`ebf_decode` make the E-Branchformer (L)'s decode batches.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tensorflowasr_tpu_torch.models.chunk_conformer import (
    ChunkConformer,
    ChunkConformerConfig,
    build_chunk_model,
)
from tensorflowasr_tpu_torch.models.conformer import build_model
from tensorflowasr_tpu_torch.models.ebranchformer import offline_config
from tensorflowasr_tpu_torch.models.layers import BatchNorm
from tensorflowasr_tpu_torch.serve.engines import predict_step
from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer
from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer
from tensorflowasr_tpu_torch.utils.config import UserConfig

SR = 16000
N_PHONE, N_CHAR = 231, 9161
TRAIN_B, TRAIN_SECONDS, TRAIN_PHONES, TRAIN_CHARS = 128, 8, 64, 32
EXTRA_PHONES, EXTRA_CHARS = 64, 32          # the chunk model's text branch

CHUNK_SAMPLES = 2560                        # one 160 ms chunk
CHUNK_S = CHUNK_SAMPLES / SR
FULL_WIDTH = dict(dmodel=144, encoder_blocks=15, picker_blocks=1,
                  helper_blocks=2, decoder_blocks=1, decoder_win_back=8,
                  win_front=36, chunk_samples=CHUNK_SAMPLES)
CALIBRATION_ROWS = 8

VAD_SR = 8000
FRAME = 80
# an 8 s stream of (seconds, loud) pieces for StreamASRSession's defaults
# (0.5 s chunks, wait_sil 5): two sentences; the 0.35 s pause inside the
# first starts just before a chunk is sent, so that send is an inter break
STREAM_PATTERN = ((0.4, False), (1.75, True), (0.35, False), (1.25, True),
                  (1.9, False), (1.5, True), (0.85, False))
PUNC_TOKENS = ("，", "。", "？", "！", "、")
LOUD = 0.05            # a frame's peak above this is a burst's


def shipped_config(model_yml: str = "conformerS.yml",
                   extra=None) -> UserConfig:
    """``configs/am_data.yml`` + ``configs/<model_yml>`` of this
    checkout."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs")
    return UserConfig(os.path.join(root, "am_data.yml"),
                      os.path.join(root, model_yml), extra=extra)


# -- the offline ConformerCTC(S) ----------------------------------------------

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


def new_trainer(dtype: str, device: str, extra=None) -> CTCTrainer:
    """A full-width ``CTCTrainer`` with seeded weights (seed 0)."""
    trainer = CTCTrainer(shipped_config(extra=extra), N_PHONE, N_CHAR,
                         blank_id=N_PHONE - 1, device=device,
                         compute_dtype=dtype)
    trainer.init_state(seed=0)
    return trainer


# -- the chunk-streaming ChunkConformer(S) ------------------------------------

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


def chunk_config(dtype: str) -> ChunkConformerConfig:
    """The shipped chunk config of this checkout; raises unless it has the
    full width (dmodel 144, 15 encoder blocks, 1 picker, 2 helper and 1
    decoder block with win_back 8)."""
    cfg = ChunkConformerConfig.from_user_config(
        shipped_config("chunk_conformerS.yml"), dtype)
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
    """Gain the first conv 10x (the 'valid' log-mel is not normalized and
    spans about 0.1, so every frame would look alike to the encoder) and
    move the picker's blank bias by the median margin of the blank logit
    over the other classes on ``wav`` (4 x 4 s of tones by default). The
    margin is taken in eval mode, or with ``training`` in training mode
    (BatchNorm on the batch's statistics, its running statistics left
    alone), the mode the model is then used in. Returns the bias's move."""
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
    """The full-width chunk model calibrated in eval mode: ({"float32":
    model, "bfloat16": model} with the same weights, the blank bias's
    move)."""
    f32 = build_chunk_model(chunk_config("float32"), N_PHONE, N_CHAR,
                            device=device, seed=seed)
    dev = f32.device
    moved = calibrate(f32)
    bf16 = ChunkConformer(chunk_config("bfloat16"), N_PHONE, N_CHAR)
    bf16.load_state_dict(f32.state_dict())
    return {"float32": f32, "bfloat16": bf16.to(dev).eval()}, moved


def with_fused_decoder(model: ChunkConformer) -> ChunkConformer:
    """A copy of ``model`` (its weights, device and mode) with
    ``fused_decoder`` set: the decoder phase as one pass a chunk."""
    fused = ChunkConformer(
        dataclasses.replace(model.cfg, fused_decoder=True),
        model.num_phone_classes, model.num_char_classes)
    fused.load_state_dict(model.state_dict())
    return fused.to(model.device).train(model.training)


def bench_wav(b: int, seconds: float) -> np.ndarray:
    """[b, seconds * SR] of tones, row i seeded with 1000 + i."""
    return np.stack([tones(seconds, seed=1000 + i) for i in range(b)])


def chunk_train_batch(b: int = TRAIN_B, seconds: float = TRAIN_SECONDS,
                      n_phones: int = TRAIN_PHONES,
                      n_chars: int = TRAIN_CHARS,
                      n_extra_phones: int = EXTRA_PHONES,
                      n_extra_chars: int = EXTRA_CHARS) -> dict:
    """A seeded numpy batch for ``ChunkTrainer``: tones, full-length labels
    and text-only labels. ``seconds`` must be whole 0.16 s chunks."""
    n = int(round(seconds * SR))
    if n % CHUNK_SAMPLES:
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
    """A full-width ``ChunkTrainer`` with seeded weights (seed 0),
    calibrated in training mode on the first ``CALIBRATION_ROWS`` rows of
    :func:`chunk_train_batch` (BatchNorm's batch statistics set the
    margins), so that it picks about half of the frames at the first step:
    a random picker keeps every frame or none, and ``t_ref`` would then be
    the whole width or the label width."""
    trainer = ChunkTrainer(shipped_config("chunk_conformerS.yml"), N_PHONE,
                           N_CHAR, device=device, compute_dtype=dtype)
    if trainer.model_cfg != chunk_config(dtype):
        raise ValueError(f"not the full-width chunk config: "
                         f"{trainer.model_cfg}")
    trainer.init_state(seed=0)
    calibrate(trainer.state.model, training=True,
              wav=bench_wav(CALIBRATION_ROWS, TRAIN_SECONDS))
    return trainer


# -- VAD and punctuation ------------------------------------------------------

def tone_bursts(pattern: Sequence[Tuple[float, bool]], seed: int,
                sr: int = SR) -> np.ndarray:
    """Bursts of 50 ms segments of two random tones at one of two loudness
    levels between quiet gaps, piece by piece as ``pattern`` says, over a
    noise floor of 1e-3 (a microphone's: digital silence makes the 'same'
    log-mel's per-example normalisation divide rounding noise by nothing)."""
    rng = np.random.default_rng(seed)
    pieces = []
    for seconds, loud in pattern:
        n = int(round(seconds * sr))
        wav = 1e-3 * rng.standard_normal(n)
        if loud:
            t = np.arange(n) / sr
            seg = sr // 20
            for s in range(0, n, seg):
                f = rng.uniform(150, 3500, (2, 1))
                wav[s:s + seg] += np.sin(2 * np.pi * f * t[s:s + seg]).sum(
                    0) * rng.choice([0.15, 0.35])
        pieces.append(wav)
    return np.concatenate(pieces).astype(np.float32)


def file_pattern(seconds: float) -> List[Tuple[float, bool]]:
    """A file of ``seconds``: a gap first, then bursts of 0.8-1.1 s between
    gaps of 0.3-0.6 s, the last piece cut to fit."""
    out, total, loud = [], 0.0, False
    while total < seconds - 1e-9:
        piece = min((0.8 if loud else 0.3) + 0.1 * (len(out) % 4),
                    seconds - total)
        out.append((piece, loud))
        total += piece
        loud = not loud
    return out


def vad_frames(wav16k: np.ndarray, downsample: int = SR // VAD_SR
               ) -> np.ndarray:
    """16 kHz audio -> the VAD's [1, N, 80] frames at 8 kHz."""
    ds = wav16k[::downsample]
    n = len(ds) // FRAME
    return np.ascontiguousarray(ds[:n * FRAME].reshape(1, n, FRAME))


def _reach(model: torch.nn.Module) -> Tuple[int, int]:
    """Frames before and after a frame that its logit depends on: two
    causal k=3 convs, or four k=5 convs at dilations 1, 2, 4, 8."""
    from tensorflowasr_tpu_torch.models.vad import OnlineVAD

    return (4, 0) if isinstance(model, OnlineVAD) else (30, 30)


@torch.no_grad()
def calibrate_vad(model: torch.nn.Module, wav16k: np.ndarray) -> float:
    """Point ``model``'s ``fc`` kernel along the difference of the mean
    hidden features of the loud and the silent 8 kHz frames of ``wav16k``
    and put its bias halfway between the two groups' projections, so that
    frames with sound give logits >= 0 and silent ones < 0. Frames whose
    reach spans both kinds (an onset or an offset) are left out of the
    calibration and take what they get. Returns the smallest |logit| over
    the other frames. Leaves ``model`` in eval mode."""
    model.eval()
    frames = vad_frames(wav16k)
    loud = np.abs(frames[0]).max(-1) > LOUD
    back, fwd = _reach(model)
    pad = np.pad(loud, (back, fwd), mode="edge").astype(int)
    window = np.lib.stride_tricks.sliding_window_view(pad, back + fwd + 1)
    pure = window.min(-1) == window.max(-1)
    if not (loud & pure).any() or not (~loud & pure).any():
        raise ValueError("calibration needs loud and silent frames")
    dev = model.fc.weight.device
    h = model.features(torch.from_numpy(frames).to(dev))[0].double()
    on = torch.from_numpy(loud & pure).to(dev)
    off = torch.from_numpy(~loud & pure).to(dev)
    w = h[on].mean(0) - h[off].mean(0)
    w = w / w.norm()
    p = h @ w
    lo, hi = float(p[off].max()), float(p[on].min())
    if lo >= hi:
        raise ValueError(f"loud and silent frames overlap ({lo} >= {hi})")
    scale = 8.0 / (hi - lo)            # the two groups 8 logits apart
    model.fc.weight.copy_((scale * w)[None].float())
    model.fc.bias.fill_(-scale * (lo + hi) / 2)
    logits = model(torch.from_numpy(frames).to(dev))[0][0, :, 0].cpu()
    if ((logits.numpy() >= 0) != loud)[pure].any():
        raise AssertionError("the calibrated VAD misclassifies a frame")
    return float(logits[torch.from_numpy(pure)].abs().min())


@torch.no_grad()
def calibrate_punc(model: torch.nn.Module, ids: np.ndarray,
                   threshold: float, share: float = 0.25) -> float:
    """Move and scale ``model``'s class layer so that, over the real
    (non-zero) positions of ``ids`` [B, T], each class's mean logit is 0,
    the logits spread 4 (the pad class 20 lower), and then about ``share``
    of the positions put a probability of at least ``threshold`` on one
    punctuation class (>= 2). Returns the share reached. Leaves ``model``
    in eval mode."""
    model.eval()
    dev = model.final_bd_layer.bias.device
    x = torch.from_numpy(np.asarray(ids, np.int64)).to(dev)
    real = x != 0
    logits = model(x)[0][real].double()
    layer = model.final_bd_layer
    layer.bias -= logits.mean(0).float()
    logits -= logits.mean(0)
    # logits spread 4 across the classes, the pad class 0 out of reach
    scale = 4.0 / float(logits.std())
    layer.weight *= scale
    layer.bias *= scale
    layer.bias[0] -= 20.0
    logits *= scale
    logits[:, 0] -= 20.0

    def reached(offset: float) -> float:
        z = logits.clone()
        z[:, 1] += offset
        p = torch.softmax(z, -1)
        top = p.argmax(-1)
        hit = (top >= 2) & (p.max(-1).values >= threshold)
        return float(hit.double().mean())

    lo, hi = -30.0, 30.0               # a lower offset inserts more
    for _ in range(60):
        mid = (lo + hi) / 2
        if reached(mid) > share:
            lo = mid
        else:
            hi = mid
    layer.bias[1] += lo
    return reached(lo)


# -- the frontend kernels' shapes and the E-Branchformer (L) ------------------

# the main path's shapes at 16 kHz: the serve and train batches (B = 128 x
# 7 s and 8 s), the block-streaming fold (B = 128 x 15 chunks of 7680),
# the CLI buckets (B = 8 x 2 s and 4 s; the chunk path rounds 2 s up to
# whole chunks, 33280, and 4 s is whole), the card-against-CPU batches, and
# the chunk path's stream step and pool tick ([wav tail | chunk]) and its
# CLI wav
MAIN_PATH = [(128, 7 * SR), (128, 8 * SR), (1920, 7680),
             (8, 2 * SR), (8, 4 * SR), (8, 33280),
             (2, SR), (2, 20480), (1, 5120), (256, 5120), (1, 128000)]
# K1 against its plain version: the Pallas kernel's own tolerance
# (tests/test_pallas_frontend.py)
POWER_TOL = dict(rtol=2e-4, atol=2e-3)
# K1b against its plain version on one card, both in f32: the kernels' FFT
# and the plain DFT round differently (8.0e-5 seen at most on an H100), and
# a bulk 'valid' log-mel of this noise is about 0.02, so atol stays under
# 3 % of it; the Pallas kernel's 1e-3 / 5e-2 is for JAX against the port
KERNEL_LOGMEL_TOL = dict(rtol=1e-4, atol=5e-4)

EBF_B = 32
EBF_BUCKETS = (8, 12, 16, 20)            # seconds
FRAME_SAMPLES = 640                      # a 40 ms encoder frame


def ebranchformer_l(dtype: str = "bfloat16", device: str = "cuda"):
    """The shipped E-Branchformer (L) of this checkout (dmodel 512, 17
    blocks of 8 x 64 heads) with seeded weights, in eval mode."""
    cfg = offline_config(shipped_config("ebranchformerL.yml"), dtype)
    return build_model(cfg, N_PHONE, N_CHAR, device=device, seed=0)


def ebf_batch(seconds: int, seed: int, device: str = "cuda"):
    """(wav [EBF_B, seconds x SR] f32, frame lengths [EBF_B] int32) of one
    decode bucket: noise, each row's frame length drawn from the bucket's
    last 4 s, the first row whole, as the decode cell's segments fill their
    buckets."""
    rng = np.random.default_rng(seed)
    n = seconds * SR
    wav = (0.1 * rng.standard_normal((EBF_B, n))).astype(np.float32)
    dur = rng.uniform(seconds - 4, seconds, EBF_B)
    dur[0] = seconds
    lengths = (dur * SR // FRAME_SAMPLES).astype(np.int32)
    return (torch.from_numpy(wav).to(device),
            torch.from_numpy(lengths).to(device))


def ebf_decode(model, wav, lengths) -> list:
    """One ``predict_step`` with its ids fetched to the host."""
    return [x.cpu() for x in predict_step(model, wav, lengths)]
