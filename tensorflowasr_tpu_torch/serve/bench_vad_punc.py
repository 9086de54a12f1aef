"""Signals and calibrated random weights for driving the VAD and
punctuation serving path (``StreamASRSession``, the VAD-segmented
``OfflineASRSession``, the ``vad`` op), shared by ``chip_smoke.py`` and the
CPU tests.

A VAD or punctuation model with random weights decides nothing: its logits
sit on one side of the threshold everywhere. These helpers move only the
last layer of a randomly initialised model so that its decisions follow the
signal, as training would:

- :func:`calibrate_vad` points the ``fc`` kernel along the difference of
  the mean hidden features of loud and silent frames and puts the bias
  halfway between the two groups' projections, so tone bursts give logits
  clearly >= 0 and silent gaps clearly < 0;
- :func:`calibrate_punc` centres and scales the class logits and lowers
  the "no punctuation" bias until a chosen share of positions clears the
  insertion threshold.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

SR = 16000
VAD_SR = 8000
FRAME = 80
# an 8 s stream of (seconds, loud) pieces for StreamASRSession's defaults
# (0.5 s chunks, wait_sil 5): two sentences; the 0.35 s pause inside the
# first starts just before a chunk is sent, so that send is an inter break
STREAM_PATTERN = ((0.4, False), (1.75, True), (0.35, False), (1.25, True),
                  (1.9, False), (1.5, True), (0.85, False))
PUNC_TOKENS = ("，", "。", "？", "！", "、")
LOUD = 0.05            # a frame's peak above this is a burst's


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
    """Set ``model``'s ``fc`` layer so that the 8 kHz frames of ``wav16k``
    with sound give logits >= 0 and the silent ones < 0 (see the module
    docstring). Frames whose reach spans both kinds (an onset or an
    offset) are left out of the calibration and take what they get.
    Returns the smallest |logit| over the other frames. Leaves ``model``
    in eval mode."""
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
