"""SpecAugment on the device: time / frequency hole masking of the log-mel.

Counterpart of ``tensorflowasr_tpu/ops/specaug.py`` (Park et al. 2019):
``n`` frequency bands of width ~ U{0..F} and ``n`` time bands of width
~ U{0..round(T * ratio)} per utterance, filled with the utterance's mean
log-mel value (detached, a hole of "average energy"). It runs inside the
train step on the frontend's output, so it costs the host nothing.

Drawing and applying are apart: :func:`draw_bands` takes the random widths
and starts from a ``torch.Generator``, :func:`apply_bands` is deterministic
given them (and can be held against the JAX package's masking on the same
bands). The generator's numbers are not ``jax.random``'s.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Bands = Tuple[torch.Tensor, torch.Tensor]      # (start [B, n], width [B, n])


def draw_bands(generator: torch.Generator, batch: int, n_masks: int,
               dim: int, max_width: int) -> Bands:
    """``n_masks`` random bands per example on an axis of length ``dim``:
    width ~ U{0..max_width}, start ~ U{0..dim - width}, so every band lies
    inside the axis. Drawn on the generator's device."""
    max_width = max(0, min(int(max_width), dim))
    dev = generator.device
    w = torch.randint(0, max_width + 1, (batch, n_masks),
                      generator=generator, device=dev, dtype=torch.int32)
    u = torch.rand((batch, n_masks), generator=generator, device=dev)
    s = torch.floor(u * (dim - w + 1).to(torch.float32)).to(torch.int32)
    return s, w


def band_mask(bands: Bands, dim: int) -> torch.Tensor:
    """[B, dim] bool: the union of each example's bands."""
    s, w = bands
    pos = torch.arange(dim, device=s.device)[None, None, :]
    band = (pos >= s[..., None]) & (pos < (s + w)[..., None])   # [B, n, dim]
    return band.any(dim=1)


def apply_bands(mel: torch.Tensor, freq_bands: Optional[Bands],
                time_bands: Optional[Bands]) -> torch.Tensor:
    """Fill the given frequency and time bands of a log-mel batch
    [B, T, F] with each utterance's mean (detached)."""
    b, t, f = mel.shape
    masked = torch.zeros((b, t, f), dtype=torch.bool, device=mel.device)
    if freq_bands is not None:
        masked = masked | band_mask(freq_bands, f)[:, None, :]
    if time_bands is not None:
        masked = masked | band_mask(time_bands, t)[:, :, None]
    fill = mel.detach().mean(dim=(1, 2), keepdim=True)
    return torch.where(masked, fill.to(mel.dtype), mel)


def spec_augment(mel: torch.Tensor, generator: torch.Generator,
                 n_freq_masks: int = 2, freq_width: int = 27,
                 n_time_masks: int = 2, time_ratio: float = 0.05
                 ) -> torch.Tensor:
    """Mask random time / frequency bands of a log-mel batch [B, T, F].
    ``time_ratio`` scales the widest time band with the sequence length, so
    one setting serves every duration bucket."""
    b, t, f = mel.shape
    freq_bands = time_bands = None
    if n_freq_masks > 0 and freq_width > 0:
        freq_bands = draw_bands(generator, b, n_freq_masks, f, freq_width)
    time_width = int(round(t * float(time_ratio)))
    if n_time_masks > 0 and time_width > 0:
        time_bands = draw_bands(generator, b, n_time_masks, t, time_width)
    return apply_bands(mel, freq_bands, time_bands)
