"""Multi-resolution STFT loss (Parallel-WaveGAN style), the VAD's denoising
term.

Counterpart of ``tensorflowasr_tpu/ops/stft_loss.py``. Per resolution,

  sc_loss  = ||  |Y| - |X|  ||_F / || |Y| ||_F      (spectral convergence)
  mag_loss = mean | log|Y| - log|X| |                (log-magnitude L1)

summed over the resolutions (fft 1024 / frame 600 / hop 120 and 512 / 250 /
50) and averaged. The STFT is ``tf.signal.stft``'s: a periodic Hann window
of ``frame_length``, no centring, frames taken by ``frame_length`` (so
``1 + (T - frame_length) // hop`` of them), each zero-padded at its end to
``fft_length``. ``torch.stft`` is not that when ``frame_length <
fft_length``: it centres the window inside ``fft_length`` and frames by
``fft_length``, which reads other samples and gives fewer frames. So the
frames are cut with ``unfold`` and go through ``torch.fft.rfft``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from tensorflowasr_tpu_torch.ops.frontend import hann_window


def stft_magnitude(x: torch.Tensor, frame_length: int, frame_step: int,
                   fft_length: int) -> torch.Tensor:
    """[B, T] -> [B, 1 + (T - frame_length) // frame_step, fft_length // 2
    + 1] magnitudes."""
    frames = x.unfold(1, frame_length, frame_step)
    win = torch.from_numpy(hann_window(frame_length)).to(x.device)
    return torch.fft.rfft(frames * win, n=fft_length, dim=-1).abs()


def _norm(a: torch.Tensor) -> torch.Tensor:
    # sqrt(sum + eps), not torch.linalg.norm: the norm's gradient is
    # diff / norm, 0 / 0 when prediction and target are equal (all-silence
    # windows collapse both spectra onto the same floor); the eps keeps the
    # value and makes that gradient 0
    return torch.sqrt(torch.sum(a * a, dim=(1, 2)) + 1e-24)


def _single_res_loss(y: torch.Tensor, x: torch.Tensor, frame_length: int,
                     frame_step: int, fft_length: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    x_mag = stft_magnitude(x, frame_length, frame_step, fft_length)
    y_mag = stft_magnitude(y, frame_length, frame_step, fft_length)
    x_mag = torch.sqrt(x_mag ** 2 + 1e-7) + 1e-6
    y_mag = torch.sqrt(y_mag ** 2 + 1e-7) + 1e-6
    sc = _norm(y_mag - x_mag) / (_norm(y_mag) + 1e-12)
    mag = torch.mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)),
                     dim=(1, 2))
    return sc.mean(), mag.mean()


def multi_resolution_stft_loss(
        y: torch.Tensor, x: torch.Tensor,
        fft_lengths: Sequence[int] = (1024, 512),
        frame_lengths: Sequence[int] = (600, 250),
        frame_steps: Sequence[int] = (120, 50)) -> torch.Tensor:
    """Scalar loss of the prediction ``x`` against the target ``y``, both
    [B, ...], flattened to [B, T]."""
    y = y.reshape(y.shape[0], -1).to(torch.float32)
    x = x.reshape(x.shape[0], -1).to(torch.float32)
    sc_total, mag_total = 0.0, 0.0
    for fl, fs, nfft in zip(frame_lengths, frame_steps, fft_lengths):
        sc, mag = _single_res_loss(y, x, fl, fs, nfft)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(fft_lengths)
    return sc_total / n + mag_total / n
