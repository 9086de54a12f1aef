"""Plain log-mel frontend of TensorflowASR's speech features.

wav [B, T] -> frames of n_fft = 1024 every hop (10 ms) -> periodic Hann
window -> |rfft|^2 -> dB -> Slaney mel product [n_freq, n_mels].

- 'same' (offline): TF-style padding (the odd extra sample on the right),
  10 log10 of the power, minus each example's maximum, floored at -80 dB;
- 'valid' (chunk streaming): n_fft - 1 zeros on the left, plain log10.

Both give ceil(T / hop) frames. The mel basis is librosa's Slaney basis
(htk=False, norm=1), computed here in float64 and rounded once.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

N_FFT = 1024


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10)
                                               / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


@functools.lru_cache(maxsize=4)
def mel_basis(sample_rate: int = 16000, n_fft: int = N_FFT,
              n_mels: int = 80) -> np.ndarray:
    """Slaney triangular filters with area normalisation, [n_freq, n_mels]
    float32."""
    n_freq = n_fft // 2 + 1
    fft_f = np.linspace(0.0, sample_rate / 2.0, n_freq)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0),
                                   _hz_to_mel(sample_rate / 2.0), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.T.astype(np.float32)


def n_frames(n_samples: int, hop: int) -> int:
    return -(-n_samples // hop)


def left_pad(n_samples: int, hop: int, same: bool) -> int:
    if not same:
        return N_FFT - 1
    out = n_frames(n_samples, hop)
    return max((out - 1) * hop + N_FFT - n_samples, 0) // 2


def log_mel(wav: torch.Tensor, same: bool, hop: int = 160, n_mels: int = 80,
            sample_rate: int = 16000) -> torch.Tensor:
    """f32 wav [B, T] -> log-mel [B, ceil(T / hop), n_mels] in f32."""
    wav = wav.to(torch.float32)
    b, t = wav.shape
    nf = n_frames(t, hop)
    lo = left_pad(t, hop, same)
    total = (nf - 1) * hop + N_FFT
    frames = F.pad(wav, (lo, max(0, total - lo - t))).unfold(1, N_FFT,
                                                             hop)[:, :nf]
    n = torch.arange(N_FFT, dtype=torch.float64, device=wav.device)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * n / N_FFT)).to(
        torch.float32)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    if same:
        db = 10.0 * torch.log10(torch.clamp_min(power, 1e-10))
        db = db - db.amax(dim=(1, 2), keepdim=True)
        db = torch.clamp_min(db, -80.0)
    else:
        db = torch.log10(torch.clamp_min(power, 1e-10))
    basis = torch.from_numpy(mel_basis(sample_rate, N_FFT, n_mels)).to(
        wav.device)
    return torch.matmul(db, basis)
