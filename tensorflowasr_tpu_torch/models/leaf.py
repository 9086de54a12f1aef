"""LEAF, the learnable audio frontend (``mel_layer_type: leaf``).

Counterpart of ``tensorflowasr_tpu/models/leaf.py``:

    wav -> preemphasis conv (k = 2, SAME, kernel [[-alpha], [1]])
        -> complex Gabor conv: 2n channels, even real and odd imaginary,
           regenerated every call from n (center, fwhm) parameters
        -> squared modulus (re^2 + im^2)
        -> Gaussian lowpass, a depthwise conv at stride = hop, TF SAME pads
        -> floor 1e-5
        -> PCEN (per-channel energy normalisation with a learnable EMA)
        -> instance norm over time per channel (biased variance, eps 1e-6)

Traps kept from the JAX package: the constraints (the Gabor clip, the
lowpass sigma clip, PCEN's ``alpha <= 1``, ``root >= 1`` and ``smooth`` in
[0, 1]) act at call time, the stored parameters stay as they are; the
pooling's SAME padding at stride 160 is made by hand; PCEN's EMA starts
from the first frame and runs frame by frame (a closed form would round
otherwise). The whole frontend is f32 and launches no kernel of this repo:
the two convs are cuDNN's, the EMA a Python loop of small launches.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowasr_tpu_torch.models.layers import _same_pad


# ---------------------------------------------------------------------------
# Host-side initialisation: Gabor parameters from an HTK mel filterbank
# ---------------------------------------------------------------------------

def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def linear_to_mel_weight_matrix(num_mel_bins: int, num_spectrogram_bins: int,
                                sample_rate: int, lower_edge_hertz: float,
                                upper_edge_hertz: float) -> np.ndarray:
    """HTK mel filterbank with triangles in the mel domain and the DC bin
    zeroed (``tf.signal.linear_to_mel_weight_matrix``):
    [num_spectrogram_bins, num_mel_bins] f32."""
    nyquist = sample_rate / 2.0
    lin_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)
    spec_mels = _hz_to_mel_htk(lin_freqs[1:])
    band_edges = np.linspace(_hz_to_mel_htk(lower_edge_hertz),
                             _hz_to_mel_htk(upper_edge_hertz),
                             num_mel_bins + 2)
    lower, center, upper = (band_edges[:-2][None, :],
                            band_edges[1:-1][None, :],
                            band_edges[2:][None, :])
    s = spec_mels[:, None]
    low_slope = (s - lower) / (center - lower)
    up_slope = (upper - s) / (upper - center)
    w = np.maximum(0.0, np.minimum(low_slope, up_slope))
    return np.concatenate(
        [np.zeros((1, num_mel_bins)), w], axis=0).astype(np.float32)


def gabor_params_from_mels(n_filters: int, sample_rate: int,
                           min_freq: float, max_freq: float,
                           n_fft: int = 512) -> np.ndarray:
    """[n_filters, 2] (center in rad/sample, fwhm parameter) of each mel
    filter's square root: its peak bin and its width at half the peak."""
    mel = linear_to_mel_weight_matrix(
        n_filters, n_fft // 2 + 1, sample_rate, min_freq, max_freq).T
    sqrt_filters = np.sqrt(mel)
    center_bins = np.argmax(sqrt_filters, axis=1).astype(np.float64)
    peaks = sqrt_filters.max(axis=1, keepdims=True)
    fwhms = (sqrt_filters >= peaks / 2.0).sum(axis=1).astype(np.float64)
    coeff = math.sqrt(2.0 * math.log(2.0)) * n_fft
    params = np.stack([center_bins * 2.0 * np.pi / n_fft,
                       coeff / (np.pi * fwhms)], axis=1)
    return params.astype(np.float32)


# ---------------------------------------------------------------------------
# Filters, regenerated from the parameters every call
# ---------------------------------------------------------------------------

def gabor_constraint(params: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Clip centers to [0, pi] and fwhm parameters to the widths a
    ``kernel_size`` window can hold."""
    mu = torch.clamp(params[:, 0], 0.0, math.pi)
    sigma_lower = 4.0 * math.sqrt(2.0 * math.log(2.0)) / math.pi
    sigma_upper = kernel_size * math.sqrt(2.0 * math.log(2.0)) / math.pi
    sigma = torch.clamp(params[:, 1], sigma_lower, sigma_upper)
    return torch.stack([mu, sigma], dim=1)


def gabor_filters_realimag(params: torch.Tensor, size: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(real [n, size], imag [n, size]) Gabor impulse responses in real
    arithmetic."""
    t = torch.arange(-(size // 2), (size + 1) // 2, dtype=torch.float32,
                     device=params.device)
    center, fwhm = params[:, 0:1], params[:, 1:2]
    denom = 1.0 / (math.sqrt(2.0 * math.pi) * fwhm)
    gauss = torch.exp(-(t[None, :] ** 2) / (2.0 * fwhm ** 2))
    phase = center * t[None, :]
    return denom * gauss * torch.cos(phase), denom * gauss * torch.sin(phase)


def gaussian_lowpass_kernel(sigma: torch.Tensor, size: int) -> torch.Tensor:
    """[C] sigma -> [size, C] zero-centred Gaussian windows, sigma clipped
    to [2 / size, 0.5]."""
    sigma = torch.clamp(sigma, 2.0 / size, 0.5)
    t = torch.arange(size, dtype=torch.float32, device=sigma.device)[:, None]
    numerator = t - 0.5 * (size - 1)
    denominator = sigma[None, :] * 0.5 * (size - 1)
    return torch.exp(-0.5 * (numerator / denominator) ** 2)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

# the reference encoder's LEAF: every stage on, these constants
WINDOW_LEN_MS = 25.0
PREEMP_ALPHA = 0.97
POOL_SIGMA = 0.4
PCEN_INIT = dict(alpha=0.96, delta=2.0, root=2.0, smooth=0.04)
PCEN_FLOOR = 1e-12
NORM_EPS = 1e-6


class PCEN(nn.Module):
    """Per-channel energy normalisation with a learnable per-channel EMA on
    [B, T, C]: (x / (floor + EMA(x))^alpha + delta)^(1/root) -
    delta^(1/root)."""

    def __init__(self, n_channels: int):
        super().__init__()
        for name, value in PCEN_INIT.items():
            setattr(self, name, nn.Parameter(torch.full((n_channels,),
                                                        value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = torch.clamp_max(self.alpha, 1.0)
        root = torch.clamp_min(self.root, 1.0)
        w = torch.clamp(self.smooth, 0.0, 1.0)
        # the EMA from the first frame, one frame a step (JAX's lax.scan)
        state, frames = x[:, 0], []
        keep = 1.0 - w
        for t in range(x.shape[1]):
            state = w * x[:, t] + keep * state
            frames.append(state)
        ema = torch.stack(frames, dim=1)
        one_over_root = 1.0 / root
        return ((x / (PCEN_FLOOR + ema) ** alpha + self.delta)
                ** one_over_root - self.delta ** one_over_root)


class Leaf(nn.Module):
    """wav [B, T(, 1)] -> features [B, ceil(T / hop), n_filters], as the
    reference encoder builds it: preemphasis, the Gabor conv over 25 ms
    windows, Gaussian pooling, PCEN and instance norm; centers from 30 to
    3900 Hz times ``sample_rate // 8000``."""

    def __init__(self, n_filters: int = 80, sample_rate: int = 16000,
                 window_stride_ms: float = 10.0):
        super().__init__()
        self.n_filters = n_filters
        self.kernel_size = int(sample_rate * WINDOW_LEN_MS // 1000 + 1)
        self.stride = int(sample_rate * window_stride_ms // 1000)
        # HIO [2, 1, 1], as flax stores it
        self.preemp_kernel = nn.Parameter(torch.tensor(
            [[[-PREEMP_ALPHA]], [[1.0]]], dtype=torch.float32))
        self.gabor_params = nn.Parameter(torch.from_numpy(
            gabor_params_from_mels(n_filters, sample_rate,
                                   30.0 * (sample_rate // 8000),
                                   3900.0 * (sample_rate // 8000))))
        self.pool_sigma = nn.Parameter(torch.full((n_filters,), POOL_SIGMA))
        self.pcen = PCEN(n_filters)
        self.norm_scale = nn.Parameter(torch.ones(n_filters))
        self.norm_bias = nn.Parameter(torch.zeros(n_filters))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if wav.dim() == 3:
            wav = wav[..., 0]
        x = wav.to(torch.float32)[:, None, :]                  # [B, 1, T]
        t = x.shape[-1]
        k = self.kernel_size
        x = F.conv1d(F.pad(x, _same_pad(t, 2, 1)),
                     self.preemp_kernel.permute(2, 1, 0))
        params = gabor_constraint(self.gabor_params, k)
        real, imag = gabor_filters_realimag(params, k)
        # interleaved: channel 2i is filter i's real part, 2i + 1 its imag
        filt = torch.stack([real, imag], dim=1).reshape(2 * self.n_filters,
                                                        1, k)
        y = F.conv1d(F.pad(x, _same_pad(t, k, 1)), filt)     # [B, 2n, T]
        y = y.reshape(y.shape[0], self.n_filters, 2, t)
        y = (y * y).sum(dim=2)                                # [B, n, T]
        pool = gaussian_lowpass_kernel(self.pool_sigma, k)    # [k, n]
        y = F.conv1d(F.pad(y, _same_pad(t, k, self.stride)),
                     pool.t()[:, None, :], stride=self.stride,
                     groups=self.n_filters)                   # [B, n, F]
        y = self.pcen(torch.clamp_min(y, 1e-5).transpose(1, 2))
        # instance norm over time per channel, the biased variance
        mean = y.mean(dim=1, keepdim=True)
        var = ((y - mean) ** 2).mean(dim=1, keepdim=True)
        return ((y - mean) * torch.rsqrt(var + NORM_EPS) * self.norm_scale
                + self.norm_bias)
