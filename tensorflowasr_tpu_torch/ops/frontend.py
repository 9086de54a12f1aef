"""Audio frontend: framed-DFT log-mel spectrogram.

Counterpart of ``tensorflowasr_tpu/ops/frontend.py``:

    wav [B, T]
      -> power  = |windowed DFT of hop-strided frames|^2   (K1 on CUDA)
      -> dB     ('same':  10*log10, per-example max-normalized, floor -80;
                 'valid': plain log10 — the chunk/streaming variant)
      -> Slaney mel matmul [n_freq, n_mels]

Semantics kept from the JAX package:
- Hann window is periodic; the mel basis is Slaney (htk=False, norm=1).
- 'same' padding is TF-style (odd extra sample on the right), 'valid'
  left-pads n_fft-1; both give ceil(T / hop) frames.
- dB is applied to the POWER spectrogram and the mel matmul mixes dB
  values.

:func:`log_mel_spectrogram` and :func:`power_spectrogram` call the
``torch.library`` custom ops ``tasr::log_mel_spectrogram``,
``tasr::log_mel_spectrogram_weights`` and ``tasr::power_spectrogram``, which
dispatch on the tensor's device: a CUDA tensor goes to a hand-written
kernel, a CPU tensor to the plain version, any other device raises. Each op
has a fake implementation, so ``torch.export`` carries it into an exported
program as one node (``export/exporter.py``). On the card the log-mel is
K1b (``ops/log_mel_spectrogram.py``): the FFT, the dB and the banded mel
product fused in one kernel, two launches for 'same' (its per-example max
first); a given (trainable) mel matrix takes K1 and a dense product kernel.
The power spectrogram alone is K1 (``ops/power_spectrogram.py``), and
:func:`spectrogram_feature` takes K1 and the plain dB pass.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from tensorflowasr_tpu_torch.ops import log_mel_spectrogram as k1b
from tensorflowasr_tpu_torch.ops import power_spectrogram as k1


# ---------------------------------------------------------------------------
# Host-side (numpy) constant builders
# ---------------------------------------------------------------------------

def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (scipy get_window('hann', n, fftbins=True))."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(
        np.float32)


def stft_kernels(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real/imag DFT matrices, each [n_fft, n_fft//2 + 1]."""
    n_freq = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    w = np.arange(n_freq)[None, :] * 2.0 * np.pi / n_fft
    real = np.cos(t * w)
    imag = -np.sin(t * w)
    win = hann_window(n_fft)[:, None]
    return (real * win).astype(np.float32), (imag * win).astype(np.float32)


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    return np.where(log_t, min_log_mel + np.log(np.maximum(f, 1e-10)
                                                / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    freqs)


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    mels = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                       n_mels)
    return _mel_to_hz_slaney(mels)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 80,
                   fmin: float = 0.0, fmax: Optional[float] = None
                   ) -> np.ndarray:
    """Slaney triangular mel filterbank with area normalisation, shape
    [n_fft//2+1, n_mels] (librosa.filters.mel(sr, n_fft, n_mels, fmin,
    fmax, htk=False, norm=1) transposed)."""
    if fmax is None:
        fmax = sr / 2.0
    n_freq = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]   # [n_mels+2, n_freq]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # [n_mels, n_freq]

    weights *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.T.astype(np.float32)         # [n_freq, n_mels]


# ---------------------------------------------------------------------------
# Config and cached constants
# ---------------------------------------------------------------------------

def _same_pad(t: int, k: int, s: int) -> Tuple[int, int]:
    """TF-style conv 'same' pads (lo, hi): length t, kernel k, stride s."""
    out = -(-t // s)
    pad = max((out - 1) * s + k - t, 0)
    return pad // 2, pad - pad // 2


@dataclasses.dataclass(frozen=True)
class LogMelFrontendConfig:
    sample_rate: int = 16000
    n_fft: int = 1024
    stride_ms: int = 10
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None
    padding: str = "same"          # 'same' (offline) | 'valid' (chunk/causal)
    dynamic_range_db: float = 80.0

    @property
    def hop(self) -> int:
        return self.sample_rate * self.stride_ms // 1000

    @property
    def n_freq(self) -> int:
        return self.n_fft // 2 + 1


@functools.lru_cache(maxsize=8)
def _frontend_constants(cfg: LogMelFrontendConfig):
    """Host numpy constants: DFT [n_fft, 2*n_freq] (re | im), mel basis."""
    real, imag = stft_kernels(cfg.n_fft)
    dft = np.concatenate([real, imag], axis=1)
    fb = mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                        cfg.fmin, cfg.fmax)
    return dft, fb


@functools.lru_cache(maxsize=16)
def _device_dft(cfg: LogMelFrontendConfig, device: torch.device
                ) -> torch.Tensor:
    return torch.from_numpy(_frontend_constants(cfg)[0]).to(device)


@functools.lru_cache(maxsize=16)
def _device_mel(cfg: LogMelFrontendConfig, device: torch.device
                ) -> torch.Tensor:
    return torch.from_numpy(_frontend_constants(cfg)[1]).to(device)


@functools.lru_cache(maxsize=16)
def _kernel_tables(cfg: LogMelFrontendConfig, device: torch.device
                   ) -> torch.Tensor:
    """K1's window / twiddle table, uploaded once per (config, device).
    Raises on an n_fft the kernel does not take."""
    return torch.from_numpy(k1.pack_tables(hann_window(cfg.n_fft))).to(device)


@functools.lru_cache(maxsize=16)
def _kernel_bands(cfg: LogMelFrontendConfig, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1b's schedule and weights for the fixed Slaney basis (each band's
    exact nonzero range), uploaded once per (config, device)."""
    bands = k1b.mel_bands(_frontend_constants(cfg)[1])
    return (torch.from_numpy(bands.schedule).to(device),
            torch.from_numpy(bands.weights).to(device))


def _left_pad(t: int, cfg: LogMelFrontendConfig) -> int:
    if cfg.padding == "same":
        return _same_pad(t, cfg.n_fft, cfg.hop)[0]
    if cfg.padding == "valid":
        return cfg.n_fft - 1
    raise ValueError(cfg.padding)


# ---------------------------------------------------------------------------
# Tensor ops
# ---------------------------------------------------------------------------

def wav_to_float(wav: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 in [-1, 1); float input passes through."""
    if wav.dtype == torch.int16:
        return wav.to(torch.float32) / 32768.0
    return wav


def power_spectrogram_reference(wav: torch.Tensor,
                                cfg: LogMelFrontendConfig) -> torch.Tensor:
    """Plain torch [B, T] -> [B, n_frames, n_freq] power spectrum."""
    wav = wav.to(torch.float32)
    return k1.power_spectrogram_plain(wav, _device_dft(cfg, wav.device),
                                      cfg.hop, _left_pad(wav.shape[1], cfg))


def power_spectrogram(wav: torch.Tensor, cfg: LogMelFrontendConfig
                      ) -> torch.Tensor:
    """[B, T] -> [B, n_frames, n_freq] power spectrum through
    ``tasr::power_spectrogram``: the K1 kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    _check_device(wav, "power_spectrogram")
    return power_spectrogram_op(wav.to(torch.float32).contiguous(),
                                *_op_args(cfg))


def amplitude_to_db(x: torch.Tensor, amin: float = 1e-10,
                    dynamic_range: float = 80.0) -> torch.Tensor:
    """10*log10 with per-example max normalization to [-range, 0]; the max
    is over all non-batch axes."""
    log_spec = 10.0 * torch.log(torch.clamp_min(x, amin)) / math.log(10.0)
    axes = tuple(range(1, x.dim()))
    log_spec = log_spec - torch.amax(log_spec, dim=axes, keepdim=True)
    return torch.clamp_min(log_spec, -dynamic_range)


def chunk_amplitude_to_db(x: torch.Tensor, amin: float = 1e-10
                          ) -> torch.Tensor:
    """Plain log10 without normalization — the streaming/causal variant."""
    return torch.log(torch.clamp_min(x, amin)) / math.log(10.0)


def _to_db(power: torch.Tensor, cfg: LogMelFrontendConfig) -> torch.Tensor:
    if cfg.padding == "valid":
        return chunk_amplitude_to_db(power)
    return amplitude_to_db(power, dynamic_range=cfg.dynamic_range_db)


def log_mel_spectrogram_reference(wav: torch.Tensor,
                                  cfg: LogMelFrontendConfig,
                                  mel_weights: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain torch [B, T] -> [B, n_frames, n_mels]: the plain power
    spectrum, the dB pass, then the mel matmul (K1b's plain version)."""
    fb = _device_mel(cfg, wav.device) if mel_weights is None else mel_weights
    return torch.matmul(_to_db(power_spectrogram_reference(wav, cfg), cfg),
                        fb)


# ---------------------------------------------------------------------------
# K1 and K1b as torch.library custom ops
# ---------------------------------------------------------------------------
#
# Each op takes the wav and the config's fields as plain numbers, so that
# ``torch.export`` records it as one node (``tasr::...``) that the exported
# program calls again when it runs: the CUDA implementation launches the
# kernel (today's launch, counted as before), the CPU one runs the plain
# version, and the fake one gives the output's shape. The kernels' tables are
# looked up per (config, device) inside the implementations, so no constant
# enters the graph.

def _op_cfg(sample_rate: int, n_fft: int, stride_ms: int, same: bool,
            n_mels: int = 80, fmin: float = 0.0,
            fmax: Optional[float] = None,
            dynamic_range: float = 80.0) -> LogMelFrontendConfig:
    return LogMelFrontendConfig(
        sample_rate=sample_rate, n_fft=n_fft, stride_ms=stride_ms,
        n_mels=n_mels, fmin=fmin, fmax=fmax,
        padding="same" if same else "valid", dynamic_range_db=dynamic_range)


def _op_args(cfg: LogMelFrontendConfig) -> tuple:
    return cfg.sample_rate, cfg.n_fft, cfg.stride_ms, cfg.padding == "same"


def _fake_frames(wav: torch.Tensor, sample_rate: int, stride_ms: int,
                 width) -> torch.Tensor:
    hop = sample_rate * stride_ms // 1000
    return wav.new_empty((wav.shape[0], -(-wav.shape[1] // hop), width),
                         dtype=torch.float32)


@torch.library.custom_op("tasr::power_spectrogram", mutates_args=(),
                         device_types="cpu")
def power_spectrogram_op(wav: torch.Tensor, sample_rate: int, n_fft: int,
                         stride_ms: int, same: bool) -> torch.Tensor:
    """wav [B, T] f32 -> power [B, ceil(T/hop), n_fft/2 + 1]: K1 on the
    card, the plain version on the CPU."""
    return power_spectrogram_reference(
        wav, _op_cfg(sample_rate, n_fft, stride_ms, same))


@power_spectrogram_op.register_kernel("cuda")
def _power_cuda(wav, sample_rate, n_fft, stride_ms, same):
    cfg = _op_cfg(sample_rate, n_fft, stride_ms, same)
    return k1.power_spectrogram_cuda(
        wav, _kernel_tables(cfg, wav.device), cfg.hop,
        _left_pad(wav.shape[1], cfg))


@power_spectrogram_op.register_fake
def _power_fake(wav, sample_rate, n_fft, stride_ms, same):
    return _fake_frames(wav, sample_rate, stride_ms, n_fft // 2 + 1)


@torch.library.custom_op("tasr::log_mel_spectrogram", mutates_args=(),
                         device_types="cpu")
def log_mel_spectrogram_op(wav: torch.Tensor, sample_rate: int, n_fft: int,
                           stride_ms: int, same: bool, n_mels: int,
                           fmin: float, fmax: Optional[float],
                           dynamic_range: float) -> torch.Tensor:
    """wav [B, T] f32 -> log-mel [B, ceil(T/hop), n_mels] with the fixed
    Slaney basis: K1b on the card, the plain version on the CPU."""
    return log_mel_spectrogram_reference(wav, _op_cfg(
        sample_rate, n_fft, stride_ms, same, n_mels, fmin, fmax,
        dynamic_range))


@log_mel_spectrogram_op.register_kernel("cuda")
def _log_mel_cuda(wav, sample_rate, n_fft, stride_ms, same, n_mels, fmin,
                  fmax, dynamic_range):
    cfg = _op_cfg(sample_rate, n_fft, stride_ms, same, n_mels, fmin, fmax,
                  dynamic_range)
    sched, weights = _kernel_bands(cfg, wav.device)
    return k1b.log_mel_spectrogram_cuda(
        wav, _kernel_tables(cfg, wav.device), weights, n_mels, cfg.hop,
        _left_pad(wav.shape[1], cfg), sched=sched, same=same,
        dynamic_range=dynamic_range)


@log_mel_spectrogram_op.register_fake
def _log_mel_fake(wav, sample_rate, n_fft, stride_ms, same, n_mels, fmin,
                  fmax, dynamic_range):
    return _fake_frames(wav, sample_rate, stride_ms, n_mels)


@torch.library.custom_op("tasr::log_mel_spectrogram_weights",
                         mutates_args=(), device_types="cpu")
def log_mel_spectrogram_weights_op(wav: torch.Tensor,
                                   mel_weights: torch.Tensor,
                                   sample_rate: int, n_fft: int,
                                   stride_ms: int, same: bool,
                                   dynamic_range: float) -> torch.Tensor:
    """wav [B, T] f32, mel_weights [n_fft/2 + 1, n_mels] f32 -> log-mel by
    that matrix: K1b's given-matrix path (K1, then the dense product
    kernel) on the card, the plain version on the CPU."""
    cfg = _op_cfg(sample_rate, n_fft, stride_ms, same, mel_weights.shape[1],
                  dynamic_range=dynamic_range)
    return log_mel_spectrogram_reference(wav, cfg, mel_weights)


@log_mel_spectrogram_weights_op.register_kernel("cuda")
def _log_mel_weights_cuda(wav, mel_weights, sample_rate, n_fft, stride_ms,
                          same, dynamic_range):
    cfg = _op_cfg(sample_rate, n_fft, stride_ms, same, mel_weights.shape[1],
                  dynamic_range=dynamic_range)
    return k1b.log_mel_spectrogram_cuda(
        wav, _kernel_tables(cfg, wav.device), mel_weights, cfg.n_mels,
        cfg.hop, _left_pad(wav.shape[1], cfg), same=same,
        dynamic_range=dynamic_range)


@log_mel_spectrogram_weights_op.register_fake
def _log_mel_weights_fake(wav, mel_weights, sample_rate, n_fft, stride_ms,
                          same, dynamic_range):
    return _fake_frames(wav, sample_rate, stride_ms, mel_weights.shape[1])


def _log_mel_weights_setup(ctx, inputs, output):
    wav, mel_weights, sample_rate, n_fft, stride_ms, same, dr = inputs
    ctx.save_for_backward(wav)
    ctx.cfg = _op_cfg(sample_rate, n_fft, stride_ms, same,
                      mel_weights.shape[1], dynamic_range=dr)


def _log_mel_weights_backward(ctx, grad):
    """The gradient reaches the matrix only (the wav carries none, as on
    every path of the frontend). It rebuilds the dB spectrum with the power
    op (K1 on the card) and the plain dB pass instead of keeping it from
    the forward (at B = 128 x 8 s that is 210 MB not held across the step),
    then ``grad_W = db^T grad`` by ``torch.matmul``."""
    (wav,), cfg = ctx.saved_tensors, ctx.cfg
    db = _to_db(power_spectrogram(wav, cfg), cfg)
    grad_w = torch.matmul(db.reshape(-1, cfg.n_freq).t(),
                          grad.reshape(-1, cfg.n_mels))
    return None, grad_w, None, None, None, None, None


log_mel_spectrogram_weights_op.register_autograd(
    _log_mel_weights_backward, setup_context=_log_mel_weights_setup)


def _check_device(wav: torch.Tensor, what: str) -> None:
    if wav.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {wav.device}")


def log_mel_spectrogram(wav: torch.Tensor, cfg: LogMelFrontendConfig,
                        mel_weights: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """[B, T] -> [B, n_frames, n_mels] log-mel features (dB on the power
    spectrum first, then the mel matmul). ``mel_weights`` [n_freq, n_mels]
    overrides the fixed Slaney basis (the trainable filterbank). Through
    the ``tasr::`` ops: K1b for a CUDA tensor, the plain version for a CPU
    tensor."""
    _check_device(wav, "log_mel_spectrogram")
    wav = wav.to(torch.float32).contiguous()
    if mel_weights is None:
        return log_mel_spectrogram_op(wav, *_op_args(cfg), cfg.n_mels,
                                      cfg.fmin, cfg.fmax,
                                      cfg.dynamic_range_db)
    if tuple(mel_weights.shape) != (cfg.n_freq, cfg.n_mels):
        raise ValueError(f"mel_weights must be [{cfg.n_freq}, "
                         f"{cfg.n_mels}], got {tuple(mel_weights.shape)}")
    return log_mel_spectrogram_weights_op(
        wav, mel_weights.to(torch.float32).contiguous(), *_op_args(cfg),
        cfg.dynamic_range_db)


def spectrogram_feature(wav: torch.Tensor, cfg: LogMelFrontendConfig
                        ) -> torch.Tensor:
    """Plain (non-mel) dB spectrogram feature (``mel_layer_type:
    Spectrogram``)."""
    return _to_db(power_spectrogram(wav, cfg), cfg)
