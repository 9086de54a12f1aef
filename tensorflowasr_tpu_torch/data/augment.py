"""Waveform augmentation registry (host side, numpy/scipy only).

Counterpart of ``tensorflowasr_tpu/data/augment.py``:

- noise      additive file noise at a random SNR
- masking    random sample dropout (optionally replaced by noise) in a
             center zone
- pitch      pitch shift of a center zone: phase-vocoder time-stretch +
             polyphase resample
- speed      time stretch (phase vocoder)
- hz         3rd-order butterworth bandstop at a random band + dither
- spec_aug   STFT-domain hole masking via scipy stft/istft
- rir        room reverb; the optional ``rir_generator`` package when
             installed, else a synthetic impulse response
- vc         ONNX voice conversion: not ported yet, raises

``Augmentation.process`` picks ONE random active augmenter, then
int16-quantizes. Every draw comes from the two generators the
``Augmentation`` owns, a ``random.Random`` and a ``numpy.random.RandomState``
made from its seed (the JAX package draws the same calls from the ``random``
and ``numpy.random`` modules, so seeding those with the same number gives
the same waveforms); nothing here touches the module-level generators.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np
from scipy import signal as sps

from tensorflowasr_tpu_torch.utils.audio import read_wav, resample


def stft(wav: np.ndarray, n_fft: int = 1024, win_length: int = 800,
         hop_length: int = 160) -> np.ndarray:
    """Centered STFT [n_fft//2+1, frames] (librosa layout)."""
    pad = n_fft // 2
    x = np.pad(wav, (pad, pad), mode="reflect")
    win = np.hanning(win_length + 1)[:-1].astype(np.float32)
    win = np.pad(win, ((n_fft - win_length) // 2,
                       n_fft - win_length - (n_fft - win_length) // 2))
    n_frames = 1 + (len(x) - n_fft) // hop_length
    frames = np.lib.stride_tricks.as_strided(
        x, shape=(n_frames, n_fft),
        strides=(x.strides[0] * hop_length, x.strides[0])).copy()
    # scipy.fft keeps float32 (np.fft always promotes to float64 — the
    # promotion made spec-aug the host loader's hottest op, ~16x slower)
    import scipy.fft as sfft

    return sfft.rfft(
        (frames * win[None, :]).astype(np.float32), axis=1).T


def istft(spec: np.ndarray, n_fft: int = 1024, win_length: int = 800,
          hop_length: int = 160, length: Optional[int] = None) -> np.ndarray:
    """Inverse of :func:`stft` with overlap-add + window-square norm."""
    win = np.hanning(win_length + 1)[:-1].astype(np.float32)
    win = np.pad(win, ((n_fft - win_length) // 2,
                       n_fft - win_length - (n_fft - win_length) // 2))
    import scipy.fft as sfft

    frames = sfft.irfft(spec.T.astype(np.complex64), n=n_fft, axis=1)
    n_frames = frames.shape[0]
    out_len = n_fft + hop_length * (n_frames - 1)
    out = np.zeros(out_len, np.float32)
    norm = np.zeros(out_len, np.float32)
    for i in range(n_frames):
        s = i * hop_length
        out[s:s + n_fft] += frames[i] * win
        norm[s:s + n_fft] += win * win
    out = out / np.maximum(norm, 1e-8)
    pad = n_fft // 2
    out = out[pad:-pad] if out_len > 2 * pad else out
    if length is not None:
        out = np.pad(out[:length], (0, max(0, length - len(out))))
    return out


def phase_vocoder_stretch(wav: np.ndarray, rate: float,
                          n_fft: int = 2048, hop: int = 512) -> np.ndarray:
    """Time-stretch by ``rate`` (>1 shorter/faster) with a phase vocoder —
    the algorithm behind librosa.effects.time_stretch."""
    if abs(rate - 1.0) < 1e-6 or len(wav) < n_fft:
        return wav.copy()
    spec = stft(wav, n_fft=n_fft, win_length=n_fft, hop_length=hop)
    n_bins, n_frames = spec.shape
    steps = np.arange(0, n_frames, rate)
    phi_advance = np.linspace(0, np.pi * hop, n_bins)
    out = np.zeros((n_bins, len(steps)), dtype=np.complex128)
    phase_acc = np.angle(spec[:, 0])
    for t, step in enumerate(steps):
        i = int(step)
        frac = step - i
        cols = spec[:, i:i + 2]
        if cols.shape[1] < 2:
            cols = np.pad(cols, ((0, 0), (0, 2 - cols.shape[1])))
        mag = (1 - frac) * np.abs(cols[:, 0]) + frac * np.abs(cols[:, 1])
        out[:, t] = mag * np.exp(1j * phase_acc)
        dphase = np.angle(cols[:, 1]) - np.angle(cols[:, 0]) - phi_advance
        dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc += phi_advance + dphase
    n_out = int(round(len(wav) / rate))
    return istft(out, n_fft=n_fft, win_length=n_fft, hop_length=hop,
                 length=n_out).astype(np.float32)


def pitch_shift(wav: np.ndarray, sr: int, n_steps: float) -> np.ndarray:
    """Pitch shift by ``n_steps`` semitones, preserving duration
    (librosa.effects.pitch_shift semantics: time-stretch by
    rate = 2^(-n/12), then resample sr/rate -> sr)."""
    rate = 2.0 ** (-n_steps / 12.0)
    # phase_vocoder_stretch(wav, rate) -> ~len/rate samples
    stretched = phase_vocoder_stretch(wav, rate)
    shifted = resample(stretched, int(sr / rate), sr)
    if len(shifted) < len(wav):
        shifted = np.pad(shifted, (0, len(wav) - len(shifted)))
    return shifted[:len(wav)]


class _Augmenter:
    """An augmenter's draws come from ``rng`` and ``np_rng``, which the
    :class:`Augmentation` that builds it sets."""

    rng: random.Random
    np_rng: np.random.RandomState


class SignalSpecAug(_Augmenter):
    def __init__(self, window: int = 10, ratio: float = 0.5):
        self.window = int(window)
        self.ratio = float(ratio)

    def augment(self, wav: np.ndarray) -> np.ndarray:
        spec = stft(wav)
        h, w = spec.shape
        nums = int(w * self.ratio)
        ws = self.rng.sample(range(w), min(nums, w))
        hs = self.rng.sample(range(h), min(nums, h))
        for h_, w_ in zip(hs, ws):
            spec[max(h_ - self.window, 0):h_ + self.window,
                 max(w_ - self.window, 0):w_ + self.window] *= 0.0
        return istft(spec, length=len(wav))


class SignalMask(_Augmenter):
    def __init__(self, zone=(0.1, 0.9), mask_ratio: float = 0.3,
                 mask_with_noise: bool = True):
        self.zone = eval(zone) if isinstance(zone, str) else tuple(zone)
        self.mask_ratio = float(mask_ratio)
        self.mask_with_noise = bool(mask_with_noise)

    def augment(self, data: np.ndarray) -> np.ndarray:
        data = data.copy()
        s = int(len(data) * self.zone[0])
        e = int(len(data) * self.zone[1])
        seg = data[s:e]
        mask_value = self.np_rng.random(len(seg))
        mask = np.where(mask_value < self.mask_ratio, 0.0, 1.0)
        seg = seg * mask
        if self.mask_with_noise:
            seg = seg + mask_value * (1.0 - mask)
        data[s:e] = seg
        return data


class SignalNoise(_Augmenter):
    def __init__(self, sample_rate: int = 16000, SNR=(-10, 10),
                 noises: str = ""):
        with open(noises) as f:
            self.noises = [line.strip() for line in f if line.strip()]
        self.SNR = tuple(SNR) if not isinstance(SNR, str) else eval(SNR)
        self.sample_rate = sample_rate

    @staticmethod
    def add_noise(x: np.ndarray, d: np.ndarray, snr_db: float) -> np.ndarray:
        p_signal = np.sum(np.abs(x) ** 2)
        p_d = np.sum(np.abs(d) ** 2) + 1e-12
        p_noise = p_signal / 10 ** (snr_db / 10)
        noise = np.sqrt(p_noise / p_d) * d
        return x + noise[:len(x)]

    def augment(self, data: np.ndarray) -> np.ndarray:
        path = self.noises[self.np_rng.randint(0, len(self.noises))]
        n_wav, _ = read_wav(path, target_sr=self.sample_rate)
        while len(data) + 20 > len(n_wav):
            n_wav = np.hstack((n_wav, n_wav))
        start = self.np_rng.randint(0, len(n_wav) - len(data) - 10)
        snr = self.np_rng.randint(self.SNR[0], self.SNR[1])
        return self.add_noise(data, n_wav[start:start + len(data)], snr)


class SignalPitch(_Augmenter):
    def __init__(self, zone=(0.2, 0.8), sample_rate: int = 16000,
                 factor=(-1, 5)):
        self.zone = eval(zone) if isinstance(zone, str) else tuple(zone)
        self.factor = eval(factor) if isinstance(factor, str) \
            else tuple(factor)
        self.sr = sample_rate

    def augment(self, data: np.ndarray) -> np.ndarray:
        data = data.copy()
        s = int(len(data) * self.zone[0])
        e = int(len(data) * self.zone[1])
        scale = self.factor[1] - self.factor[0]
        steps = self.np_rng.random() * scale - scale / 2
        data[s:e] = pitch_shift(data[s:e], self.sr, steps)
        return data


class SignalSpeed(_Augmenter):
    def __init__(self, factor=(0.5, 2)):
        self.factor = eval(factor) if isinstance(factor, str) \
            else tuple(factor)

    def augment(self, data: np.ndarray) -> np.ndarray:
        rate = np.clip(self.np_rng.random() * self.factor[1],
                       self.factor[0], self.factor[1])
        return phase_vocoder_stretch(data, float(rate))


class SignalHz(_Augmenter):
    def augment(self, data: np.ndarray) -> np.ndarray:
        start = float(np.clip(self.np_rng.random(), 0.01, 0.699))
        b, a = sps.butter(3, [start, start + 0.3], "bandstop")
        out = sps.filtfilt(b, a, data)
        return out + self.np_rng.random(out.shape) * 0.001


class SignalRIR(_Augmenter):
    """Room reverb. Uses the optional ``rir_generator`` (image method)
    when installed; otherwise synthesizes its own impulse response —
    sparse early reflections plus an exponentially-decaying diffuse tail
    (the textbook RIR shape) — so the reverb augmenter always works and
    is exercised in CI without the optional dependency."""

    def __init__(self, sample_rate: int,
                 reverberation_time: float = 0.4, nsample: int = 4096):
        try:
            import rir_generator  # type: ignore
            self.rir = rir_generator
        except ImportError:
            self.rir = None
        self.sp = sample_rate
        self.rt = reverberation_time
        self.nsample = nsample

    def _pos(self, x, y, z):
        return [self.rng.randrange(x * 10) / 10.0,
                self.rng.randrange(y * 10) / 10.0,
                self.rng.randrange(z * 10) / 10.0]

    def _impulse_response(self) -> np.ndarray:
        if self.rir is not None:
            h = self.rir.generate(c=340, fs=self.sp, r=self._pos(5, 4, 6),
                                  s=self._pos(5, 4, 6), L=[5, 4, 6],
                                  reverberation_time=self.rt,
                                  nsample=self.nsample)
            return np.asarray(h, np.float32).mean(axis=1)
        # synthetic: direct path + a handful of early reflections at
        # random small delays, then diffuse noise under a T60 envelope
        n = self.nsample
        h = np.zeros(n, np.float32)
        h[0] = 1.0
        for _ in range(8):
            d = self.rng.randrange(int(0.005 * self.sp),
                                 int(0.08 * self.sp))
            h[min(d, n - 1)] += self.rng.uniform(0.1, 0.5) * \
                (1 if self.rng.random() < 0.5 else -1)
        decay = np.exp(-6.908 * np.arange(n) / (self.rt * self.sp))
        h += 0.25 * self.np_rng.randn(n).astype(np.float32) * decay
        return h

    def augment(self, wav: np.ndarray) -> np.ndarray:
        h = self._impulse_response()
        out = sps.fftconvolve(np.asarray(wav, np.float32), h)[:len(wav)]
        # keep the original peak so the int16 quantize step doesn't clip
        peak_in = np.abs(wav).max() or 1.0
        peak_out = np.abs(out).max() or 1.0
        return (out * (peak_in / peak_out)).astype(np.float32)


class SignalVC:
    """ONNX voice conversion (``data/tts_augment.py`` of the JAX package):
    not ported yet."""

    def __init__(self, model_path: Optional[str] = None):
        raise NotImplementedError(
            "the 'vc' augmenter (ONNX voice conversion) is not ported yet")


AUGMENTATIONS = {
    "noise": SignalNoise,
    "masking": SignalMask,
    "pitch": SignalPitch,
    "speed": SignalSpeed,
    "hz": SignalHz,
    "rir": SignalRIR,
    "vc": SignalVC,
    "spec_aug": SignalSpecAug,
}


class Augmentation:
    """Config-driven registry: each active entry becomes an augmenter;
    ``process`` applies ONE randomly chosen augmenter + int16 quantization."""

    def __init__(self, config: Optional[Dict] = None, seed: int = 0):
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.augmentations: List = []
        for key, value in (config or {}).items():
            if key == "aug_ratio":
                # a loader-side knob some data YAMLs carry inside
                # augments_config; the loaders use a fixed 25 % draw, so
                # the key is accepted and unused
                continue
            cls = AUGMENTATIONS.get(key)
            if cls is None:
                raise KeyError(
                    f"No augmentation named: {key}. "
                    f"Available: {sorted(AUGMENTATIONS)}")
            value = dict(value)
            if value.pop("active", False):
                aug = cls(**value)
                aug.rng, aug.np_rng = self.rng, self.np_rng
                self.augmentations.append(aug)

    def available(self) -> bool:
        return len(self.augmentations) > 0

    def process(self, wav: np.ndarray) -> np.ndarray:
        aug = self.rng.sample(self.augmentations, 1)[0]
        data = aug.augment(np.asarray(wav, np.float32))
        return (np.asarray(np.clip(data, -1.0, 1.0) * 32768, "int32")
                / 32768.0).astype(np.float32)
