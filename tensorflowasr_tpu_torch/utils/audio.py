"""Host-side waveform IO and padding (numpy + scipy only).

Counterpart of ``read_wav`` / ``read_pcm16`` / ``write_wav`` /
``resample`` and ``SpeechFeaturizer.load_wav`` / ``pad_signal`` in
``tensorflowasr_tpu.utils.audio``: load a wav at a target sample rate
(resampling if needed), convert it or raw PCM16 bytes to float32 in
[-1, 1], write PCM16, and pad
signals so the frame math of the frontend works out.
"""

from __future__ import annotations

import io
import wave
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile as _wavfile
from scipy.signal import resample_poly


def _to_float32(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.float32:
        return data
    if data.dtype == np.float64:
        return data.astype(np.float32)
    if data.dtype == np.int16:
        return (data / 32768.0).astype(np.float32)
    if data.dtype == np.int32:
        return (data / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return ((data.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
    return data.astype(np.float32)


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    g = np.gcd(int(orig_sr), int(target_sr))
    return resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


def read_wav(path_or_bytes, target_sr: Optional[int] = None,
             mono: bool = True) -> Tuple[np.ndarray, int]:
    """Read a wav file (path, file-like, or raw bytes) -> (float32 wav, sr)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        sr, data = _wavfile.read(io.BytesIO(bytes(path_or_bytes)))
    else:
        sr, data = _wavfile.read(path_or_bytes)
    data = _to_float32(np.asarray(data))
    if mono and data.ndim > 1:
        data = data.mean(axis=-1)
    if target_sr is not None and sr != target_sr:
        data = resample(data, sr, target_sr)
        sr = target_sr
    return np.ascontiguousarray(data, dtype=np.float32), sr


def read_pcm16(raw: bytes) -> np.ndarray:
    """Raw little-endian PCM16 bytes -> float32 waveform in [-1, 1]."""
    return (np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0)


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Float waveform in [-1, 1] -> mono PCM16 wav file."""
    pcm = np.clip(wav * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


class SpeechFeaturizer:
    """Frame math + signal padding helper for the frontend."""

    def __init__(self, speech_config: dict):
        self.sample_rate = int(speech_config.get("sample_rate", 16000))
        self.stride_ms = int(speech_config.get("stride_ms", 10))
        self.hop_size = self.sample_rate * self.stride_ms // 1000
        self.reduction_factor = int(speech_config.get("reduction_factor", 4))

    def load_wav(self, path) -> np.ndarray:
        wav, _ = read_wav(path, target_sr=self.sample_rate)
        return wav

    def pad_signal(self, wav: np.ndarray, max_length: Optional[int] = None
                   ) -> np.ndarray:
        """Right-pad with zeros to ``max_length`` samples (multiple of the
        hop * reduction_factor so subsampled lengths are exact)."""
        if max_length is None:
            quantum = self.hop_size * self.reduction_factor
            max_length = int(np.ceil(len(wav) / quantum)) * quantum
        if len(wav) >= max_length:
            return wav[:max_length]
        return np.pad(wav, (0, max_length - len(wav)))
