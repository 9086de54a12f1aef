"""K1: framed, windowed-DFT power spectrogram on Hopper, beside its plain
PyTorch version.

Replaces ``tensorflowasr_tpu/ops/pallas_frontend.py::power_spectrogram_pallas``
(the repo's one Pallas kernel). wav [B, T] f32 -> power [B, ceil(T/hop),
n_freq] f32, with the 'same' / 'valid' padding given as the left pad ``lo``.

Bound on an H100: bytes. The function reads the wav once and writes the
power once, ~4 * (B*T + B*F*n_freq) bytes; at the serving shape (B = 128 x
7 s) that is ~241 MB, ~72 us at 3.35 TB/s, and a real FFT per frame needs
only ~2.5e9 FLOP (~38 us at 67 TFLOP/s f32). The kernel's DFT-as-GEMM form
does 2 * B * F * n_fft * 2 * n_freq = 1.88e11 FLOP, ~2.8 ms at the f32 FMA
rate: that is its design target, not the function's bound. The kernel
(``csrc/power_spectrogram.cu``) keeps f32 FMA accumulation so it holds the
f32 reference's tolerance, frames the signal inside the kernel from a
shared-memory slab of hop rows (no [B, F, n_fft] frames tensor), and writes
re^2 + im^2 straight to the output. Its design notes are in the source.

``power_spectrogram_plain`` is the plain version: the CPU path runs it, and
``chip_smoke.py`` holds the kernel against it on the card.
``power_spectrogram_cuda`` launches the kernel; it takes CUDA tensors only
and never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.kernels import build

# tile sizes of csrc/power_spectrogram.cu (checked against the library)
BLOCK_BINS = 64
BLOCK_K = 32
MAX_SMEM_BYTES = 232448           # per block on sm_90 (227 KB)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library (built at first use), its C signatures set."""
    lib = build.load("power_spectrogram")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tasr_power_spectrogram.argtypes = [p, p, p] + [i] * 9 + [p]
    lib.tasr_power_spectrogram.restype = i
    lib.tasr_power_spectrogram_smem_bytes.argtypes = [i, i]
    lib.tasr_power_spectrogram_smem_bytes.restype = ctypes.c_longlong
    lib.tasr_cuda_error_string.argtypes = [i]
    lib.tasr_cuda_error_string.restype = ctypes.c_char_p
    for fn, want in (("tasr_power_spectrogram_block_bins", BLOCK_BINS),
                     ("tasr_power_spectrogram_block_k", BLOCK_K)):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i
        if getattr(lib, fn)() != want:
            raise RuntimeError(f"{fn}() != {want}: library and wrapper "
                               f"disagree on the tile size")
    return lib


def num_frames(t: int, hop: int) -> int:
    return -(-t // hop)


def power_spectrogram_plain(wav: torch.Tensor, dft: torch.Tensor, hop: int,
                            lo: int) -> torch.Tensor:
    """wav [B, T] f32, dft [n_fft, 2*n_freq] (re | im) -> [B, F, n_freq].

    Frames start at ``f * hop - lo`` in wav coordinates; samples outside
    [0, T) are zero."""
    n_fft, n_freq = dft.shape[0], dft.shape[1] // 2
    b, t = wav.shape
    n_frames = num_frames(t, hop)
    total = (n_frames - 1) * hop + n_fft
    wavp = F.pad(wav, (lo, max(0, total - lo - t)))
    frames = wavp.unfold(1, n_fft, hop)[:, :n_frames]     # [B, F, n_fft]
    spec = torch.matmul(frames, dft)
    re, im = spec[..., :n_freq], spec[..., n_freq:]
    return re * re + im * im


def tile_dft(padded_dft: np.ndarray, hop: int) -> np.ndarray:
    """[C*hop, 2*n_freq] DFT (zero rows past n_fft) -> the kernel's operand
    [C*hop_pad, 2, n_freq_pad]: hop rows padded to a multiple of BLOCK_K,
    re and im split, bins padded to a multiple of BLOCK_BINS, zeros in
    every pad."""
    rows, cols = padded_dft.shape
    n_chunks, n_freq = rows // hop, cols // 2
    hop_pad = -(-hop // BLOCK_K) * BLOCK_K
    n_freq_pad = -(-n_freq // BLOCK_BINS) * BLOCK_BINS
    out = np.zeros((n_chunks, hop_pad, 2, n_freq_pad), np.float32)
    out[:, :hop, :, :n_freq] = padded_dft.reshape(n_chunks, hop, 2, n_freq)
    return out.reshape(n_chunks * hop_pad, 2, n_freq_pad)


def power_spectrogram_cuda(wav: torch.Tensor, kernel_dft: torch.Tensor,
                           n_freq: int, hop: int, lo: int) -> torch.Tensor:
    """Launch K1 on ``wav``'s current stream. ``kernel_dft`` is
    :func:`tile_dft`'s operand on the same device."""
    if wav.device.type != "cuda":
        raise ValueError(f"power_spectrogram_cuda needs a CUDA tensor, got "
                         f"{wav.device}")
    if wav.dtype != torch.float32 or wav.dim() != 2 \
            or not wav.is_contiguous():
        raise ValueError(f"wav must be contiguous float32 [B, T], got "
                         f"{wav.dtype} {tuple(wav.shape)}")
    if kernel_dft.device != wav.device or kernel_dft.dtype != torch.float32 \
            or kernel_dft.dim() != 3 or not kernel_dft.is_contiguous():
        raise ValueError("kernel_dft must be a contiguous float32 "
                         "[C*hop_pad, 2, n_freq_pad] tensor on wav's device")
    hop_pad = -(-hop // BLOCK_K) * BLOCK_K
    rows, two, n_freq_pad = kernel_dft.shape
    if two != 2 or rows % hop_pad or n_freq_pad % BLOCK_BINS \
            or n_freq_pad < n_freq:
        raise ValueError(f"kernel_dft shape {tuple(kernel_dft.shape)} does "
                         f"not fit hop {hop} / n_freq {n_freq}")
    n_chunks = rows // hop_pad
    b, t = wav.shape
    if b == 0 or t == 0 or b > 65535:
        raise ValueError(f"batch {b} x {t} samples is outside the kernel's "
                         f"range (1..65535 rows, >= 1 sample)")
    lib = _library()
    smem = lib.tasr_power_spectrogram_smem_bytes(hop_pad, n_chunks)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"hop {hop} needs {smem} B of shared memory per "
                         f"block (> {MAX_SMEM_BYTES})")
    n_frames = num_frames(t, hop)
    out = torch.empty((b, n_frames, n_freq), dtype=torch.float32,
                      device=wav.device)
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        rc = lib.tasr_power_spectrogram(
            wav.data_ptr(), kernel_dft.data_ptr(), out.data_ptr(), b, t, hop,
            hop_pad, n_chunks, lo, n_frames, n_freq, n_freq_pad, stream)
    if rc != 0:
        raise RuntimeError(f"power_spectrogram kernel launch failed: "
                           f"{lib.tasr_cuda_error_string(rc).decode()}")
    power_spectrogram_cuda.launches += 1
    return out


power_spectrogram_cuda.launches = 0
