"""K1: framed, Hann-windowed power spectrogram on Hopper, one real FFT per
frame in shared memory, beside its plain PyTorch version.

Replaces ``tensorflowasr_tpu/ops/pallas_frontend.py::power_spectrogram_pallas``
(the repo's one Pallas kernel). wav [B, T] f32 -> power [B, ceil(T/hop),
n_fft/2 + 1] f32, with the 'same' / 'valid' padding given as the left pad
``lo``.

Bound on an H100: bytes. The function reads the wav once and writes the
power once, 4 * (B*T + B*F*n_freq) bytes; at the serving shape (B = 128 x
7 s) that is 2.41e8 B, 0.072 ms at 3.35 TB/s, and a real FFT per frame needs
only 2.5e9 FLOP (0.038 ms at 67 TFLOP/s f32). So the kernel
(``csrc/power_spectrogram.cu``) moves nothing but those bytes through device
memory: a block stages the slab of samples under its tile of frames in
shared memory once (``cp.async``, zeros for the virtual pads), 64 threads
transform each frame as a 512-point complex FFT of the packed, windowed
samples (three radix-8 passes in registers, two exchanges through shared
memory), untangle it to the 513 bins of the real transform, square, and
write each bin once. Its design notes are in the source.

The same kernel carries K1b's log-mel epilogues
(``ops/log_mel_spectrogram.py``); :func:`launch` starts it with any epilogue.
The host side here builds the
kernel's one table (window, twiddles, untangle factors: numpy float64,
rounded to f32 once) and chooses each launch's tile and slab-copy width
(:func:`launch_plan`).

``power_spectrogram_plain`` is the plain version: the CPU path runs it, and
``chip_smoke.py`` holds the kernel against it on the card.
``power_spectrogram_cuda`` launches the kernel; it takes CUDA tensors only
and never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.kernels import build

# layout of csrc/power_spectrogram.cu (checked against the library)
N_FFT = 1024                      # the one size the kernel is built for
FRAME_THREADS = 64                # threads per frame; 8 complex values each
EX1_STRIDE = 72                   # float2 row stride of the first exchange
EX2_STRIDE = 66                   # ... of the second
BUF_FLOAT2 = 8 * EX1_STRIDE       # one exchange buffer
# window | tw1 | tw2 | untangle, see fft_tables
TABLE_FLOATS = N_FFT + N_FFT + 2 * 64 + 2 * (N_FFT // 4 + 1)
MAX_SMEM_BYTES = 232448           # per block on sm_90 (227 KB)
# (tile_frames, groups) from the largest tile down; see launch_plan
TILE_LADDER = ((32, 4), (16, 4), (8, 4), (4, 4), (2, 2), (1, 1))
STAGE_FRAMES = 8                  # frames a block needs to stage mel weights


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel library (built at first use), its C signatures set."""
    lib = build.load("power_spectrogram")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tasr_frontend.argtypes = [i] + [p] * 7 + [i] * 11 + [f, f, p]
    lib.tasr_frontend.restype = i
    lib.tasr_dense_mel.argtypes = [p] * 4 + [i] * 3 + [f, f, p]
    lib.tasr_dense_mel.restype = i
    lib.tasr_power_spectrogram_smem_bytes.argtypes = [i, i, i, i]
    lib.tasr_power_spectrogram_smem_bytes.restype = ctypes.c_longlong
    lib.tasr_cuda_error_string.argtypes = [i]
    lib.tasr_cuda_error_string.restype = ctypes.c_char_p
    for fn, want in (("tasr_power_spectrogram_n_fft", N_FFT),
                     ("tasr_power_spectrogram_table_floats", TABLE_FLOATS)):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = i
        if getattr(lib, fn)() != want:
            raise RuntimeError(f"{fn}() != {want}: library and wrapper "
                               f"disagree on the kernel's layout")
    for args in ((160, 32, 4, 0), (81, 2, 2, 2752)):
        if lib.tasr_power_spectrogram_smem_bytes(*args) != smem_bytes(*args):
            raise RuntimeError("library and wrapper disagree on the "
                               "kernel's shared memory")
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


# ---------------------------------------------------------------------------
# Host-built tables
# ---------------------------------------------------------------------------

def fft_tables(window: np.ndarray) -> Dict[str, np.ndarray]:
    """The kernel's constants for a window of n_fft points, computed in
    float64 and rounded to f32 once. Complex entries are (re, im) pairs.

    - ``window`` [n_fft]: sample n of the frame is scaled by window[n]; the
      complex FFT's input m is (xw[2m], xw[2m+1]).
    - ``tw1`` [8, 64, 2]: e^{-2 pi i t k1 / M}, M = n_fft/2, after pass 1.
    - ``tw2`` [8, 8, 2]: e^{-2 pi i t2 k2 / 64}, indexed [k2, t2], after
      pass 2.
    - ``untangle`` [M/2 + 1, 2]: u[k] = -i e^{-2 pi i k / n_fft}; with
      A = Z[k] + conj Z[M-k], D = Z[k] - conj Z[M-k]: X[k] = (A + u D)/2,
      X[M-k] = conj(A - u D)/2.
    """
    n_fft = int(window.shape[0])
    if n_fft < 2 or n_fft & (n_fft - 1):
        raise ValueError(f"the K1 kernel takes a power-of-two n_fft, got "
                         f"{n_fft}")
    if n_fft != N_FFT:
        raise ValueError(f"the K1 kernel is built for n_fft {N_FFT} only, "
                         f"got {n_fft}")
    half = n_fft // 2

    def pairs(z: np.ndarray) -> np.ndarray:
        return np.stack([z.real, z.imag], axis=-1).astype(np.float32)

    k8 = np.arange(8, dtype=np.float64)[:, None]
    tw1 = np.exp(-2j * np.pi * k8 * np.arange(half // 8)[None, :] / half)
    tw2 = np.exp(-2j * np.pi * k8 * np.arange(8)[None, :] / 64.0)
    ut = -1j * np.exp(-2j * np.pi * np.arange(half // 2 + 1) / n_fft)
    return {"window": np.asarray(window, np.float64).astype(np.float32),
            "tw1": pairs(tw1), "tw2": pairs(tw2), "untangle": pairs(ut)}


def pack_tables(window: np.ndarray) -> np.ndarray:
    """:func:`fft_tables` as the one flat f32 array the kernel reads:
    window | tw1 | tw2 | untangle."""
    tables = fft_tables(window)
    flat = np.concatenate([tables[name].reshape(-1) for name in
                           ("window", "tw1", "tw2", "untangle")])
    assert flat.shape == (TABLE_FLOATS,)
    return flat


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------

class LaunchPlan(NamedTuple):
    tile_frames: int      # consecutive frames one block owns
    groups: int           # frames in flight per block (64 threads each)
    vec16: bool           # 16-byte slab copies (else 4-byte)


def smem_bytes(hop: int, tile_frames: int, groups: int,
               w_smem: int = 0) -> int:
    """Shared memory of one block: the slab, two exchange buffers a frame
    in flight, then ``w_smem`` floats of staged mel weights."""
    slab = (tile_frames - 1) * hop + N_FFT
    return -(-slab // 4) * 16 + groups * 2 * BUF_FLOAT2 * 8 + 4 * w_smem


def launch_plan(batch: int, t: int, hop: int, lo: int, sm_count: int,
                base_aligned: bool = True, w_smem: int = 0) -> LaunchPlan:
    """Tile and copy width for one launch.

    The tile is the largest of ``TILE_LADDER`` that fits shared memory and
    still gives two blocks per SM, so that a single short request does not
    run on a handful of blocks; failing that, one frame per 64-thread block.
    16-byte copies need every slab start ``f0*hop - lo`` and the row stride
    ``t`` to be multiples of 4 samples, and the base pointer 16-byte
    aligned."""
    n_frames = num_frames(t, hop)
    fits = [(tile, groups) for tile, groups in TILE_LADDER
            if smem_bytes(hop, tile, groups, w_smem) <= MAX_SMEM_BYTES]
    tile, groups = next(
        ((tile, groups) for tile, groups in fits
         if batch * num_frames(n_frames, tile) >= 2 * sm_count), fits[-1])
    vec16 = (base_aligned and t % 4 == 0 and lo % 4 == 0
             and (tile * hop) % 4 == 0)
    return LaunchPlan(tile, groups, vec16)


# the kernel's compile-time epilogues (csrc/power_spectrogram.cu::Epilogue)
EPI_POWER, EPI_LOG_MEL, EPI_POWER_MAX, EPI_LOG_MEL_FROM_POWER = 0, 1, 2, 3


def check_wav(wav: torch.Tensor, tables: torch.Tensor, hop: int, lo: int,
              what: str) -> None:
    """Raise unless ``wav`` and ``tables`` are what the kernel takes."""
    if wav.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {wav.device}")
    if wav.dtype != torch.float32 or wav.dim() != 2 \
            or not wav.is_contiguous():
        raise ValueError(f"wav must be contiguous float32 [B, T], got "
                         f"{wav.dtype} {tuple(wav.shape)}")
    if tables.device != wav.device or tables.dtype != torch.float32 \
            or tables.dim() != 1 or not tables.is_contiguous() \
            or tables.shape[0] != TABLE_FLOATS:
        raise ValueError(f"tables must be pack_tables()'s float32 "
                         f"[{TABLE_FLOATS}] array on wav's device")
    b, t = wav.shape
    if b == 0 or t == 0 or hop <= 0 or lo < 0:
        raise ValueError(f"batch {b} x {t} samples, hop {hop}, left pad {lo} "
                         f"is outside the kernel's range")


def launch(epi: int, wav: torch.Tensor, tables: torch.Tensor, hop: int,
           lo: int, out: Optional[torch.Tensor] = None,
           row_max: Optional[torch.Tensor] = None,
           power_in: Optional[torch.Tensor] = None,
           sched: Optional[torch.Tensor] = None, n_mels: int = 0,
           mel_w: Optional[torch.Tensor] = None, w_smem: int = 0,
           db_scale: float = 0.0, db_floor: float = 0.0) -> None:
    """One launch of the kernel with epilogue ``epi`` on ``wav``'s current
    stream; the caller has checked every tensor (:func:`check_wav`) and
    allocated ``out`` and ``row_max``. ``w_smem`` weight floats are staged
    in shared memory where the block gets at least :data:`STAGE_FRAMES`
    frames (else read from device memory). Every
    launch that runs the FFT counts as a launch of K1
    (``power_spectrogram_cuda.launches``), whatever its epilogue. Raises
    with CUDA's message if the launch is refused."""
    lib = _library()
    b, t = wav.shape
    sm_count = torch.cuda.get_device_properties(wav.device)\
        .multi_processor_count
    aligned = wav.data_ptr() % 16 == 0
    plan = launch_plan(b, t, hop, lo, sm_count, aligned)
    if w_smem and plan.tile_frames >= STAGE_FRAMES:
        plan = launch_plan(b, t, hop, lo, sm_count, aligned, w_smem)
    else:
        w_smem = 0
    slots = 0 if sched is None else sched.shape[0]
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream(wav.device).cuda_stream
        rc = lib.tasr_frontend(
            epi, wav.data_ptr(), tables.data_ptr(), _ptr(power_in), _ptr(out),
            _ptr(row_max), _ptr(sched), _ptr(mel_w), b, t, hop, lo,
            num_frames(t, hop), plan.tile_frames, plan.groups,
            int(plan.vec16), n_mels, slots, w_smem, db_scale, db_floor,
            stream)
    check_rc(rc, f"frontend kernel (epilogue {epi})")
    if epi != EPI_LOG_MEL_FROM_POWER:
        with LAUNCH_COUNT_LOCK:
            power_spectrogram_cuda.launches += 1


def launch_dense(power: torch.Tensor, row_max: Optional[torch.Tensor],
                 weights: torch.Tensor, out: torch.Tensor, db_scale: float,
                 db_floor: float) -> None:
    """One launch of the dense mel product on ``power``'s current stream:
    out [B, F, n_mels] = dB(power [B, F, 513]) @ weights [513, n_mels], the
    dB against ``row_max`` [B] where given ('same'). The caller has checked
    and allocated every tensor. Raises with CUDA's message if the launch is
    refused."""
    b, n_frames, n_mels = out.shape
    with torch.cuda.device(power.device):
        stream = torch.cuda.current_stream(power.device).cuda_stream
        rc = _library().tasr_dense_mel(
            power.data_ptr(), _ptr(row_max), weights.data_ptr(),
            out.data_ptr(), b * n_frames, n_frames, n_mels, db_scale,
            db_floor, stream)
    check_rc(rc, "dense mel kernel")


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def check_rc(rc: int, what: str) -> None:
    """Raise with CUDA's message if a launch returned an error."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_library().tasr_cuda_error_string(rc).decode()}")


def power_spectrogram_cuda(wav: torch.Tensor, tables: torch.Tensor,
                           hop: int, lo: int) -> torch.Tensor:
    """Launch K1 on ``wav``'s current stream. ``tables`` is
    :func:`pack_tables`'s array on the same device."""
    check_wav(wav, tables, hop, lo, "power_spectrogram_cuda")
    b, t = wav.shape
    out = torch.empty((b, num_frames(t, hop), N_FFT // 2 + 1),
                      dtype=torch.float32, device=wav.device)
    launch(EPI_POWER, wav, tables, hop, lo, out=out)
    return out


# launches of the FFT kernel, in any epilogue (K1's own and K1b's FFT passes)
power_spectrogram_cuda.launches = 0
# the model server launches from several threads (its worker, the batching
# ticker, connection threads draining a stream), so the counts take a lock
LAUNCH_COUNT_LOCK = threading.Lock()
