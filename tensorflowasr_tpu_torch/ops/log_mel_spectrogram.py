"""K1b: the log-mel frontend on Hopper, fused into K1's FFT kernel.

Replaces ``tensorflowasr_tpu/ops/pallas_frontend.py::log_mel_spectrogram_pallas``
(K1, then dB, then the mel product). wav [B, T] f32 -> log-mel [B,
ceil(T/hop), n_mels] f32:

- 'valid' (the chunk model): ``log10(max(power, 1e-10))`` per bin, then the
  mel product; one launch of ``csrc/power_spectrogram.cu`` with its log-mel
  epilogue, which writes nothing but the [frames, n_mels] output.
- 'same' (the offline model): ``amplitude_to_db``, i.e. 10 log10 against
  each example's largest power, floored at -range, then the mel product.
  The max needs every frame of the row, so it is two launches on one stream
  with no host sync between them: K1 writes the power and each row's max
  into a zeroed [B] buffer (an atomicMax on the float's bits), then the
  log-mel epilogue reads the stored power back, with no FFT. (Running the
  FFT again instead, so that the power never reaches device memory,
  measured slower on an H100: ``PERF.md``.)

Bound on an H100: at the serving shape (B = 128 x 7 s) the function reads
57 MB of wav and writes 29 MB of log-mel (0.026 ms at 3.35 TB/s); the FFTs
(1.5e9 FLOP as a split-radix real FFT counts them) and, for the shipped
Slaney basis, a banded product of 2 x 1001 FLOP a frame take about as long
at 67 TFLOP/s. Counted dense (2 x 513 x 80 a frame, 7.4e9 FLOP) the
product alone would take 0.11 ms, so the kernel is given each band's exact
nonzero range (:func:`mel_bands`), in pieces scheduled so that the threads
of a warp do about the same work. A given matrix (a trainable basis) has
no zeros to skip: K1 writes the power, then a tiled matrix product takes
the dB of each power as it stages it (``dense_mel_kernel``).

The plain version is ``ops/frontend.py::log_mel_spectrogram_reference``
(K1's plain version, the dB pass and ``torch.matmul``): the CPU path runs
it, and ``chip_smoke.py`` holds the kernel against it on the card.
:func:`log_mel_spectrogram_cuda` launches the kernel; it takes CUDA tensors
only and never falls back. Its gradient with respect to a trainable mel
matrix is ``ops/frontend.py``'s autograd function.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from tensorflowasr_tpu_torch.ops import power_spectrogram as k1

W_SMEM_MAX = 4096            # mel weight floats a block stages (16 KB)


class MelBands(NamedTuple):
    """What the kernel reads for the mel product. ``schedule`` is int32
    [slots, 4, lanes]: for thread t of a frame and slot s, a piece of one
    band, (k_lo, n, off, code): it sums ``db[k_lo + j] * weights[off + j]``
    for j < n. ``code`` 2 m: the piece is all of band m, and
    thread t writes it; 2 m + 1: it is the first half of band m, thread
    t + 16 holds the second, and thread t writes their sum; -1: nothing to
    write (a second half, or no piece)."""
    schedule: np.ndarray
    weights: np.ndarray


def _schedule(lo: np.ndarray, hi: np.ndarray, lanes: int = k1.FRAME_THREADS
              ) -> list:
    """Pieces of the bands [lo_m, hi_m) for ``lanes`` threads in slots:
    [(slot, lane, m, k_lo, n, code)]. Each thread sums one piece a slot;
    so that the threads of a warp (32) do about the same work, the widest
    bands are halved to fill the slots (2 n_mels pieces at most), and the
    two halves of a band sit on lanes l and l + 16 of one warp and slot,
    where one shuffle adds them. Bands go, widest first, into groups of
    32 lanes; the groups go to (warp, slot) in snake order (warp 0 slot 0,
    warp 1 slot 0, warp 1 slot 1, warp 0 slot 1, ...), which evens out
    the two warps' longest pieces summed over the slots. The threads of a
    warp read ``db[k_lo + j]`` together, so pieces whose k_lo differ mod 32
    read distinct banks: within a group each halving point moves by up to
    2 bins, never past the group's longest piece, to start the second half
    on the bank the group's other starts use least."""
    n_mels = len(lo)
    widths = [int(w) for w in hi - lo]
    slots = -(-n_mels // lanes)
    n_split = min(n_mels, lanes * slots - n_mels)
    order = sorted(range(n_mels), key=lambda m: (-widths[m], m))
    halved = set(order[:n_split])
    groups, cur, used = [], [], 0
    for m in order:
        size = 2 if m in halved else 1
        if used + size > 32:
            groups.append(cur)
            cur, used = [], 0
        cur.append(m)
        used += size
    if cur:
        groups.append(cur)
    warps = lanes // 32
    pieces = []
    for q, bands in enumerate(groups):
        slot, i = divmod(q, warps)
        base = 32 * (i if slot % 2 == 0 else warps - 1 - i)
        starts = collections.Counter(int(lo[m]) % 32 for m in bands)
        longest = max(-(-widths[m] // 2) if m in halved else widths[m]
                      for m in bands)
        free = list(range(32))
        for m in bands:
            w, k0 = widths[m], int(lo[m])
            if m not in halved:
                pieces.append((slot, base + free.pop(0), m, k0, w, 2 * m))
                continue
            h0 = (w + 1) // 2
            h = min([h for h in range(max(1, h0 - 2), min(w - 1, h0 + 2) + 1)
                     if max(h, w - h) <= longest] or [h0],
                    key=lambda h: (starts[(k0 + h) % 32], abs(h - h0)))
            starts[(k0 + h) % 32] += 1
            lane = next(i for i in range(16)
                        if i in free and i + 16 in free)
            free.remove(lane)
            free.remove(lane + 16)
            pieces.append((slot, base + lane, m, k0, h, 2 * m + 1))
            pieces.append((slot, base + lane + 16, m, k0 + h, w - h, -1))
    return pieces


def _pack(pieces: list, lanes: int, off) -> np.ndarray:
    """The schedule array of :class:`MelBands`, ``off(slot, lane, m, k_lo,
    n)`` giving each piece's first weight."""
    slots = max(p[0] for p in pieces) + 1
    schedule = np.zeros((slots, 4, lanes), np.int32)
    schedule[:, 3] = -1
    for slot, lane, m, k_lo, n, code in pieces:
        schedule[slot, :, lane] = k_lo, n, off(slot, lane, m, k_lo, n), code
    return schedule


def band_ranges(fb: np.ndarray) -> tuple:
    """Each column's exact nonzero range [lo, hi) (first to last nonzero
    bin; empty for a column of zeros)."""
    n_mels = fb.shape[1]
    lo, hi = np.zeros(n_mels, np.int64), np.zeros(n_mels, np.int64)
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        if nz.size:
            lo[m], hi[m] = nz[0], nz[-1] + 1
    return lo, hi


def mel_bands(fb: np.ndarray, lanes: int = k1.FRAME_THREADS) -> MelBands:
    """A fixed basis fb [n_freq, n_mels]: each band's exact nonzero range,
    scheduled by :func:`_schedule`, with its weights laid out for the
    kernel, which stages them in shared memory: slot s has a region of
    runs, thread t's piece at ``region_s + t * depth_s``, depth_s odd and
    at least the slot's longest piece, so that at each term the threads of
    a warp read distinct banks."""
    fb = np.asarray(fb, np.float32)
    lo, hi = band_ranges(fb)
    pieces = _schedule(lo, hi, lanes)
    slots = max(p[0] for p in pieces) + 1
    depth = [max([p[4] for p in pieces if p[0] == s] + [1]) | 1
             for s in range(slots)]
    size = [depth[s] * (1 + max(p[1] for p in pieces if p[0] == s))
            for s in range(slots)]
    region = np.concatenate([[0], np.cumsum(size)[:-1]])
    weights = np.zeros(sum(size), np.float32)

    def off(slot, lane, m, k_lo, n):
        at = int(region[slot]) + lane * depth[slot]
        weights[at:at + n] = fb[k_lo:k_lo + n, m]
        return at

    return MelBands(_pack(pieces, lanes, off), weights)


def log_mel_spectrogram_cuda(wav: torch.Tensor, tables: torch.Tensor,
                             weights: torch.Tensor, n_mels: int, hop: int,
                             lo: int, *, sched: Optional[torch.Tensor] = None,
                             same: bool, dynamic_range: float = 80.0
                             ) -> torch.Tensor:
    """Launch K1b on ``wav``'s current stream. ``tables`` is
    ``power_spectrogram.pack_tables``'s array, on wav's device as every
    tensor here. With ``sched`` (the int32 schedule of :class:`MelBands`),
    ``weights`` is that class's flat f32 weights of a fixed basis: the
    banded product, fused behind the FFT. Without it, ``weights`` is a
    given [513, n_mels] f32 matrix: K1, then the dense product. ``same``
    selects the 'same' dB (K1 first, writing the power and each row's max),
    else the 'valid' one (banded: one launch)."""
    k1.check_wav(wav, tables, hop, lo, "log_mel_spectrogram_cuda")
    n_freq = k1.N_FFT // 2 + 1
    if weights.device != wav.device or weights.dtype != torch.float32 \
            or not weights.is_contiguous() or n_mels <= 0:
        raise ValueError(f"weights must be contiguous float32 on wav's "
                         f"device for n_mels > 0, got {weights.dtype} on "
                         f"{weights.device}, n_mels {n_mels}")
    if sched is None and tuple(weights.shape) != (n_freq, n_mels):
        raise ValueError(f"a given matrix must be [{n_freq}, {n_mels}], got "
                         f"{tuple(weights.shape)}")
    if sched is not None and (
            sched.device != wav.device or sched.dtype != torch.int32
            or sched.dim() != 3 or sched.shape[1:] != (4, k1.FRAME_THREADS)
            or not sched.is_contiguous()):
        raise ValueError(f"sched must be int32 [slots, 4, "
                         f"{k1.FRAME_THREADS}] on wav's device, got "
                         f"{sched.dtype} {tuple(sched.shape)}")
    b, t = wav.shape
    n_frames = k1.num_frames(t, hop)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32,
                      device=wav.device)
    if same:
        db = dict(db_scale=10.0 * math.log10(2.0), db_floor=-dynamic_range)
    else:
        db = dict(db_scale=math.log10(2.0), db_floor=-math.inf)
    if sched is not None and not same:
        # the weights are staged in shared memory where they fit
        k1.launch(k1.EPI_LOG_MEL, wav, tables, hop, lo, out=out, sched=sched,
                  n_mels=n_mels, mel_w=weights,
                  w_smem=weights.numel() if weights.numel() <= W_SMEM_MAX
                  else 0, **db)
    else:
        power = torch.empty((b, n_frames, n_freq), dtype=torch.float32,
                            device=wav.device)
        row_max = None
        if same:
            # each row's largest power, as float bits; +0.0 is all zero bits
            row_max = torch.zeros((b,), dtype=torch.int32, device=wav.device)
            k1.launch(k1.EPI_POWER_MAX, wav, tables, hop, lo, out=power,
                      row_max=row_max)
        else:
            k1.launch(k1.EPI_POWER, wav, tables, hop, lo, out=power)
        if sched is None:
            k1.launch_dense(power, row_max, weights, out, **db)
        else:
            k1.launch(k1.EPI_LOG_MEL_FROM_POWER, wav, tables, hop, lo,
                      out=out, row_max=row_max, power_in=power, sched=sched,
                      n_mels=n_mels, mel_w=weights,
                      w_smem=weights.numel() if weights.numel() <= W_SMEM_MAX
                      else 0, **db)
    with k1.LAUNCH_COUNT_LOCK:
        log_mel_spectrogram_cuda.launches += 1
    return out


# launches that wrote a log-mel: one per call
log_mel_spectrogram_cuda.launches = 0
