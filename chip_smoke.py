"""Drive the PyTorch port's offline ConformerCTC(S) serving and training
paths and its chunk-streaming ChunkConformer(S) serving and training paths
on one CUDA card, and check them.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  - the card's name and power limit (nvidia-smi); raises without
             CUDA.
2. build   - nvcc builds every kernel in ``tensorflowasr_tpu_torch/csrc``.
3. kernel  - K1 (the power-spectrogram kernel, one FFT per frame in shared
             memory) and K1b (the log-mel kernel: K1's FFT with the dB and
             the banded mel product fused behind it; two launches for
             'same', the first for each row's max) against their plain
             PyTorch versions, TF32 off, at every shape a later phase gives
             them: 'same' at B=128 x 7 s (serve), the one-chunk request
             shape (B=1 x 7680 samples), the train batch (B=128 x 8 s), the
             cli phase's buckets (B=8 x 2 s and 4 s) and the card-against-
             CPU batch (B=2 x 1 s); and 'valid' at B=16 x 7680 samples and
             a ragged T, so that both of K1's slab-copy paths are taken;
             power within rtol 2e-4 / atol 2e-3, log-mel within rtol 1e-3 /
             atol 5e-2; K1b's backward (a given mel matrix) against the
             plain version's autograd at the cli buckets, within 1e-4 of the
             gradient's largest entry. Times K1, its plain version and
             ``torch.stft`` at the serve, the request and the train shape,
             each with median, minimum and spread, beside that shape's
             bound, and at the cli buckets (with a CUDA graph replay, since
             events time the host there); and K1b at the serve, train and
             request shapes beside K1 + the plain dB and mel matmul (the
             path K1b replaced, at the serve shape), the plain version and
             ``torch.stft`` + the same dB and mel, with its bound counted
             both ways (the mel product dense, and banded as the kernel
             does it).
4. serve   - the full-width model (dmodel 144, 13 blocks, 4 x 36 heads,
             kernel 32; 231 phone and 9161 char classes) with seeded random
             weights: ``predict_step`` on B=128 x 7 s in f32 and bf16, with a
             per-stage time breakdown; the f32 outputs are held against the
             same model run on the CPU (plain frontend) on a small input.
5. request - ``OfflineASRSession`` answers 4 requests (2, 3.5, 5, 8 s).
6. train   - ``CTCTrainer`` built from ``configs/am_data.yml`` +
             ``configs/conformerS.yml`` (full width, dropout 0.1, Adam lr
             1e-4), seeded weights, on the training benchmark's batch (B=128
             x 8 s of noise, 64 phones, 32 chars): one warm step, then 10
             timed ``train_step`` calls on that batch and 10 more enqueued
             back to back, in bf16 and in f32. Every loss must be finite,
             the last below the first, the BatchNorm running statistics
             must have moved, and K1 must have run once a step. Prints
             step time, audio seconds per second, peak memory and, in f32
             (where the card is the limit), a forward / loss / backward /
             optimizer split of one more ``train_step`` by CUDA events.
             Then, from the same weights with dropout 0, one f32 loss and
             backward on B=2 x 1 s on the card and on the CPU (plain
             frontend): loss within 1e-4 relative, the gradient's global
             norm within 1e-3 relative; and ``ctc_loss`` alone on the card
             against the CPU, with an infeasible row whose loss and
             gradient must be 0.
7. cli     - writes a seeded corpus (40 tone + noise wavs of 1-3 s, lists,
             a pinyin map, 230-phone and 9160-char vocabularies, a data
             YAML) to a temporary directory, runs the port's
             ``cli.train_asr`` on it with ``configs/conformerS.yml`` for 6
             steps with a save, then ``cli.eval_am`` from that checkpoint,
             which must restore it and print its JSON of phone and char
             error rates.
8. chunk_kernel  - K1 'valid' at the chunk path's shapes (B=1 x 5120,
             the stream step's mel of [wav tail | chunk]; B=256 x 5120, the
             pool tick's; B=128 x 7 s, the offline batch; B=1 x 8 s, the
             chunk CLI's offline decode; B=128 x 8 s, the chunk train batch;
             B=8 x 33280 and 64000, the chunk train CLI's buckets; B=2 x
             20480, the card-against-CPU batch) against its plain version,
             with K1b 'valid' held at each; then K1 at all but the last
             timed with the plain version and ``torch.stft`` (left pad
             1023, ``center=False``) + ``abs()**2``: CUDA events at every
             shape, and a CUDA graph replay at all but the offline batch;
             and K1b the same way at the stream, pool, offline and chunk
             train shapes.
9. chunk_offline - ChunkConformer(S) from ``configs/chunk_conformerS.yml``
             at full width (``serve/bench_chunk.py``: seeded weights, first
             conv x10, the picker's blank bias moved so about half the
             frames are picked): ``make_chunk_predict_step`` on B=128 x 7 s
             in f32 and bf16, median of 5, per-stream RTF; 20-80 % of the
             frames picked, every row picking some.
10. chunk_stream - one stream in f32 and bf16: ``fused_stream_step``
             chained over 50 chunks on its caches with one sync at the end
             (best of 3), every implicit host sync an error
             (``torch.cuda.set_sync_debug_mode``); then ``ChunkStreamSession``
             with a fetch a chunk. In f32 the session's phone ids on the 8 s
             signal must equal the collapsed argmax of the offline
             ``encode_to_phones``, and ``picker_stream_step``'s logits on the
             card must be within 1e-3 of the CPU port's.
11. chunk_pool   - ``batched_stream_step`` over 256 slots, f32 and bf16,
             chained as bench.py:239-286 does (best of 10 x 25 ticks, no
             implicit sync), and ``MultiStreamChunkServer.tick`` draining 25
             chunks of every slot (upload, step, fetch): tick ms, streams in
             real time (256 x 0.16 s / tick), per-stream RTF, peak memory.
             Then 4 streams of 2, 3.5, 5 and 8 s go through a 256-slot pool
             in interleaved odd-sized packets, the 4th opened when the first
             closes; each result must equal an independent
             ``ChunkStreamSession``'s on the card.
12. chunk_cli    - ``cli.test_chunk_asr --device cuda`` on an 8 s wav in a
             temporary directory (the cli phase's full-size vocabularies),
             with the f32 chunk model's weights written as a flax ``.npz``
             for ``--weights``: its streamed phones must equal its offline
             phones, and K1 must run once a chunk.
13. chunk_train  - ``ChunkTrainer`` built from ``configs/am_data.yml`` +
             ``configs/chunk_conformerS.yml`` (full width, Adam lr 1e-4),
             seeded weights calibrated as the serving phases' in training
             mode (``train/bench_chunk_batch.py``), on B=128 x 8 s of gated
             tones, 64 phones, 32 chars, 64 extra phones, 32 extra chars, in
             f32 and bf16: one warm step, 10 steps back to back, then 10
             timed one by one (median). Every loss must be finite and K1
             must have run once a step. Prints step time, audio seconds per
             second, peak memory, the picked share and ``t_ref`` before and
             after the steps, and (f32) a forward / loss / backward /
             optimizer split by CUDA events. One more step runs with every
             implicit host sync reported (``set_sync_debug_mode("warn")``),
             printed with the port's line that caused it, as a warning;
             were there none, a step would run with syncs as errors.
14. chunk_train_card_vs_cpu - one f32 loss + backward of the same
             calibrated full-width model on B=2 x 1.28 s on the card and on
             the CPU (plain frontend): the same picks, loss within 1e-4
             relative, the gradient's global norm within 1e-3 relative.
15. chunk_train_cli - on phase 7's corpus, ``cli.train_asr`` with
             ``configs/chunk_conformerS.yml`` at B=8 for 3 steps with a save,
             then ``cli.eval_am`` and ``cli.test_chunk_asr`` (no
             ``--weights``) on an 8 s wav, both restoring that checkpoint:
             error rates finite, streamed phones = offline phones.

K1's and K1b's launch counts are set to 0 just before the ``predict_step``
calls, the session's 4 requests, each dtype's train steps, the two CLI
calls, each chunk phase's timed runs, the chunk CLI call, each dtype's
chunk train steps and the three chunk train CLI calls, and read just after
each; all must have launched both. K1b counts one launch a log-mel (the
launch that writes it); K1 counts every launch of the FFT kernel, in any
epilogue: two a 'same' log-mel (the max pass and the log-mel pass), one a
'valid' one. Where a phase knows its number of frontend calls it must be
exact. The stage breakdowns and the card-vs-CPU checks run outside those
windows. K1's times at the request and the train shape go on
``k1_request_shape`` and ``k1_train_shape`` JSON lines in the kernel phase.
The last lines are a JSON line of kernel numbers (K1's times at the serve
shape, with the request, train, cli and the 'valid' shapes beside them and
the largest error over all shapes; K1b's the same way), then ``{"ok":
true, "device": {...}}``.
TF32 is off throughout (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so every f32 number is full f32.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch

from tensorflowasr_tpu_torch.serve.bench_chunk import (
    CHUNK_S,
    CHUNK_SAMPLES,
    chunk_models,
    tones,
)
from tensorflowasr_tpu_torch.train.bench_batch import (
    N_CHAR,
    N_PHONE,
    SR,
    TRAIN_B,
    TRAIN_CHARS,
    TRAIN_PHONES,
    TRAIN_SECONDS,
    new_trainer,
    train_batch,
)
from tensorflowasr_tpu_torch.train.bench_chunk_batch import (
    chunk_train_batch,
    new_chunk_trainer,
)

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

REQUEST_SAMPLES = 7680               # ASREngine's 0.48 s chunk at B = 1
CLI_B, CLI_BUCKET_SECONDS = 8, (2.0, 4.0)    # the cli phase's batches
POWER_TOL = dict(rtol=2e-4, atol=2e-3)
# torch.stft's log-mel against the plain version's (the Pallas kernel's
# tolerance, for two DFTs that round differently)
LOGMEL_TOL = dict(rtol=1e-3, atol=5e-2)
# K1b against its plain version, as tests/test_torch_kernels_cuda.py holds
# it: 8.0e-5 seen at most, where a bulk 'valid' log-mel of this noise is
# about 0.02
KERNEL_LOGMEL_TOL = dict(rtol=1e-4, atol=5e-4)


def log(*parts) -> None:
    print(*parts, flush=True)


def within(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float
           ) -> float:
    """Max |got - want|; raises unless |got - want| <= atol + rtol |want|."""
    err = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite values")
    bad = err > atol + rtol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} of {bad.numel()} values "
                             f"outside rtol {rtol} / atol {atol}; max "
                             f"|err| {err.max().item():.3e}")
    return err.max().item()


def fmt_times(stats: dict) -> str:
    return (f"median {stats['median']:.4f} min {stats['min']:.4f} spread "
            f"{stats['spread']:.4f} ms ({stats['reps']} x {stats['inner']})")


def noise(shape, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1
            ).astype(np.float32)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} x {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi.splitlines()[0])
    return name


def phase_build() -> None:
    from tensorflowasr_tpu_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(reports)}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log("kernels: K1 power_spectrogram (csrc/power_spectrogram.cu, power "
        "epilogue) replaces pallas_frontend.py::power_spectrogram_pallas; "
        "K1b log_mel_spectrogram (the same FFT kernel with log-mel "
        "epilogues, 'same' as power and row max, then log-mel from the "
        "power; ops/log_mel_spectrogram.py) replaces "
        "pallas_frontend.py::log_mel_spectrogram_pallas")


def time_k1(padding: str, b: int, t: int, reps: int, graph: bool = False,
            log_mel: bool = False, replaced: bool = False) -> dict:
    """Times of K1, its plain version and ``torch.stft`` on one input, and
    the bound for that input; with ``graph`` also the kernel replayed from a
    CUDA graph. With ``log_mel``, K1b instead (log_mel_spectrogram_pallas's
    counterpart, the fused kernel), its plain version (the plain power, dB
    and mel matmul) and ``torch.stft`` + ``abs()**2`` + the same dB and
    matmul, with the bound counted both ways; with ``replaced`` also K1 +
    the plain dB and mel matmul, the path K1b replaced."""
    from tensorflowasr_tpu_torch.kernels.timing import cuda_times, graph_times
    from tensorflowasr_tpu_torch.ops import frontend as fe

    dev = torch.device("cuda")
    cfg = fe.LogMelFrontendConfig(padding=padding)
    wav = torch.from_numpy(noise((b, t), seed=t)).to(dev)
    n_fft, n_freq = cfg.n_fft, cfg.n_freq
    n_frames = -(-t // cfg.hop)
    lo = fe._left_pad(t, cfg)
    total = (n_frames - 1) * cfg.hop + n_fft
    padded = torch.nn.functional.pad(wav, (lo, total - lo - t))
    window = torch.hann_window(n_fft, periodic=True, device=dev)
    mel = torch.from_numpy(fe._frontend_constants(cfg)[1]).to(dev)

    def epilogue(power):
        return torch.matmul(fe._to_db(power, cfg), mel) if log_mel \
            else power

    def library():
        spec = torch.stft(padded, n_fft, cfg.hop, window=window,
                          center=False, return_complex=True)
        return epilogue((spec.abs() ** 2).transpose(1, 2))

    if log_mel:
        def kernel_fn():
            return fe.log_mel_spectrogram(wav, cfg)

        def plain_fn():
            return fe.log_mel_spectrogram_reference(wav, cfg)
    else:
        def kernel_fn():
            return fe.power_spectrogram(wav, cfg)

        def plain_fn():
            return fe.power_spectrogram_reference(wav, cfg)

    within(library(), plain_fn(), **(LOGMEL_TOL if log_mel else POWER_TOL))
    kernel = cuda_times(kernel_fn, reps, 10)
    plain = cuda_times(plain_fn, max(reps // 5, 5), 2)
    lib = cuda_times(library, max(reps // 2, 5), 5)
    replayed = graph_times(kernel_fn, reps, 20) if graph else None
    old = cuda_times(lambda: epilogue(fe.power_spectrogram(wav, cfg)),
                     reps, 10) if replaced else None
    # The bound counts the least work the function needs: per frame the
    # window product, a real FFT of n_fft points (split radix: 2 n log2 n -
    # 4 n + 6 FLOP, the fewest known) and re^2 + im^2 per bin; the wav read
    # once and the power written once. K1b adds the dB (a log, a max and a
    # scale per bin) and the mel product, and writes the log-mel instead of
    # the power: counted dense (2 n_freq n_mels a frame) and banded (2 per
    # nonzero of the basis, what the kernel does), each with its weights
    # read once.
    per_frame = (n_fft + 2 * n_fft * math.log2(n_fft) - 4 * n_fft + 6
                 + 3 * n_freq)
    n_out = n_freq
    if log_mel:
        per_frame += 3 * n_freq
        n_out = cfg.n_mels
    frames = b * n_frames
    nbytes = 4.0 * (b * t + frames * n_out)

    def bound(flops, weight_bytes):
        by_ops = flops / PEAK_F32_FLOPS
        by_bytes = (nbytes + weight_bytes) / PEAK_BYTES
        return {"bound_ms": max(by_ops, by_bytes) * 1e3,
                "bound_by": "operations" if by_ops > by_bytes else "bytes",
                "flops": flops, "bytes": nbytes + weight_bytes}

    out = {"kernel": kernel, "kernel_graph": replayed, "plain": plain,
           "library": lib, "replaced": old}
    if not log_mel:
        out.update(bound(frames * per_frame, 0.0))
        return out
    nnz = int(np.count_nonzero(fe._frontend_constants(cfg)[1]))
    out.update(bound(frames * (per_frame + 2 * nnz),
                     4.0 * (nnz + 3 * cfg.n_mels)))
    out["dense"] = bound(frames * (per_frame + 2 * n_freq * cfg.n_mels),
                         4.0 * n_freq * cfg.n_mels)
    return out


def hold_k1(padding: str, b: int, t: int):
    """K1 and K1b against their plain versions on one seeded input. Returns
    (max |err| on power, whether K1's launch took 16-byte slab copies, max
    |err| on log-mel)."""
    from tensorflowasr_tpu_torch.ops import frontend as fe
    from tensorflowasr_tpu_torch.ops import power_spectrogram as k1

    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = fe.LogMelFrontendConfig(padding=padding)
    wav = torch.from_numpy(noise((b, t), seed=t)).to(dev)
    plan = k1.launch_plan(b, t, cfg.hop, fe._left_pad(t, cfg), sm_count,
                          base_aligned=wav.data_ptr() % 16 == 0)
    got = fe.power_spectrogram(wav, cfg)
    want = fe.power_spectrogram_reference(wav, cfg)
    torch.cuda.synchronize()
    err = within(got, want, **POWER_TOL)
    mel_err = within(fe.log_mel_spectrogram(wav, cfg),
                     fe.log_mel_spectrogram_reference(wav, cfg),
                     **KERNEL_LOGMEL_TOL)
    log(f"kernel: K1 {padding} B={b} T={t} -> {tuple(got.shape)} "
        f"(tile {plan.tile_frames} frames, {plan.groups * 64} threads, "
        f"{16 if plan.vec16 else 4}-byte copies): max|err| power "
        f"{err:.3e}; K1b log-mel {mel_err:.3e}")
    return err, plan.vec16, mel_err


def hold_k1b_backward(padding: str, b: int, t: int) -> float:
    """K1b with a given mel matrix (K1, then the dense product kernel) and
    its autograd backward against the plain version's, on one seeded input
    and cotangent: log-mel within KERNEL_LOGMEL_TOL, the matrix's gradient
    within 1e-4
    of its largest entry. Returns the gradient's max |err|."""
    from tensorflowasr_tpu_torch.ops import frontend as fe

    dev = torch.device("cuda")
    cfg = fe.LogMelFrontendConfig(padding=padding)
    wav = torch.from_numpy(noise((b, t), seed=t + 1)).to(dev)
    fb = fe._frontend_constants(cfg)[1]
    w0 = torch.from_numpy(fb + np.random.default_rng(t).uniform(
        0, 2e-3, fb.shape).astype(np.float32)).to(dev)
    cot = torch.from_numpy(noise((b, -(-t // cfg.hop), cfg.n_mels),
                                 seed=t + 2)).to(dev)
    results = []
    for fn in (fe.log_mel_spectrogram, fe.log_mel_spectrogram_reference):
        w = w0.clone().requires_grad_()
        out = fn(wav, cfg, mel_weights=w)
        (out * cot).sum().backward()
        results.append((out.detach(), w.grad))
    torch.cuda.synchronize()
    (got, got_grad), (want, want_grad) = results
    err = within(got, want, **KERNEL_LOGMEL_TOL)
    scale = float(want_grad.abs().max())
    grad_err = within(got_grad, want_grad, rtol=0, atol=1e-4 * scale)
    log(f"kernel: K1b {padding} B={b} T={t} with a given [513, 80] matrix: "
        f"max|err| log-mel {err:.3e}; its backward, gradient max|err| "
        f"{grad_err:.3e} (largest entry {scale:.3e})")
    return grad_err


def k1_numbers(batch: int, samples: int, times: dict) -> dict:
    """The kernels line's numbers for one shape timed by ``time_k1``: for
    K1b also the dense bound, and where they were taken the graph replay
    and the replaced path's time."""
    out = {"batch": batch, "samples": samples,
           "ms": times["kernel"]["median"],
           "plain_ms": times["plain"]["median"],
           "library_ms": times["library"]["median"],
           "bound_ms": times["bound_ms"], "bound_by": times["bound_by"]}
    if "dense" in times:
        out.update(dense_bound_ms=times["dense"]["bound_ms"],
                   dense_bound_by=times["dense"]["bound_by"])
    if times["kernel_graph"] is not None:
        out["graph_ms"] = times["kernel_graph"]["median"]
    if times["replaced"] is not None:
        out["replaced_ms"] = times["replaced"]["median"]
    return out


def log_k1b(phase: str, what: str, times: dict) -> None:
    """One line of K1b's times at a shape, beside its bounds."""
    replay = "" if times["kernel_graph"] is None else (
        f"; replayed from a CUDA graph {fmt_times(times['kernel_graph'])}")
    replaced = "" if times["replaced"] is None else (
        f"; K1 + plain dB + mel (the path it replaced) "
        f"{fmt_times(times['replaced'])}")
    dense = times["dense"]
    log(f"{phase}: K1b log-mel {what}: kernel {fmt_times(times['kernel'])}"
        f"{replay}{replaced}; plain {fmt_times(times['plain'])}; library "
        f"(torch.stft + abs()**2 + dB + mel) {fmt_times(times['library'])}; "
        f"bound banded {times['bound_ms']:.6f} ms by {times['bound_by']} "
        f"({times['flops']:.4e} FLOP, {times['bytes']:.4e} B), dense "
        f"{dense['bound_ms']:.6f} ms by {dense['bound_by']} "
        f"({dense['flops']:.4e} FLOP)")


def phase_kernel() -> dict:
    # 'same' batched and the one-chunk request take 16-byte slab copies;
    # 'valid' (left pad 1023) and the ragged row stride take 4-byte ones.
    # Then the shapes the later phases give K1: the train batch, the cli
    # phase's two buckets, the card-against-CPU batch
    shapes = (("same", 128, 7 * SR), ("valid", 16, 2560 * 3),
              ("same", 3, 2 * SR + 77), ("same", 1, REQUEST_SAMPLES),
              ("same", TRAIN_B, TRAIN_SECONDS * SR),
              *(("same", CLI_B, int(s * SR)) for s in CLI_BUCKET_SECONDS),
              ("same", 2, SR))
    result, copies = {"max_abs_err": 0.0, "log_mel_max_abs_err": 0.0}, set()
    for padding, b, t in shapes:
        err, vec16, mel_err = hold_k1(padding, b, t)
        copies.add(vec16)
        result["max_abs_err"] = max(result["max_abs_err"], err)
        result["log_mel_max_abs_err"] = max(result["log_mel_max_abs_err"],
                                            mel_err)
    if copies != {True, False}:
        raise AssertionError("the shapes did not cover both copy paths")
    for padding in ("same", "valid"):
        hold_k1b_backward(padding, CLI_B, int(CLI_BUCKET_SECONDS[0] * SR))

    # the serving shape: 57 MB of wav in, 184 MB of power out, more than the
    # 50 MB L2, so back-to-back launches find their inputs in device memory
    batched = time_k1("same", 128, 7 * SR, reps=50)
    # K1b at that shape (57 MB in, 29 MB out), beside the path it replaced
    # (K1 + the plain dB + mel matmul), the plain version and torch.stft
    # with the same dB and mel
    k1b = time_k1("same", 128, 7 * SR, reps=50, log_mel=True, replaced=True)
    log_k1b("kernel", f"same B=128 T={7 * SR} (serve)", k1b)
    k1b_train = time_k1("same", TRAIN_B, TRAIN_SECONDS * SR, reps=50,
                        log_mel=True)
    log_k1b("kernel", f"same B={TRAIN_B} T={TRAIN_SECONDS * SR} (train)",
            k1b_train)
    k1b_request = time_k1("same", 1, REQUEST_SAMPLES, reps=50, graph=True,
                          log_mel=True)
    log_k1b("kernel", f"same B=1 T={REQUEST_SAMPLES} (request, L2-warm)",
            k1b_request)
    log(f"kernel: K1 same B=128 T={7 * SR} (inputs and outputs exceed the "
        f"L2): kernel {fmt_times(batched['kernel'])}; plain "
        f"{fmt_times(batched['plain'])}; library (torch.stft + abs()**2) "
        f"{fmt_times(batched['library'])}; bound_ms "
        f"{batched['bound_ms']:.4f} by {batched['bound_by']} "
        f"({batched['flops']:.4e} FFT FLOP, {batched['bytes']:.4e} B)")

    # one request chunk: 30 KB in, 98 KB out, all of it L2-resident, so
    # these are L2-warm times; event times of such short kernels hold the
    # host's enqueue rate, the graph replay is the device's own time
    request = time_k1("same", 1, REQUEST_SAMPLES, reps=50, graph=True)
    log(f"kernel: K1 same B=1 T={REQUEST_SAMPLES} (L2-warm): kernel "
        f"{fmt_times(request['kernel'])}; kernel replayed from a CUDA graph "
        f"{fmt_times(request['kernel_graph'])}; plain "
        f"{fmt_times(request['plain'])}; library (torch.stft + abs()**2) "
        f"{fmt_times(request['library'])}; bound_ms "
        f"{request['bound_ms']:.6f} by {request['bound_by']} "
        f"({request['flops']:.4e} FFT FLOP, {request['bytes']:.4e} B)")
    # the train batch: 66 MB in, 210 MB out
    train = time_k1("same", TRAIN_B, TRAIN_SECONDS * SR, reps=50)
    log(f"kernel: K1 same B={TRAIN_B} T={TRAIN_SECONDS * SR} (the train "
        f"batch): kernel {fmt_times(train['kernel'])}; plain "
        f"{fmt_times(train['plain'])}; library (torch.stft + abs()**2) "
        f"{fmt_times(train['library'])}; bound_ms {train['bound_ms']:.4f} "
        f"by {train['bound_by']} ({train['flops']:.4e} FFT FLOP, "
        f"{train['bytes']:.4e} B)")

    # the cli phase's buckets: 1-2 MB in, small enough that events time the
    # host, so the graph replay is the device's time
    result["cli_shapes"] = []
    for seconds in CLI_BUCKET_SECONDS:
        t = int(seconds * SR)
        times = time_k1("same", CLI_B, t, reps=20, graph=True)
        result["cli_shapes"].append(k1_numbers(CLI_B, t, times))
        log(f"kernel: K1 same B={CLI_B} T={t} (a cli bucket): kernel "
            f"{fmt_times(times['kernel'])}; kernel replayed from a CUDA "
            f"graph {fmt_times(times['kernel_graph'])}; plain "
            f"{fmt_times(times['plain'])}; library (torch.stft + abs()**2) "
            f"{fmt_times(times['library'])}; bound_ms "
            f"{times['bound_ms']:.6f} by {times['bound_by']} "
            f"({times['bytes']:.4e} B)")
    result["train_shape"] = k1_numbers(TRAIN_B, TRAIN_SECONDS * SR, train)
    result["log_mel"] = {
        "serve": k1_numbers(128, 7 * SR, k1b),
        "train": k1_numbers(TRAIN_B, TRAIN_SECONDS * SR, k1b_train),
        "request": k1_numbers(1, REQUEST_SAMPLES, k1b_request)}
    result["request_shape"] = k1_numbers(1, REQUEST_SAMPLES, request)
    log(json.dumps({"k1_request_shape": result["request_shape"]}))
    log(json.dumps({"k1_train_shape": result["train_shape"]}))
    result.update(k1_numbers(128, 7 * SR, batched))
    return result


def batch_inputs(b: int, seconds: float, dev):
    wav = torch.from_numpy(noise((b, int(seconds * SR)), seed=0)).to(dev)
    length = torch.full((b,), int(seconds * 100) // 4, dtype=torch.int32,
                        device=dev)
    return wav, length


def check_outputs(out, b: int, t_enc: int) -> None:
    phone_ids, phone_lens, char_ids = out
    if tuple(phone_ids.shape) != (b, t_enc) or \
            tuple(char_ids.shape) != (b, t_enc + 10):
        raise AssertionError(f"shapes {tuple(phone_ids.shape)} "
                             f"{tuple(char_ids.shape)}")
    if not (0 <= int(phone_lens.min()) and int(phone_lens.max()) <= t_enc):
        raise AssertionError("phone lengths out of range")
    if not (0 <= int(phone_ids.min()) and int(phone_ids.max()) < N_PHONE
            and 0 <= int(char_ids.min()) and int(char_ids.max()) < N_CHAR):
        raise AssertionError("ids out of range")


def counted(fn):
    """``fn()`` with K1's and K1b's launch counts set to 0 just before it
    and read just after it: returns (what fn returned, (K1 launches, K1b
    launches))."""
    from tensorflowasr_tpu_torch.ops import log_mel_spectrogram as k1b
    from tensorflowasr_tpu_torch.ops import power_spectrogram as k1

    k1.power_spectrogram_cuda.launches = 0
    k1b.log_mel_spectrogram_cuda.launches = 0
    out = fn()
    return out, (k1.power_spectrogram_cuda.launches,
                 k1b.log_mel_spectrogram_cuda.launches)


def expect(launches: tuple, calls: int, what: str) -> tuple:
    """Raise unless ``calls`` log-mel frontends launched K1b
    once each and K1 (the FFT kernel) once each; returns ``launches``."""
    want = (calls, calls)
    if tuple(launches) != want:
        raise AssertionError(f"{what} launched K1 and K1b {launches} times, "
                             f"not {want}")
    return launches


def add(a: tuple, b: tuple) -> tuple:
    return tuple(x + y for x, y in zip(a, b))


def stage_breakdown(model, wav, length) -> dict:
    """CUDA-event times of one predict_step's stages, in ms."""
    from tensorflowasr_tpu_torch.ops.ctc import ctc_greedy_decode

    enc_mod = model.encoder
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    with torch.no_grad():
        mark("start")
        mel = enc_mod.mel_layer(wav)
        mark("frontend (K1b: FFT, dB and banded mel in one kernel)")
        x = enc_mod.conv_subsampling(mel[..., None])
        mark("conv subsampling")
        for block in enc_mod.blocks:
            x = block(x)
        enc = x.float()
        mark("13 conformer blocks")
        ids, _ = ctc_greedy_decode(model.ctc_logits(enc), length,
                                   model.num_phone_classes - 1)
        mark("CTC head + greedy")
        padded = torch.nn.functional.pad(ids, (0, 10))
        torch.argmax(model.translate(padded, enc), -1)
        mark("translator")
    torch.cuda.synchronize()
    return {name: round(prev.elapsed_time(ev), 4)
            for (_, prev), (name, ev) in zip(marks, marks[1:])}


def phase_serve(seconds: float = 7.0, b: int = 128, reps: int = 5):
    """Returns the models by dtype and K1's and K1b's launches in the
    predict_step calls alone."""
    from tensorflowasr_tpu_torch.models.conformer import (
        ConformerConfig,
        build_model,
    )
    from tensorflowasr_tpu_torch.serve.engines import predict_step

    dev = torch.device("cuda")
    wav, length = batch_inputs(b, seconds, dev)
    n_frames = -(-wav.shape[1] // 160)
    t_enc = -(-n_frames // 4)
    models, launches = {}, (0, 0)
    for dtype in ("float32", "bfloat16"):
        cfg = ConformerConfig(dtype_str=dtype)
        model = build_model(cfg, N_PHONE, N_CHAR, device="cuda", seed=0)
        models[dtype] = model

        def predict():
            out = predict_step(model, wav, length)
            torch.cuda.synchronize()
            check_outputs(out, b, t_enc)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = predict_step(model, wav, length)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            check_outputs(out, b, t_enc)
            return times

        times, n = counted(predict)
        launches = add(launches, expect(n, reps + 1,
                                        f"{reps + 1} predict_step calls"))
        step = statistics.median(times)
        log(f"serve: predict_step {dtype} B={b} x {seconds} s: median "
            f"{step * 1e3:.3f} ms (min {min(times) * 1e3:.3f}), per-stream "
            f"RTF {step / (b * seconds):.3e}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"serve: {dtype} stages (ms): "
            f"{json.dumps(stage_breakdown(model, wav, length))}")

    # the f32 path on the card against the same model on the CPU (plain
    # frontend, CPU kernels) on a small input
    model = models["float32"]
    small, small_len = batch_inputs(2, 1.0, dev)
    with torch.no_grad():
        enc_gpu = model.encode(small)
        logits_gpu = model.ctc_logits(enc_gpu)
        cpu_model = build_model(ConformerConfig(), N_PHONE, N_CHAR,
                                device="cpu", seed=0)
        enc_cpu = cpu_model.encode(small.cpu())
        logits_cpu = cpu_model.ctc_logits(enc_cpu)
    enc_err = within(enc_gpu.cpu(), enc_cpu, rtol=0, atol=1e-3)
    logit_err = within(logits_gpu.cpu(), logits_cpu, rtol=0, atol=1e-3)
    log(f"serve: f32 card vs CPU on B=2 x 1 s: max|err| encoder "
        f"{enc_err:.3e}, CTC logits {logit_err:.3e}")
    return models, launches


class CharVocab:
    """Char read-out for random weights: id -> "<id>", ``</S>`` is id 1."""

    def iextract(self, i: int) -> str:
        return f"<{i}>"

    def endid(self) -> int:
        return 1


def phase_requests(model) -> tuple:
    """Returns K1's and K1b's launches in the 4 requests alone."""
    from tensorflowasr_tpu_torch.serve.engines import ASREngine
    from tensorflowasr_tpu_torch.serve.offline_session import (
        OfflineASRSession,
    )

    session = OfflineASRSession(ASREngine(model, text_featurizer=CharVocab()))
    session.transcribe_wav(noise(SR, seed=9))                 # warm-up

    def requests():
        for i, seconds in enumerate((2.0, 3.5, 5.0, 8.0)):
            wav = noise(int(seconds * SR), seed=10 + i)
            t0 = time.perf_counter()
            segments = session.transcribe_wav(wav)
            latency = time.perf_counter() - t0
            if not (isinstance(segments, list) and len(segments) == 1
                    and abs(segments[0]["end_s"] - seconds) < 1e-6
                    and isinstance(segments[0]["text"], str)):
                raise AssertionError(f"request {i}: bad segments {segments}")
            log(f"request: {seconds} s -> {len(segments)} segment(s), "
                f"{len(segments[0]['text'])} text chars, latency "
                f"{latency * 1e3:.3f} ms (RTF {latency / seconds:.3e})")

    return counted(requests)[1]


def train_stage_split(trainer, batch) -> dict:
    """CUDA-event times of one more ``train_step``'s stages, in ms."""
    from tensorflowasr_tpu_torch.train.asr_trainer import make_train_step

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    step = make_train_step(trainer.blank_id, mark=mark)
    mark("start")
    step(trainer.state, batch)
    torch.cuda.synchronize()
    return {name: round(prev.elapsed_time(ev), 4)
            for (_, prev), (name, ev) in zip(marks, marks[1:])}


def phase_train(steps: int = 10) -> tuple:
    """Returns K1's and K1b's launches in the ``train_step`` calls
    alone."""
    numpy_batch = train_batch(TRAIN_B, TRAIN_SECONDS, TRAIN_PHONES,
                              TRAIN_CHARS)
    audio_s = TRAIN_B * TRAIN_SECONDS
    launches = (0, 0)
    for dtype in ("bfloat16", "float32"):
        trainer = new_trainer(dtype, "cuda")
        cfg = trainer.model_cfg
        if (cfg.dmodel, cfg.num_blocks, cfg.dropout) != (144, 13, 0.1):
            raise AssertionError(f"not the full-width config: {cfg}")
        state = trainer.state
        batch = trainer._prepare_batch(numpy_batch)
        before = {k: v.clone() for k, v in state.model.named_buffers()}
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []

        def run():
            _, m = trainer.train_step(state, batch)             # warm
            torch.cuda.synchronize()
            losses.append(m["train_loss"])
            for _ in range(steps):
                t0 = time.perf_counter()
                _, m = trainer.train_step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(m["train_loss"])
            # and as the fit loop runs them: enqueued back to back, the
            # host waits once at the end
            t0 = time.perf_counter()
            for _ in range(steps):
                _, m = trainer.train_step(state, batch)
                losses.append(m["train_loss"])
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / steps

        pipelined, n = counted(run)
        if state.step != 2 * steps + 1:
            raise AssertionError(f"{state.step} train steps, not "
                                 f"{2 * steps + 1}")
        launches = add(launches, expect(n, state.step,
                                        f"{state.step} train steps"))
        values = [float(v) for v in torch.stack(losses).cpu()]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"non-finite train_loss: {values}")
        if not values[-1] < values[0]:
            raise AssertionError(f"train_loss did not fall: {values}")
        moved = [k for k, v in state.model.named_buffers()
                 if not torch.equal(v, before[k])]
        if len(moved) != len(before):
            raise AssertionError("BatchNorm running statistics that did not "
                                 f"move: {sorted(set(before) - set(moved))}")
        step = statistics.median(times)
        log(f"train: train_step {dtype} B={TRAIN_B} x {TRAIN_SECONDS} s, "
            f"{TRAIN_PHONES} phones, {TRAIN_CHARS} chars: median "
            f"{step * 1e3:.3f} ms (min {min(times) * 1e3:.3f}, max "
            f"{max(times) * 1e3:.3f}; {steps} steps, each waited for), "
            f"{audio_s / step:.1f} audio s/s; {steps} steps back to back "
            f"{pipelined * 1e3:.3f} ms a step, {audio_s / pipelined:.1f} "
            f"audio s/s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"train: {dtype} train_loss first {values[0]:.4f}, after "
            f"{steps} steps {values[steps]:.4f}, last {values[-1]:.4f}; "
            f"{len(moved)} BatchNorm buffers moved")
        # only where the card is the limit: the bf16 step's host runs
        # behind the card, so its marks would time the host's enqueueing
        if dtype == "float32":
            log(f"train: {dtype} stages (ms): "
                f"{json.dumps(train_stage_split(trainer, batch))}")
        del trainer, state, batch, before
        torch.cuda.empty_cache()
    return launches


def phase_train_card_vs_cpu() -> None:
    """One f32 loss + backward from the same weights, dropout 0, on the
    card (K1 frontend) and on the CPU (plain frontend); then ``ctc_loss``
    alone on both."""
    from tensorflowasr_tpu_torch.ops.ctc import ctc_loss
    from tensorflowasr_tpu_torch.train.asr_trainer import loss_and_metrics

    no_dropout = {"model_config": {"dropout": 0.0, "ctcdecoder_dropout": 0.0,
                                   "translator_dropout": 0.0}}
    numpy_batch = train_batch(2, 1.0, 8, 4)
    result = {}
    for device in ("cuda", "cpu"):
        trainer = new_trainer("float32", device, extra=no_dropout)
        model = trainer.state.model.train()
        total, _ = loss_and_metrics(model, trainer._prepare_batch(numpy_batch),
                                    trainer.blank_id)
        total.backward()
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.double().norm() for p in model.parameters()]))
        result[device] = (float(total.detach()), float(norm))
    (loss_gpu, norm_gpu), (loss_cpu, norm_cpu) = result["cuda"], result["cpu"]
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    norm_err = abs(norm_gpu - norm_cpu) / norm_cpu
    log(f"train: f32 card vs CPU on B=2 x 1 s, dropout 0: train_loss "
        f"{loss_gpu:.6f} vs {loss_cpu:.6f} (relative {loss_err:.3e}), "
        f"gradient norm {norm_gpu:.6f} vs {norm_cpu:.6f} (relative "
        f"{norm_err:.3e})")
    if not (math.isfinite(loss_gpu) and loss_err <= 1e-4
            and norm_err <= 1e-3):
        raise AssertionError("the train step on the card disagrees with "
                             "the CPU")

    # ctc_loss alone, floor 1e-7, blank last: row 2 has 3 frames for 9
    # labels (infeasible), row 3 an empty label
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((4, 50, N_PHONE)) * 2).astype(np.float32)
    labels = rng.integers(1, N_PHONE - 1, (4, 9)).astype(np.int64)
    logit_lengths = torch.tensor([50, 37, 3, 50])
    label_lengths = torch.tensor([9, 5, 9, 0])
    out = {}
    for device in ("cuda", "cpu"):
        x = torch.from_numpy(logits).to(device).requires_grad_()
        loss = ctc_loss(x, logit_lengths, torch.from_numpy(labels).to(device),
                        label_lengths, blank_id=N_PHONE - 1, prob_floor=1e-7)
        loss.sum().backward()
        out[device] = (loss.detach().cpu(), x.grad.cpu())
    loss_err = within(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-4)
    grad_err = within(out["cuda"][1], out["cpu"][1], rtol=0, atol=1e-4)
    if float(out["cuda"][0][2]) != 0.0 or \
            int(torch.count_nonzero(out["cuda"][1][2])) != 0:
        raise AssertionError("the infeasible row's loss or gradient is not 0")
    log(f"train: ctc_loss (floor 1e-7) card vs CPU on [4, 50, {N_PHONE}]: "
        f"max|err| loss {loss_err:.3e}, gradient {grad_err:.3e}; the "
        f"infeasible row has loss 0 and gradient 0")


def write_corpus(root: str, n_utts: int = 40) -> str:
    """A seeded corpus with full-size vocabularies; returns the data YAML."""
    import yaml

    from tensorflowasr_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(0)
    syllables = [f"s{i}" for i in range(N_CHAR - 3)]
    lines = []
    for i in range(n_utts):
        seconds = float(rng.uniform(1.0, 3.0))
        t = np.arange(int(seconds * SR)) / SR
        wav = 0.4 * np.sin(2 * np.pi * rng.uniform(120, 900) * t) \
            + 0.05 * rng.standard_normal(len(t))
        path = os.path.join(root, f"utt{i:03d}.wav")
        write_wav(path, wav.astype(np.float32), SR)
        words = rng.choice(len(syllables), size=int(rng.integers(2, 6)))
        lines.append(f"{path}\t{' '.join(syllables[w] for w in words)}")

    def put(name, text):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write(text)
        return os.path.join(root, name)

    put("train.list", "\n".join(lines[:32]))
    put("eval.list", "\n".join(lines[32:]))
    put("phones.txt", "\n".join(f"p{i}" for i in range(N_PHONE - 1)))
    put("chars.txt", "\n".join(["<S>", "</S>"] + syllables))
    put("p2p.map", "".join(
        f"{s}\tp{i % (N_PHONE - 1)} p{(7 * i + 3) % (N_PHONE - 1)}\n"
        for i, s in enumerate(syllables)))
    data = {
        "speech_config": {
            "sample_rate": SR, "stride_ms": 10, "num_feature_bins": 80,
            "reduction_factor": 4, "wav_max_duration": 4,
            "bucket_seconds": list(CLI_BUCKET_SECONDS),
            "train_list": os.path.join(root, "train.list"),
            "eval_list": os.path.join(root, "eval.list"),
            "pinyin_map": os.path.join(root, "p2p.map"),
            "transcripts_are_pinyin": True},
        "inp_config": {"vocabulary": os.path.join(root, "phones.txt"),
                       "blank_at_zero": False},
        "tar_config": {"vocabulary": os.path.join(root, "chars.txt"),
                       "blank_at_zero": False},
        "augments_config": None,
        "optimizer_config": {"lr": 1e-4, "beta1": 0.9, "beta2": 0.98,
                             "epsilon": 1e-6},
        "running_config": {"batch_size": CLI_B, "log_interval_steps": 2,
                           "eval_interval_steps": 1000,
                           "save_interval_steps": 3,
                           "outdir": os.path.join(root, "logs")},
    }
    return put("data.yml", yaml.safe_dump(data))


def phase_cli() -> tuple:
    """Returns K1's and K1b's launches in the two CLI calls."""
    from tensorflowasr_tpu_torch.cli import eval_am, train_asr

    root = os.path.dirname(os.path.abspath(__file__))
    model_yml = os.path.join(root, "configs", "conformerS.yml")
    with tempfile.TemporaryDirectory() as tmp:
        data_yml = write_corpus(tmp)
        common = ["--data_config", data_yml, "--model_config", model_yml,
                  "--device", "cuda", "--data_workers", "2"]

        def run():
            t0 = time.perf_counter()
            if train_asr.main(common + ["--total_steps", "6"]) != 0:
                raise AssertionError("cli.train_asr failed")
            t_train = time.perf_counter() - t0
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = eval_am.main(common + ["--max_batches", "2"])
            return rc, out.getvalue(), err.getvalue(), t_train, \
                time.perf_counter() - t0

        (rc, out, err, t_train, t_eval), launches = counted(run)
        ckpts = sorted(os.listdir(os.path.join(tmp, "logs", "checkpoints")))
        with open(os.path.join(tmp, "logs", "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
    if rc != 0 or "no checkpoint found" in err:
        raise AssertionError(f"cli.eval_am: rc {rc}, stderr {err[-400:]}")
    if ckpts != ["ckpt_000000003.pt", "ckpt_000000006.pt"]:
        raise AssertionError(f"checkpoints {ckpts}")
    if [m["step"] for m in logged] != [2, 4, 6] or not all(
            math.isfinite(m["train_loss"]) for m in logged):
        raise AssertionError(f"metrics.jsonl {logged}")
    result = json.loads(out.strip().splitlines()[-1])
    for key in ("phone_cer", "phone_ser", "char_cer", "char_ser"):
        if not math.isfinite(result[key]):
            raise AssertionError(f"eval_am: {key} = {result[key]}")
    if result["phone_N"] <= 0 or result["char_N"] <= 0:
        raise AssertionError(f"eval_am scored nothing: {result}")
    # 6 train steps, and 2 eval batches through predict_step
    expect(launches, 8, "the train_asr and eval_am calls")
    log(f"cli: train_asr bf16, 6 steps of B=8 in {t_train:.2f} s "
        f"(train_loss {logged[0]['train_loss']:.3f} -> "
        f"{logged[-1]['train_loss']:.3f}), checkpoints {ckpts}; eval_am "
        f"restored step 6 and scored 2 batches in {t_eval:.2f} s: "
        f"{json.dumps(result)}")
    return launches


# ---------------------------------------------------------------------------
# Chunk streaming (SMLTA2): ChunkConformer(S) from configs/chunk_conformerS.yml
# ---------------------------------------------------------------------------

POOL_SLOTS, POOL_TICKS, POOL_REPS = 256, 25, 10      # bench.py:239-286
OFFLINE_B, OFFLINE_SECONDS = 128, 7
STREAM_CHUNKS, STREAM_REPS = 50, 3   # bench.py:175-203: 50 chained chunks
CLI_CHUNKS = 50                      # the chunk CLI's wav: 8 s, 50 chunks
# K1's 'valid' shapes on the chunk path: the stream step's and the pool
# tick's mel of [wav tail | chunk], the offline batch, and the chunk CLI's
# offline decode of its one wav
CHUNK_K1_SHAPES = {"stream": (1, 2 * CHUNK_SAMPLES),
                   "pool": (POOL_SLOTS, 2 * CHUNK_SAMPLES),
                   "offline": (OFFLINE_B, OFFLINE_SECONDS * SR),
                   "cli": (1, CLI_CHUNKS * CHUNK_SAMPLES),
                   "chunk_train": (TRAIN_B, TRAIN_SECONDS * SR)}
# the chunk train CLI's buckets: the cli phase's, rounded up to whole chunks
CHUNK_CLI_SHAPES = [(CLI_B, -(-int(s * SR) // CHUNK_SAMPLES) * CHUNK_SAMPLES)
                    for s in CLI_BUCKET_SECONDS]
CHUNK_VS_CPU = (2, 8 * CHUNK_SAMPLES)       # the card-against-CPU batch


def chunk_models_logged() -> dict:
    """``serve/bench_chunk.py``'s f32 and bf16 models on the card."""
    models, moved = chunk_models(device="cuda")
    log(f"chunk: ChunkConformer(S) from configs/chunk_conformerS.yml, "
        f"seeded; first conv x10, blank bias moved by {moved:.4f} (the "
        f"median margin over 4 x 4 s of warm-up signals)")
    return models


def check_share(share: float, what: str) -> None:
    if not 0.2 <= share <= 0.8:
        raise AssertionError(f"the picker keeps {share:.1%} of the frames "
                             f"of {what}, not 20-80 %")


def phase_chunk_kernel() -> dict:
    """K1 and K1b 'valid' at the chunk path's shapes: held against their
    plain versions, then timed with the plain versions and ``torch.stft``."""
    shapes = [*CHUNK_K1_SHAPES.values(), *CHUNK_CLI_SHAPES, CHUNK_VS_CPU]
    held = [hold_k1("valid", b, t) for b, t in shapes]
    out = {"max_abs_err": max(h[0] for h in held),
           "log_mel_max_abs_err": max(h[2] for h in held),
           "log_mel": {}}
    out["train_cli"] = []
    for b, t in CHUNK_CLI_SHAPES:
        times = time_k1("valid", b, t, reps=20, graph=True)
        out["train_cli"].append(k1_numbers(b, t, times))
        log(f"chunk_kernel: K1 valid B={b} T={t} (a chunk train cli bucket):"
            f" kernel {fmt_times(times['kernel'])}; kernel replayed from a "
            f"CUDA graph {fmt_times(times['kernel_graph'])}; plain "
            f"{fmt_times(times['plain'])}; library {fmt_times(times['library'])}"
            f"; bound_ms {times['bound_ms']:.6f} by {times['bound_by']} "
            f"({times['bytes']:.4e} B)")
    for name, (b, t) in CHUNK_K1_SHAPES.items():
        # the stream, pool and cli shapes are 20 KB, 5 MB and 0.5 MB in:
        # events time the host's enqueue rate there, a graph replay the
        # device's own; at the train batch both are given
        small = name != "offline"
        times = time_k1("valid", b, t, reps=50, graph=small)
        out[name] = k1_numbers(b, t, times)
        replay = ""
        if small:
            replay = (f"; kernel replayed from a CUDA graph "
                      f"{fmt_times(times['kernel_graph'])}")
        log(f"chunk_kernel: K1 valid B={b} T={t} ({name}): kernel "
            f"{fmt_times(times['kernel'])}{replay}; plain "
            f"{fmt_times(times['plain'])}; library (torch.stft, left pad "
            f"1023, center=False, + abs()**2) {fmt_times(times['library'])}"
            f"; bound_ms {times['bound_ms']:.6f} by {times['bound_by']} "
            f"({times['bytes']:.4e} B, {times['flops']:.4e} FFT FLOP)")
        if name == "cli":
            continue
        times = time_k1("valid", b, t, reps=50, graph=small, log_mel=True)
        out["log_mel"][name] = k1_numbers(b, t, times)
        log_k1b("chunk_kernel", f"valid B={b} T={t} ({name})", times)
    return out


def phase_chunk_offline(models: dict, reps: int = 5) -> int:
    """``make_chunk_predict_step`` at B = 128 x 7 s. Returns K1's and K1b's
    launches in the timed calls."""
    from tensorflowasr_tpu_torch.train.chunk_trainer import (
        make_chunk_predict_step,
    )

    dev = torch.device("cuda")
    wav = torch.from_numpy(np.stack([
        tones(OFFLINE_SECONDS, seed=100 + i) for i in range(OFFLINE_B)])
    ).to(dev)
    t_enc = OFFLINE_SECONDS * SR // 640
    in_len = torch.full((OFFLINE_B,), t_enc, dtype=torch.int32, device=dev)
    launches = (0, 0)
    for dtype, model in models.items():
        step = make_chunk_predict_step(model)
        torch.cuda.reset_peak_memory_stats()

        def run():
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = step(wav, in_len)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            return times, out

        step(wav, in_len)                                   # warm-up
        (times, out), n = counted(run)
        launches = add(launches, expect(n, reps,
                                        f"{reps} chunk predict calls"))
        char_ids, char_lens, phone_ids, phone_lens = out
        if tuple(phone_ids.shape) != (OFFLINE_B, t_enc) or \
                tuple(char_ids.shape) != (OFFLINE_B, t_enc):
            raise AssertionError(f"shapes {tuple(phone_ids.shape)} "
                                 f"{tuple(char_ids.shape)}")
        with torch.no_grad():
            _, _, counts = model.predict(wav, None)
        share = float(counts.sum()) / (OFFLINE_B * t_enc)
        check_share(share, "the offline batch")
        if int(counts.min()) <= 0 or int(phone_lens.min()) <= 0 or \
                int(char_ids.max()) >= N_CHAR:
            raise AssertionError("a row picked nothing or decoded nothing")
        step_s = statistics.median(times)
        log(f"chunk_offline: make_chunk_predict_step {dtype} B={OFFLINE_B} "
            f"x {OFFLINE_SECONDS} s: median {step_s * 1e3:.3f} ms (min "
            f"{min(times) * 1e3:.3f}, {reps} calls), per-stream RTF "
            f"{step_s / (OFFLINE_B * OFFLINE_SECONDS):.3e}; picked "
            f"{int(counts.min())}-{int(counts.max())} of {t_enc} frames a "
            f"row ({share:.1%}); char lengths {int(char_lens.min())}-"
            f"{int(char_lens.max())}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def chained(step, n: int):
    """``step()`` n times with every implicit host sync an error, then one
    sync: returns the seconds per call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n


def phase_chunk_stream(models: dict) -> int:
    """One stream: ``fused_stream_step`` chained on its caches (device
    only) and ``ChunkStreamSession`` (a fetch a chunk), in f32 and bf16;
    then, in f32, the session against the offline decode and the card's
    picker logits against the CPU's. Returns K1's and K1b's launches in the
    timed runs."""
    from tensorflowasr_tpu_torch.models.chunk_conformer import ChunkConformer
    from tensorflowasr_tpu_torch.serve.chunk_session import (
        ChunkStreamSession,
        collapse,
    )

    dev = torch.device("cuda")
    signal = tones(STREAM_CHUNKS * CHUNK_S, seed=70)             # 8 s
    chunks = torch.from_numpy(signal.reshape(STREAM_CHUNKS, 1, -1)).to(dev)
    launches, results = (0, 0), {}
    for dtype, model in models.items():
        state = {}

        def device_only():
            times = []
            for _ in range(STREAM_REPS):
                state["caches"] = model.init_stream_caches(1)
                state["i"] = 0

                def step():
                    out = model.fused_stream_step(chunks[state["i"]],
                                                  state["caches"])
                    state["caches"] = out[4]
                    state["i"] += 1

                times.append(chained(step, STREAM_CHUNKS))
            return times

        session = ChunkStreamSession(model, device="cuda")

        def wall():
            session.reset()
            times = []
            for i in range(STREAM_CHUNKS):
                t0 = time.perf_counter()
                session.feed(signal[i * CHUNK_SAMPLES:(i + 1) * CHUNK_SAMPLES])
                times.append(time.perf_counter() - t0)
            return times, session.flush()

        with torch.no_grad():
            for i in range(3):                                  # warm-up
                model.fused_stream_step(chunks[i],
                                        model.init_stream_caches(1))
            session.feed(signal[:CHUNK_SAMPLES])
            dev_times, n_dev = counted(device_only)
            (wall_times, result), n_wall = counted(wall)
        expect(n_dev, STREAM_REPS * STREAM_CHUNKS,
               "the chained stream steps")
        expect(n_wall, STREAM_CHUNKS, "the session's chunks")
        launches = add(launches, add(n_dev, n_wall))
        results[dtype] = result
        best, med = min(dev_times), statistics.median(wall_times)
        log(f"chunk_stream: {dtype} fused_stream_step, device only "
            f"({STREAM_CHUNKS} chained chunks, one sync, no implicit sync "
            f"under set_sync_debug_mode('error')): best "
            f"{best * 1e3:.3f} ms a chunk (median "
            f"{statistics.median(dev_times) * 1e3:.3f} of {STREAM_REPS}), "
            f"RTF {best / CHUNK_S:.4f}; ChunkStreamSession wall (a fetch a "
            f"chunk): median {med * 1e3:.3f} ms a chunk (min "
            f"{min(wall_times) * 1e3:.3f}, max {max(wall_times) * 1e3:.3f}),"
            f" RTF {med / CHUNK_S:.4f}; {len(result['phone_ids'])} phones, "
            f"{len(result['char_ids'])} chars on the 8 s signal")

    # f32: streaming ids = the offline decode, on the card
    f32 = models["float32"]
    with torch.no_grad():
        logits, _ = f32.encode_to_phones(torch.from_numpy(signal[None])
                                         .to(dev))
    ids = logits[0].argmax(-1)
    share = float((ids != N_PHONE - 1).float().mean())
    check_share(share, "the 8 s signal")
    offline = collapse(ids.tolist(), N_PHONE - 1)
    if results["float32"]["phone_ids"] != offline:
        raise AssertionError("the session's phone ids differ from the "
                             "offline decode")
    top2 = logits[0].topk(2, dim=-1).values
    log(f"chunk_stream: f32 session phone ids = offline encode_to_phones "
        f"argmax, collapsed ({share:.1%} of the frames picked, "
        f"{len(offline)} phones; smallest top-2 margin "
        f"{float((top2[:, 0] - top2[:, 1]).min()):.3e})")

    # f32 picker logits on the card against the CPU port, same weights
    cpu = ChunkConformer(f32.cfg, N_PHONE, N_CHAR)
    cpu.load_state_dict({k: v.cpu() for k, v in f32.state_dict().items()})
    cpu.eval()
    errs = []
    with torch.no_grad():
        caches_gpu, caches_cpu = f32.init_picker_caches(1), \
            cpu.init_picker_caches(1)
        for i in range(6):
            lg, _, _, caches_gpu = f32.picker_stream_step(chunks[i],
                                                          caches_gpu)
            lc, _, _, caches_cpu = cpu.picker_stream_step(chunks[i].cpu(),
                                                          caches_cpu)
            errs.append(within(lg.cpu(), lc, rtol=0, atol=1e-3))
    log(f"chunk_stream: f32 picker_stream_step logits, card vs CPU over 6 "
        f"chunks: max|err| {max(errs):.3e}")
    return launches


def pool_requests(model, seconds=(2.0, 3.5, 5.0, 8.0)) -> None:
    """4 streams fed to a 256-slot pool in interleaved odd-sized packets,
    the 4th opened when the first closes: each result must equal an
    independent ``ChunkStreamSession``'s."""
    from tensorflowasr_tpu_torch.serve.chunk_session import (
        ChunkStreamSession,
    )
    from tensorflowasr_tpu_torch.serve.multi_session import (
        MultiStreamChunkServer,
    )

    wavs = [tones(s, seed=80 + i) for i, s in enumerate(seconds)]
    singles = []
    for w in wavs:
        session = ChunkStreamSession(model, device="cuda")
        session.feed(w)
        singles.append(session.flush())
    server = MultiStreamChunkServer(model, n_slots=POOL_SLOTS, device="cuda")

    def packets(w, sizes=(2203, 777, 4100, 1501)):
        cuts = np.cumsum(np.resize(sizes, len(w) // min(sizes) + 1))
        return [p for p in np.split(w, cuts) if len(p)]

    queues, stream_of, got = {}, {}, {}
    for i in range(3):
        slot = server.open()
        queues[slot], stream_of[slot] = packets(wavs[i]), i
    t0, ticks = time.perf_counter(), 0
    while queues:
        for slot in list(queues):
            server.feed(slot, queues[slot].pop(0))
        server.tick()
        ticks += 1
        for slot in [s for s in queues if not queues[s]]:
            got[stream_of[slot]] = server.close(slot)
            del queues[slot]
            if 3 not in stream_of.values():
                new = server.open()
                queues[new], stream_of[new] = packets(wavs[3]), 3
    wall = time.perf_counter() - t0
    if [got[i] for i in range(len(wavs))] != singles:
        raise AssertionError("the pool's results differ from independent "
                             "sessions")
    log(f"chunk_pool: f32 request check: {len(wavs)} streams of {seconds} s "
        f"in odd-sized packets through {POOL_SLOTS} slots ({ticks} feed "
        f"rounds, {wall:.2f} s) = {len(wavs)} independent sessions "
        f"(phones {[len(r['phone_ids']) for r in singles]}, chars "
        f"{[len(r['char_ids']) for r in singles]})")


def phase_chunk_pool(models: dict) -> int:
    """``MultiStreamChunkServer``'s step over 256 slots, f32 and bf16: the
    tick chained on its caches (best of 10 x 25), and the server's own
    ticks (upload, step, fetch); then the request check. Returns K1's and
    K1b's launches."""
    from tensorflowasr_tpu_torch.serve.multi_session import (
        MultiStreamChunkServer,
    )

    dev = torch.device("cuda")
    signal = np.stack([tones(POOL_TICKS * CHUNK_S, seed=200 + i)
                       for i in range(POOL_SLOTS)])
    first = torch.from_numpy(signal[:, :CHUNK_SAMPLES].copy()).to(dev)
    launches = (0, 0)
    for dtype, model in models.items():
        torch.cuda.reset_peak_memory_stats()
        server = MultiStreamChunkServer(model, n_slots=POOL_SLOTS,
                                        device="cuda")

        def ticks():
            times = []
            for _ in range(POOL_REPS):
                state = {"caches": model.init_multi_stream_caches(POOL_SLOTS)}

                def step():
                    *ids, state["caches"] = model.batched_stream_step(
                        first, state["caches"])
                    state["sum"] = sum(x.sum() for x in ids)

                times.append(chained(step, POOL_TICKS))
            slots = [server.open() for _ in range(POOL_SLOTS)]
            for slot in slots:
                server.feed(slot, signal[slot])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server.tick()                        # drains POOL_TICKS chunks
            served = (time.perf_counter() - t0) / POOL_TICKS
            for slot in slots:
                server.close(slot)
            return times, served

        with torch.no_grad():
            model.batched_stream_step(
                first, model.init_multi_stream_caches(POOL_SLOTS))  # warm
            (times, served), n = counted(ticks)
        launches = add(launches, expect(
            n, POOL_REPS * POOL_TICKS + POOL_TICKS, "the ticks"))
        tick_s = min(times)
        log(f"chunk_pool: {dtype} batched_stream_step over {POOL_SLOTS} "
            f"slots, chained (one sync, no implicit sync): best "
            f"{tick_s * 1e3:.3f} ms a tick (median "
            f"{statistics.median(times) * 1e3:.3f} of {POOL_REPS} x "
            f"{POOL_TICKS}) -> {POOL_SLOTS * CHUNK_S / tick_s:.1f} streams "
            f"in real time, per-stream RTF {tick_s / CHUNK_S:.4f}; "
            f"MultiStreamChunkServer.tick (upload, step, fetch) "
            f"{served * 1e3:.3f} ms a tick -> "
            f"{POOL_SLOTS * CHUNK_S / served:.1f} streams; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with torch.no_grad():
        launches = add(launches, counted(
            lambda: pool_requests(models["float32"]))[1])
    return launches


def phase_chunk_cli(model) -> int:
    """``cli.test_chunk_asr --device cuda`` on an 8 s wav, with ``model``'s
    weights written as a flax ``.npz`` for ``--weights``: the streamed
    phones must equal the offline ones. Returns K1's and K1b's
    launches."""
    from tensorflowasr_tpu_torch.cli import test_chunk_asr
    from tensorflowasr_tpu_torch.models.convert import save_npz
    from tensorflowasr_tpu_torch.utils.audio import write_wav

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        data_yml = write_corpus(tmp)            # full-size vocabularies
        wav_path, npz = os.path.join(tmp, "utt.wav"), \
            os.path.join(tmp, "chunk.npz")
        write_wav(wav_path, tones(CLI_CHUNKS * CHUNK_S, seed=90), SR)
        save_npz(model, npz)
        args = ["--data_config", data_yml, "--model_config",
                os.path.join(root, "configs", "chunk_conformerS.yml"),
                "--wav", wav_path, "--weights", npz, "--device", "cuda",
                "--compute_dtype", "float32"]
        out = io.StringIO()

        def run():
            with contextlib.redirect_stdout(out):
                return test_chunk_asr.main(args)

        rc, launches = counted(run)
    lines = dict(line.split(":", 1) for line in out.getvalue().splitlines()
                 if ":" in line and not line.startswith("audio"))
    offline, stream = lines["offline phones"].split(), \
        lines["stream  phones"].split()
    if rc != 0 or not offline or stream != offline:
        raise AssertionError(f"cli.test_chunk_asr: rc {rc}, offline phones "
                             f"{offline[:20]}, streamed {stream[:20]}")
    # offline: a warm-up and the timed decode; the session: a warm-up chunk
    # and one launch a chunk (the wav is whole chunks, so no flush step)
    expect(launches, 3 + CLI_CHUNKS, "the chunk CLI")
    summary = out.getvalue().strip().splitlines()[-1]
    log(f"chunk_cli: cli.test_chunk_asr --weights (the f32 model as a flax "
        f".npz) --device cuda on an {CLI_CHUNKS * CHUNK_S:.0f} s wav: "
        f"streamed phones = offline phones ({len(offline)}); {summary}")
    return launches



# ---------------------------------------------------------------------------
# Chunk training: ChunkTrainer on ChunkConformer(S)
# ---------------------------------------------------------------------------

def picks(trainer, batch) -> tuple:
    """(picked share, t_ref) of one training-mode forward without
    gradients; the BatchNorm running statistics stay where they are."""
    from tensorflowasr_tpu_torch.models.layers import BatchNorm
    from tensorflowasr_tpu_torch.train.chunk_trainer import label_width

    model = trainer.state.model.train()
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.track_stats = False
    try:
        with torch.no_grad():
            fwd = model.train_forward(batch["wav"], batch["extra_phones"],
                                      trainer.max_pick,
                                      label_width=label_width(batch))
    finally:
        for m in norms:
            m.track_stats = True
    counts = fwd["picked_counts"]
    share = float(counts.sum()) / (counts.numel()
                                   * fwd["phone_logits"].shape[1])
    return share, int(fwd["t_ref"])


def sync_points(step) -> dict:
    """``step()`` once with every implicit host sync reported
    (``set_sync_debug_mode("warn")``): {(the port's innermost line on the
    stack, the message): count}."""
    root = os.path.dirname(os.path.abspath(__file__))
    found = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "is a prototype feature" in str(message):
            return                  # set_sync_debug_mode's own notice
        ours = [f for f in traceback.extract_stack()
                if "tensorflowasr_tpu_torch" in f.filename]
        where = (f"{os.path.relpath(ours[-1].filename, root)}:"
                 f"{ours[-1].lineno}" if ours else f"{filename}:{lineno}")
        key = (where, str(message).splitlines()[0][:100])
        found[key] = found.get(key, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return found


def chunk_train_stage_split(trainer, batch) -> dict:
    """CUDA-event times of one more chunk ``train_step``'s stages, in ms."""
    from tensorflowasr_tpu_torch.train.chunk_trainer import (
        make_chunk_train_step,
    )

    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    step = make_chunk_train_step(trainer.max_pick, trainer.txt_ctc_length,
                                 trainer.loss_reduction, mark=mark)
    mark("start")
    step(trainer.state, batch)
    torch.cuda.synchronize()
    return {name: round(prev.elapsed_time(ev), 4)
            for (_, prev), (name, ev) in zip(marks, marks[1:])}


def phase_chunk_train(steps: int = 10) -> int:
    """Returns K1's and K1b's launches in the chunk ``train_step`` calls
    alone."""
    numpy_batch = chunk_train_batch()
    audio_s = TRAIN_B * TRAIN_SECONDS
    launches = (0, 0)
    for dtype in ("float32", "bfloat16"):
        trainer = new_chunk_trainer(dtype, "cuda")
        state = trainer.state
        batch = trainer._prepare_batch(numpy_batch)
        before = picks(trainer, batch)
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []

        def run():
            _, m = trainer.train_step(state, batch)             # warm
            torch.cuda.synchronize()
            losses.append(m["train_loss"])
            t0 = time.perf_counter()
            for _ in range(steps):
                _, m = trainer.train_step(state, batch)
                losses.append(m["train_loss"])
            torch.cuda.synchronize()
            back = (time.perf_counter() - t0) / steps
            for _ in range(steps):
                t0 = time.perf_counter()
                _, m = trainer.train_step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                losses.append(m["train_loss"])
            return back

        pipelined, n = counted(run)
        if state.step != 2 * steps + 1:
            raise AssertionError(f"{state.step} chunk train steps, not "
                                 f"{2 * steps + 1}")
        launches = add(launches, expect(n, state.step,
                                        f"{state.step} chunk train steps"))
        peak = torch.cuda.max_memory_allocated() / 2**30
        values = [float(v) for v in torch.stack(losses).cpu()]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"non-finite train_loss: {values}")
        after = picks(trainer, batch)
        step = statistics.median(times)
        log(f"chunk_train: train_step {dtype} B={TRAIN_B} x {TRAIN_SECONDS} "
            f"s, 64 + 64 phones, 32 + 32 chars: {steps} steps back to back "
            f"{pipelined * 1e3:.3f} ms a step, {audio_s / pipelined:.1f} "
            f"audio s/s; median {step * 1e3:.3f} ms (min "
            f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}; {steps} "
            f"steps, each waited for), {audio_s / step:.1f} audio s/s; peak "
            f"memory {peak:.2f} GiB; K1 and K1b launches {n}")
        log(f"chunk_train: {dtype} train_loss first {values[0]:.4f}, last "
            f"{values[-1]:.4f}; picked {before[0]:.1%} of the frames, t_ref "
            f"{before[1]} before the steps, {after[0]:.1%} and t_ref "
            f"{after[1]} after")
        if dtype == "float32":
            log(f"chunk_train: {dtype} stages (ms): "
                f"{json.dumps(chunk_train_stage_split(trainer, batch))}")
        found = sync_points(lambda: trainer.train_step(state, batch))
        if found:
            log(f"chunk_train: warning: a {dtype} train step waits for the "
                f"device {sum(found.values())} times: " + "; ".join(
                    f"{n} x {where} ({msg})"
                    for (where, msg), n in sorted(found.items())))
        else:
            chained(lambda: trainer.train_step(state, batch), 1)
            log(f"chunk_train: {dtype} train step has no implicit sync")
        del trainer, state, batch
        torch.cuda.empty_cache()
    return launches


def phase_chunk_train_card_vs_cpu() -> None:
    """One f32 loss + backward of the same weights on the card (K1) and on
    the CPU (plain frontend), in training mode."""
    from tensorflowasr_tpu_torch.train.chunk_trainer import (
        ChunkTrainer,
        label_width,
        losses_from_outputs,
    )

    numpy_batch = chunk_train_batch(CHUNK_VS_CPU[0],
                                    CHUNK_VS_CPU[1] / SR, 8, 4, 8, 4)
    card = new_chunk_trainer("float32", "cuda")
    cpu = ChunkTrainer(card.config, N_PHONE, N_CHAR, device="cpu")
    cpu.init_state()
    cpu.state.model.load_state_dict({k: v.cpu() for k, v in
                                     card.state.model.state_dict().items()})
    result = {}
    for name, trainer in (("cuda", card), ("cpu", cpu)):
        model = trainer.state.model.train()
        batch = trainer._prepare_batch(numpy_batch)
        fwd = model.train_forward(batch["wav"], batch["extra_phones"], None,
                                  label_width=label_width(batch))
        total, _ = losses_from_outputs(fwd, batch, N_PHONE, N_CHAR)
        total.backward()
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.double().norm() for p in model.parameters()]))
        result[name] = (float(total.detach()), float(norm),
                        fwd["picked_counts"].cpu().tolist(),
                        int(fwd["t_ref"]))
    (loss_gpu, norm_gpu, picked, t_ref), (loss_cpu, norm_cpu, picked_cpu,
                                          _) = result["cuda"], result["cpu"]
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    norm_err = abs(norm_gpu - norm_cpu) / norm_cpu
    log(f"chunk_train: f32 card vs CPU on B={CHUNK_VS_CPU[0]} x "
        f"{CHUNK_VS_CPU[1] / SR} s, full width: picked {picked} of "
        f"{CHUNK_VS_CPU[1] // 640} frames on both (t_ref {t_ref}), loss "
        f"{loss_gpu:.6f} vs {loss_cpu:.6f} (relative {loss_err:.3e}), "
        f"gradient norm {norm_gpu:.6f} vs {norm_cpu:.6f} (relative "
        f"{norm_err:.3e})")
    if picked != picked_cpu or not (math.isfinite(loss_gpu)
                                    and loss_err <= 1e-4
                                    and norm_err <= 1e-3):
        raise AssertionError("the chunk train step on the card disagrees "
                             f"with the CPU (picks {picked} / {picked_cpu})")


def phase_chunk_train_cli() -> int:
    """``cli.train_asr`` with the chunk config, then ``cli.eval_am`` and
    ``cli.test_chunk_asr`` restoring its checkpoint. Returns K1's and K1b's
    launches."""
    from tensorflowasr_tpu_torch.cli import eval_am, test_chunk_asr, train_asr
    from tensorflowasr_tpu_torch.utils.audio import write_wav

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        data_yml = write_corpus(tmp)
        wav_path = os.path.join(tmp, "utt.wav")
        write_wav(wav_path, tones(CLI_CHUNKS * CHUNK_S, seed=91), SR)
        common = ["--data_config", data_yml, "--model_config",
                  os.path.join(root, "configs", "chunk_conformerS.yml"),
                  "--device", "cuda", "--compute_dtype", "float32"]

        def quiet(main, args):
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = main(args)
            return rc, out.getvalue(), err.getvalue(), \
                time.perf_counter() - t0

        def run():
            t0 = time.perf_counter()
            if train_asr.main(common + ["--total_steps", "3",
                                        "--data_workers", "2"]) != 0:
                raise AssertionError("cli.train_asr (chunk) failed")
            return (time.perf_counter() - t0,
                    quiet(eval_am.main, common + ["--max_batches", "1"]),
                    quiet(test_chunk_asr.main, common + ["--wav", wav_path]))

        (t_train, evaluated, tested), launches = counted(run)
        ckpts = sorted(os.listdir(os.path.join(tmp, "logs", "checkpoints")))
        with open(os.path.join(tmp, "logs", "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
    for what, (rc, _, err, _) in (("eval_am", evaluated),
                                  ("test_chunk_asr", tested)):
        if rc != 0 or "no checkpoint found" in err:
            raise AssertionError(f"cli.{what}: rc {rc}, stderr {err[-400:]}")
    if ckpts != ["ckpt_000000003.pt"]:
        raise AssertionError(f"checkpoints {ckpts}")
    if [m["step"] for m in logged] != [2] or not math.isfinite(
            logged[0]["train_loss"]):
        raise AssertionError(f"metrics.jsonl {logged}")
    result = json.loads(evaluated[1].strip().splitlines()[-1])
    for key in ("phone_cer", "phone_ser", "char_cer", "char_ser"):
        if not math.isfinite(result[key]):
            raise AssertionError(f"eval_am: {key} = {result[key]}")
    lines = dict(line.split(":", 1) for line in tested[1].splitlines()
                 if ":" in line and not line.startswith("audio"))
    offline, stream = lines["offline phones"].split(), \
        lines["stream  phones"].split()
    if stream != offline:
        raise AssertionError(f"cli.test_chunk_asr: offline phones "
                             f"{offline[:20]}, streamed {stream[:20]}")
    # 3 train steps, 1 eval batch; the test CLI's warm-up and timed offline
    # decode, its warm-up chunk and one launch a chunk
    expect(launches, 3 + 1 + 3 + CLI_CHUNKS,
           "the chunk train CLI calls")
    log(f"chunk_train_cli: train_asr f32, 3 steps of B={CLI_B} in "
        f"{t_train:.2f} s (train_loss {logged[0]['train_loss']:.3f} at step "
        f"2), checkpoints {ckpts}; eval_am restored step 3 and scored 1 "
        f"batch in {evaluated[3]:.2f} s: {json.dumps(result)}; "
        f"test_chunk_asr restored step 3: streamed phones = offline phones "
        f"({len(offline)}) on an {CLI_CHUNKS * CHUNK_S:.0f} s wav; "
        f"{tested[1].strip().splitlines()[-1]}")
    return launches



def main() -> int:
    name = phase_device()
    phase_build()
    k1 = phase_kernel()
    models, batched = phase_serve()
    requested = phase_requests(models["float32"])
    del models
    torch.cuda.empty_cache()
    trained = phase_train()
    phase_train_card_vs_cpu()
    cli = phase_cli()
    torch.cuda.empty_cache()
    k1_chunk = phase_chunk_kernel()
    models = chunk_models_logged()
    chunk = {"offline": phase_chunk_offline(models),
             "stream": phase_chunk_stream(models),
             "pool": phase_chunk_pool(models),
             "cli": phase_chunk_cli(models["float32"])}
    del models
    torch.cuda.empty_cache()
    chunk["chunk_train"] = phase_chunk_train()
    phase_chunk_train_card_vs_cpu()
    chunk["train_cli"] = phase_chunk_train_cli()
    phases = {"predict_step calls": batched, "session's requests": requested,
              "train steps": trained, "train_asr and eval_am CLI calls": cli,
              "chunk predict calls": chunk["offline"],
              "one-stream chunk steps": chunk["stream"],
              "pool's ticks and the request check": chunk["pool"],
              "test_chunk_asr CLI call": chunk["cli"],
              "chunk train steps": chunk["chunk_train"],
              "chunk train_asr, eval_am and test_chunk_asr CLI calls":
                  chunk["train_cli"]}
    launches = (0, 0)
    for n in phases.values():
        launches = add(launches, n)
    log(f"launches on the main path: K1 {launches[0]}, K1b {launches[1]} ("
        + ", ".join(f"{n[0]} and {n[1]} in the {what}"
                    for what, n in phases.items()) + ")")
    if min(min(n) for n in phases.values()) == 0:
        raise AssertionError("the main path did not launch K1 and K1b in "
                             "every phase")

    entry = {
        "name": "power_spectrogram", "route": "cuda",
        "source": "tensorflowasr_tpu_torch/csrc/power_spectrogram.cu",
        "replaces": "tensorflowasr_tpu/ops/pallas_frontend.py:77",
        # every launch of the FFT kernel, in any epilogue: on the main path
        # each is K1b's FFT pass (kPowerMax for 'same', the fused kLogMel
        # for 'valid'), while ms is that of K1's own power-only launch
        "launches": launches[0],
        "launches_are": "the FFT pass of each K1b call (power and row max "
                        "for 'same', the fused log-mel for 'valid'); ms, "
                        "plain_ms and bound_ms are K1's power-only launch",
        "max_abs_err": max(k1["max_abs_err"], k1_chunk["max_abs_err"]),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        # the numbers above are the batched serving shape's (B=128 x 7 s)
        "batch": k1["batch"], "samples": k1["samples"],
        "request_shape": k1["request_shape"],
        "train_shape": k1["train_shape"],
        "cli_shapes": k1["cli_shapes"],
        # 'valid' on the chunk path; launches are those of the phase
        "valid_shapes": {key: dict(k1_chunk[key], launches=chunk[key][0])
                         for key in CHUNK_K1_SHAPES},
        "valid_train_cli_shapes": {"shapes": k1_chunk["train_cli"],
                                   "launches": chunk["train_cli"][0]},
    }
    serve = k1["log_mel"]["serve"]
    log_mel = {
        "name": "log_mel_spectrogram", "route": "cuda",
        "source": "tensorflowasr_tpu_torch/csrc/power_spectrogram.cu",
        "replaces": "tensorflowasr_tpu/ops/pallas_frontend.py:136",
        # one a log-mel computed
        "launches": launches[1],
        "max_abs_err": max(k1["log_mel_max_abs_err"],
                           k1_chunk["log_mel_max_abs_err"]),
        "ms": serve["ms"], "plain_ms": serve["plain_ms"],
        # banded: the work the shipped basis needs (dense_bound_ms beside)
        "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
        # the numbers above are 'same' at B=128 x 7 s
        "batch": serve["batch"], "samples": serve["samples"],
        "dense_bound_ms": serve["dense_bound_ms"],
        "replaced_ms": serve["replaced_ms"],
        "same_shapes": {key: k1["log_mel"][key]
                        for key in ("train", "request")},
        "valid_shapes": {key: dict(k1_chunk["log_mel"][key],
                                   launches=chunk[key][1])
                         for key in k1_chunk["log_mel"]},
    }
    log(json.dumps({"kernels": [entry, log_mel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
