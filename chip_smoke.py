"""Drive the PyTorch port's offline ConformerCTC(S) serving and training
paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  - the card's name and power limit (nvidia-smi); raises without
             CUDA.
2. build   - nvcc builds every kernel in ``tensorflowasr_tpu_torch/csrc``.
3. kernel  - K1 (the power-spectrogram kernel, one FFT per frame in shared
             memory) against its plain PyTorch version, TF32 off, at every
             shape a later phase gives it: 'same' at B=128 x 7 s (serve),
             the one-chunk request shape (B=1 x 7680 samples), the train
             batch (B=128 x 8 s), the cli phase's buckets (B=8 x 2 s and
             4 s) and the card-against-CPU batch (B=2 x 1 s); and 'valid'
             at B=16 x 7680 samples and a ragged T, so that both of its
             slab-copy paths are taken; power within rtol 2e-4 / atol 2e-3,
             log-mel within rtol 1e-3 / atol 5e-2. Times the kernel, the
             plain version and ``torch.stft`` at the serve, the request and
             the train shape, each with median, minimum and spread, beside
             that shape's bound.
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

K1's launch count is set to 0 just before the ``predict_step`` calls, the
session's 4 requests, each dtype's train steps and the two CLI calls, and
read just after each; all must have launched it. The stage breakdowns and
the card-vs-CPU checks run outside those windows. K1's times at the request
and the train shape go on ``k1_request_shape`` and ``k1_train_shape`` JSON
lines in the kernel phase. The last lines are a JSON line of kernel numbers
(K1's times at the serve shape, with those two shapes' beside them and the
largest error over all shapes), then ``{"ok": true, "device": {...}}``.
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

import numpy as np
import torch

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

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

REQUEST_SAMPLES = 7680               # ASREngine's 0.48 s chunk at B = 1
CLI_B, CLI_BUCKET_SECONDS = 8, (2.0, 4.0)    # the cli phase's batches
POWER_TOL = dict(rtol=2e-4, atol=2e-3)
LOGMEL_TOL = dict(rtol=1e-3, atol=5e-2)


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
    log("kernels: K1 power_spectrogram (csrc/power_spectrogram.cu) "
        "replaces pallas_frontend.py::power_spectrogram_pallas; K1b "
        "log_mel_spectrogram_pallas is K1 + the plain dB/mel epilogue")


def time_k1(padding: str, b: int, t: int, reps: int, graph: bool = False
            ) -> dict:
    """Times of K1, its plain version and ``torch.stft`` on one input, and
    the bound for that input; with ``graph`` also K1 replayed from a CUDA
    graph."""
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

    def library():
        spec = torch.stft(padded, n_fft, cfg.hop, window=window,
                          center=False, return_complex=True)
        return spec.abs() ** 2

    within(library().transpose(1, 2), fe.power_spectrogram_reference(
        wav, cfg), **POWER_TOL)
    kernel = cuda_times(lambda: fe.power_spectrogram(wav, cfg), reps, 10)
    plain = cuda_times(lambda: fe.power_spectrogram_reference(wav, cfg),
                       max(reps // 5, 5), 2)
    lib = cuda_times(library, max(reps // 2, 5), 5)
    replayed = graph_times(lambda: fe.power_spectrogram(wav, cfg), reps,
                           20) if graph else None
    # The bound counts the least work the function needs: per frame the
    # window product, a real FFT of n_fft points (2.5 n log2 n FLOP, half a
    # complex FFT's 5 n log2 n) and re^2 + im^2 per bin; the wav read once
    # and the power written once.
    flops = b * n_frames * (n_fft + 2.5 * n_fft * math.log2(n_fft)
                            + 3 * n_freq)
    nbytes = 4.0 * (b * t + b * n_frames * n_freq)
    by_ops, by_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return {"kernel": kernel, "kernel_graph": replayed, "plain": plain,
            "library": lib, "flops": flops, "bytes": nbytes,
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops > by_bytes else "bytes"}


def phase_kernel() -> dict:
    from tensorflowasr_tpu_torch.ops import frontend as fe
    from tensorflowasr_tpu_torch.ops import power_spectrogram as k1

    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    # 'same' batched and the one-chunk request take 16-byte slab copies;
    # 'valid' (left pad 1023) and the ragged row stride take 4-byte ones.
    # Then the shapes the later phases give K1: the train batch, the cli
    # phase's two buckets, the card-against-CPU batch
    shapes = (("same", 128, 7 * SR), ("valid", 16, 2560 * 3),
              ("same", 3, 2 * SR + 77), ("same", 1, REQUEST_SAMPLES),
              ("same", TRAIN_B, TRAIN_SECONDS * SR),
              *(("same", CLI_B, int(s * SR)) for s in CLI_BUCKET_SECONDS),
              ("same", 2, SR))
    result, copies = {}, set()
    for padding, b, t in shapes:
        cfg = fe.LogMelFrontendConfig(padding=padding)
        wav = torch.from_numpy(noise((b, t), seed=t)).to(dev)
        plan = k1.launch_plan(b, t, cfg.hop, fe._left_pad(t, cfg), sm_count,
                              base_aligned=wav.data_ptr() % 16 == 0)
        copies.add(plan.vec16)
        got = fe.power_spectrogram(wav, cfg)
        want = fe.power_spectrogram_reference(wav, cfg)
        torch.cuda.synchronize()
        err = within(got, want, **POWER_TOL)
        mel = torch.from_numpy(fe._frontend_constants(cfg)[1]).to(dev)
        mel_err = within(fe.log_mel_spectrogram(wav, cfg),
                         torch.matmul(fe._to_db(want, cfg), mel),
                         **LOGMEL_TOL)
        log(f"kernel: K1 {padding} B={b} T={t} -> {tuple(got.shape)} "
            f"(tile {plan.tile_frames} frames, {plan.groups * 64} threads, "
            f"{16 if plan.vec16 else 4}-byte copies): max|err| power "
            f"{err:.3e}, log-mel {mel_err:.3e}")
        result["max_abs_err"] = max(result.get("max_abs_err", 0.0), err)
        del got, want
    if copies != {True, False}:
        raise AssertionError("the shapes did not cover both copy paths")

    # the serving shape: 57 MB of wav in, 184 MB of power out, more than the
    # 50 MB L2, so back-to-back launches find their inputs in device memory
    batched = time_k1("same", 128, 7 * SR, reps=50)
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

    def numbers(batch, samples, times):
        return {"batch": batch, "samples": samples,
                "ms": times["kernel"]["median"],
                "plain_ms": times["plain"]["median"],
                "library_ms": times["library"]["median"],
                "bound_ms": times["bound_ms"], "bound_by": times["bound_by"]}

    result["train_shape"] = numbers(TRAIN_B, TRAIN_SECONDS * SR, train)
    result["request_shape"] = dict(
        numbers(1, REQUEST_SAMPLES, request),
        graph_ms=request["kernel_graph"]["median"])
    log(json.dumps({"k1_request_shape": result["request_shape"]}))
    log(json.dumps({"k1_train_shape": result["train_shape"]}))
    result.update(numbers(128, 7 * SR, batched))
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


def k1_counted(fn):
    """``fn()`` with K1's launch count set to 0 just before it and read just
    after it: returns (what fn returned, launches)."""
    from tensorflowasr_tpu_torch.ops import power_spectrogram as k1

    k1.power_spectrogram_cuda.launches = 0
    out = fn()
    return out, k1.power_spectrogram_cuda.launches


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
        mark("frontend (K1 + dB + mel)")
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
    """Returns the models by dtype and K1's launches in the predict_step
    calls alone."""
    from tensorflowasr_tpu_torch.models.conformer import (
        ConformerConfig,
        build_model,
    )
    from tensorflowasr_tpu_torch.serve.engines import predict_step

    dev = torch.device("cuda")
    wav, length = batch_inputs(b, seconds, dev)
    n_frames = -(-wav.shape[1] // 160)
    t_enc = -(-n_frames // 4)
    models, launches = {}, 0
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

        times, n = k1_counted(predict)
        if n != reps + 1:
            raise AssertionError(f"{reps + 1} predict_step calls launched "
                                 f"K1 {n} times")
        launches += n
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


def phase_requests(model) -> int:
    """Returns K1's launches in the 4 requests alone."""
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

    return k1_counted(requests)[1]


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


def phase_train(steps: int = 10) -> int:
    """Returns K1's launches in the ``train_step`` calls alone."""
    numpy_batch = train_batch(TRAIN_B, TRAIN_SECONDS, TRAIN_PHONES,
                              TRAIN_CHARS)
    audio_s = TRAIN_B * TRAIN_SECONDS
    launches = 0
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

        pipelined, n = k1_counted(run)
        if n != 2 * steps + 1 or state.step != n:
            raise AssertionError(f"{state.step} train steps launched K1 "
                                 f"{n} times")
        launches += n
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


def phase_cli() -> int:
    """Returns K1's launches in the two CLI calls."""
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

        (rc, out, err, t_train, t_eval), launches = k1_counted(run)
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
    if launches != 8:
        raise AssertionError(f"the CLI calls launched K1 {launches} times")
    log(f"cli: train_asr bf16, 6 steps of B=8 in {t_train:.2f} s "
        f"(train_loss {logged[0]['train_loss']:.3f} -> "
        f"{logged[-1]['train_loss']:.3f}), checkpoints {ckpts}; eval_am "
        f"restored step 6 and scored 2 batches in {t_eval:.2f} s: "
        f"{json.dumps(result)}")
    return launches


def main() -> int:
    name = phase_device()
    phase_build()
    k1_numbers = phase_kernel()
    models, batched = phase_serve()
    requested = phase_requests(models["float32"])
    del models
    torch.cuda.empty_cache()
    trained = phase_train()
    phase_train_card_vs_cpu()
    cli = phase_cli()
    launches = batched + requested + trained + cli
    log(f"launches: K1 {launches} on the main path ({batched} in the "
        f"predict_step calls, {requested} in the session's requests, "
        f"{trained} in the train steps, {cli} in the train_asr and eval_am "
        f"CLI calls)")
    if min(batched, requested, trained, cli) == 0:
        raise AssertionError("the main path did not launch K1 in every "
                             "phase")

    entry = {
        "name": "power_spectrogram", "route": "cuda",
        "source": "tensorflowasr_tpu_torch/csrc/power_spectrogram.cu",
        "replaces": "tensorflowasr_tpu/ops/pallas_frontend.py:77",
        "launches": launches,
        "max_abs_err": k1_numbers["max_abs_err"],
        "ms": k1_numbers["ms"], "plain_ms": k1_numbers["plain_ms"],
        "bound_ms": k1_numbers["bound_ms"],
        "bound_by": k1_numbers["bound_by"],
        "library_ms": k1_numbers["library_ms"],
        # the numbers above are the batched serving shape's (B=128 x 7 s)
        "batch": k1_numbers["batch"], "samples": k1_numbers["samples"],
        "request_shape": k1_numbers["request_shape"],
        "train_shape": k1_numbers["train_shape"],
    }
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
