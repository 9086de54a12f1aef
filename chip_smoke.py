"""Drive the PyTorch port's offline ConformerCTC(S) serving path on one CUDA
card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  - the card's name and power limit (nvidia-smi); raises without
             CUDA.
2. build   - nvcc builds every kernel in ``tensorflowasr_tpu_torch/csrc``.
3. kernel  - K1 (the power-spectrogram kernel, one FFT per frame in shared
             memory) against its plain PyTorch version, TF32 off: 'same' at
             B=128 x 7 s, 'valid' at B=16 x 7680 samples, a ragged T, and
             the one-chunk request shape (B=1 x 7680 samples), which
             together take both of its slab-copy paths; power within rtol
             2e-4 / atol 2e-3, log-mel within rtol 1e-3 / atol 5e-2. Times
             the kernel, the plain version and ``torch.stft`` at the batched
             and at the request shape, each with median, minimum and
             spread, beside the bound.
4. serve   - the full-width model (dmodel 144, 13 blocks, 4 x 36 heads,
             kernel 32; 231 phone and 9161 char classes) with seeded random
             weights: ``predict_step`` on B=128 x 7 s in f32 and bf16, with a
             per-stage time breakdown; the f32 outputs are held against the
             same model run on the CPU (plain frontend) on a small input.
5. request - ``OfflineASRSession`` answers 4 requests (2, 3.5, 5, 8 s).

K1's launch count is set to 0 just before the ``predict_step`` calls and
just before the session's 4 requests, and read just after each; both must
have launched it. The stage breakdown and the card-vs-CPU check run outside
those windows. K1's request-shape times go on a ``k1_request_shape`` JSON
line in the kernel phase. The last lines are a JSON line of kernel numbers
(K1 at the batched shape), then ``{"ok": true, "device": {...}}``.
TF32 is off throughout (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so every f32 number is full f32.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

SR = 16000
REQUEST_SAMPLES = 7680               # ASREngine's 0.48 s chunk at B = 1
N_PHONE, N_CHAR = 231, 9161          # bench.py's class counts
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
    # 'valid' (left pad 1023) and the ragged row stride take 4-byte ones
    shapes = (("same", 128, 7 * SR), ("valid", 16, 2560 * 3),
              ("same", 3, 2 * SR + 77), ("same", 1, REQUEST_SAMPLES))
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
    log(json.dumps({"k1_request_shape": {
        "batch": 1, "samples": REQUEST_SAMPLES,
        "ms": request["kernel"]["median"],
        "graph_ms": request["kernel_graph"]["median"],
        "plain_ms": request["plain"]["median"],
        "library_ms": request["library"]["median"],
        "bound_ms": request["bound_ms"], "bound_by": request["bound_by"]}}))

    result.update(ms=batched["kernel"]["median"],
                  plain_ms=batched["plain"]["median"],
                  library_ms=batched["library"]["median"],
                  bound_ms=batched["bound_ms"], bound_by=batched["bound_by"])
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


def main() -> int:
    name = phase_device()
    phase_build()
    k1_numbers = phase_kernel()
    models, batched = phase_serve()
    requested = phase_requests(models["float32"])
    launches = batched + requested
    log(f"launches: K1 {launches} on the main path ({batched} in the "
        f"predict_step calls, {requested} in the session's requests)")
    if batched == 0 or requested == 0:
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
    }
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
