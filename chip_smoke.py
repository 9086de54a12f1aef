"""Check the PyTorch port on one CUDA card, path by path, against the CPU,
against fixed bounds and against what each path must launch. It times
nothing: speed end to end is ``benchmark/``'s and one kernel's the
``kernels/sweep_*.py`` scripts'. Each kernel's edge cases (short, ragged,
unaligned and strided inputs, graph capture) are ``pytest -m cuda
tests/test_torch_kernels_cuda.py``'s; phase 3 holds each kernel at the main
path's shapes, which the card tests read from the same ``testing.py``.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device  - the card's name and power limit (nvidia-smi); raises without
             CUDA. TF32 is off throughout, so every f32 number is full f32.
2. build   - nvcc builds every kernel in ``tensorflowasr_tpu_torch/csrc``;
             prints the registers and spills it reports.
3. kernel  - K1 and K1b against their plain versions on card tensors, in
             'same' and 'valid', at every shape of ``testing.MAIN_PATH``
             (B=128 x 7 s and 8 s, the block-streaming fold [1920, 7680],
             the CLI buckets, the chunk path's stream, pool and CLI shapes,
             the card-against-CPU batches) and the 0.48 s request chunk,
             within the card tests' tolerances, K1 once and K1b once a
             call, both copy paths taken; K1b with a given mel matrix and
             its backward at B=8 x 2 s and 4 s, the gradient within 1e-4 of
             its largest entry; RA at the four decode buckets (B=32, T' =
             200-500), one launch a call, its largest error at most 1.5x
             the bf16 plain composition's against the f32 one.
4. ebranchformer - the full-width bf16 E-Branchformer (L)
             (``configs/ebranchformerL.yml``, seeded) through
             ``predict_step`` at B=32 x 8 / 12 / 16 / 20 s with ragged
             frame lengths: RA once in each of the 17 blocks, K1 and K1b
             once a call, ids and lengths in range.
5. serve   - the full-width ConformerCTC(S) (231 phone and 9161 char
             classes, seeded weights): ``predict_step`` on B=128 x 7 s in
             f32 and bf16, shapes and ids in range; the f32 encoder and CTC
             logits within 1e-3 of the same model on the CPU on B=2 x 1 s.
6. request - ``OfflineASRSession`` answers 4 requests (2, 3.5, 5, 8 s),
             one segment each.
7. train   - ``CTCTrainer`` from ``configs/am_data.yml`` +
             ``configs/conformerS.yml`` (dropout 0.1, Adam lr 1e-4) on B=128
             x 8 s of noise, 64 phones, 32 chars, bf16 and f32: 11 steps,
             every loss finite, the last below the first, every BatchNorm
             running statistic moved. Then one f32 loss and backward at
             dropout 0 on B=2 x 1 s on the card and on the CPU (loss within
             1e-4 relative, the gradient's global norm within 1e-3), and
             ``ctc_loss`` alone on both, an infeasible row's loss and
             gradient 0.
8. cli     - a seeded corpus with full-size vocabularies in a temporary
             directory; ``cli.train_asr`` for 6 steps with saves, then
             ``cli.eval_am`` restoring step 6: checkpoints, logged steps and
             finite error rates.
9. chunk_offline - ChunkConformer(S) (``configs/chunk_conformerS.yml``,
             ``testing.chunk_models``: first conv x10, the picker's blank
             bias at the median margin): ``make_chunk_predict_step`` on
             B=128 x 7 s of tones in f32 and bf16, 20-80 % of the frames
             picked, every row picking and decoding something.
10. chunk_stream - one stream in f32 and bf16: ``fused_stream_step``
             chained over 50 chunks with every implicit host sync an error
             (``torch.cuda.set_sync_debug_mode``), then ``ChunkStreamSession``;
             in f32 the session's phone ids equal the collapsed argmax of the
             offline ``encode_to_phones``, and ``picker_stream_step``'s
             logits are within 1e-3 of the CPU's.
11. chunk_pool - ``batched_stream_step`` over 256 slots in f32 and bf16,
             chained over 25 ticks with no implicit sync, and
             ``MultiStreamChunkServer.tick`` draining 25 chunks of every
             slot; then 4 streams of 2, 3.5, 5 and 8 s in interleaved
             odd-sized packets, the 4th opened when the first closes, each
             equal to an independent ``ChunkStreamSession``.
12. chunk_fused - the f32 model with ``fused_decoder`` set on the same
             weights against the sequential decoder: one stream over 50
             chunks and a 256-slot pool over 12 ticks with random reset and
             advance masks. Phone ids and n_final identical; char and
             provisional ids identical except at a near-tie of the fused
             logits (top-two gap within 1e-5 of the top logit; more than 1 %
             such positions fails); every cache leaf within 1e-3 of its
             largest entry. Both paths then chained, one stream and the
             256-slot tick, with no implicit sync.
13. chunk_cli - ``cli.test_chunk_asr --device cuda`` on an 8 s wav with the
             f32 chunk model written as a flax ``.npz`` for ``--weights``:
             streamed phones = offline phones.
14. chunk_train - ``ChunkTrainer`` (``testing.new_chunk_trainer``: the
             picker calibrated in training mode) on B=128 x 8 s of tones, 64
             + 64 phones, 32 + 32 chars, f32 and bf16: 11 steps, every loss
             finite. Then one f32 loss and backward on B=2 x 1.28 s on the
             card and on the CPU: the same picks, loss within 1e-4
             relative, the gradient's global norm within 1e-3.
15. chunk_train_cli - on phase 8's kind of corpus, ``cli.train_asr`` with
             the chunk config for 3 steps with a save, then ``cli.eval_am``
             and ``cli.test_chunk_asr`` restoring it: finite error rates,
             streamed phones = offline phones.
16. serve_socket - ``cli.serve_model.build_ops`` on phase 8's and phase 15's
             checkpoints (blank biases calibrated and saved as the next
             step; ``fused_decoder`` set in a copy of the chunk config; a
             256-slot pool) served by ``ModelServer`` on a 127.0.0.1 port.
             One client streams the 8 s file alone, then 4 client threads
             each send a file of 2 / 3.5 / 5 / 8 s offline (``info``,
             ``encode``, ``ctc_logits``, ``translate``) and streamed. Every
             result equals the in-process ``ASREngine``'s and an independent
             ``ChunkStreamSession``'s, none empty; the encoder rows, CTC and
             char logits over the wire are within 1e-5 of the same calls in
             process; a failing client fails the phase.
17. serve_vad_punc - phase 8's checkpoint as phase 16 calibrated it, under
             the VAD state
             machine with punctuation: a full-width OnlineVAD and
             PuncTransformer with seeded weights, their last layers
             calibrated (``testing.calibrate_vad``, ``calibrate_punc``).
             ``StreamASRSession`` on 8 s of tone bursts in 20 ms pcm16
             packets, and ``OfflineASRSession`` with VAD and punctuation on
             2 / 3.5 / 5 / 8 s files (each also without VAD): the same
             objects on the CPU give the same events, texts and segments,
             the encoder rows within 1e-3; a sentence begins and ends, a
             text is punctuated, every file splits. Then the ``vad`` op of
             ``cli.serve_model.build_ops`` over 127.0.0.1, within 1e-5 of
             ``VADEngine`` in process; and the offline, chunk and VAD native
             artifacts written twice with the same bytes and read back bit
             for bit.
18. beam_lm - an order-3 phone LM by ``cli.train_lm`` on phase 8's corpus
             and one over all 231 phones from a seeded corpus; the card's
             hash lanes equal to ``_hash_tuple``'s and ``score_candidates``
             within 1e-6 (and one f32 ulp) of ``NGramLM.score``;
             ``make_beam_predict_step`` (W 8, K 16, LM weight 0.3) and the
             greedy ``predict_step`` on B=128 x 7 s of tones, the beam
             again with every implicit sync an error (the same ids), and 8
             rows against the CPU: best beams equal except at a near-tie of
             the top two (within 1e-4 of the top score), live scores within
             1e-4 relative; ``cli.eval_am --lm`` on the card and on the CPU,
             the same JSON; ``cli.serve_model.build_ops --lm`` served on
             127.0.0.1, an 8 s file decoded with the beam on the host
             against the in-process beam ``ASREngine`` on the CPU;
             ``cli.train_asr --data_procs 2`` and ``0``, 3 finite steps each
             (the workers fail if CUDA starts in them).
19. vad_punc_train - OnlineVAD (``configs/vad_model.yml``) at
             ``configs/vad_data.yml``'s B=16 x 6 s at 8 kHz from
             ``VADDataLoader``, one step folded by ``streaming_reshape``,
             one OfflineVAD step; PuncTransformer at B=32 x 64 tokens with
             and without 768-d teacher features; finite losses; each model's
             loss and gradient norm on the card against the CPU (1e-4 /
             1e-3 relative); ``cli.train_vad`` -> ``cli.eval_vad
             --export_native`` and ``cli.train_punc --bert_feature_dir`` ->
             ``cli.eval_punc``, each eval restoring. K1 and K1b must not
             launch on this path.
20. block_stream - ConformerCTC with ``streaming: true`` and
             ``configs/Streaming_ConformerS.yml`` (full width, seeded):
             ``predict_step`` f32 at B=128 x 7.2 s (K1b on the fold [1920,
             7680]); f32 train steps at B=128 x 8.16 s, finite losses; the
             encoder, loss and gradient norm on the card against the CPU on
             B=2 x 2 chunks; ``cli.train_asr`` -> ``cli.eval_am`` ->
             ``cli.test_asr`` on a 16-chunk wav; ``OfflineASRSession`` on 2 /
             3.5 / 5 / 8 s files, one batched encode a file, its encoder
             rows within 1e-3 of the folded encode.
21. leaf_wav_export - (a) ``add_wav_info: true`` and (b) ``mel_layer_type:
             leaf`` on the full-width ConformerCTC(S): ``predict_step`` at
             B=128 x 7 s, 3 train steps at B=32 x 8 s with finite losses,
             the encoder, loss and gradient norm on the card against the CPU
             on B=2 x 1 s; K1 and K1b once a call with add_wav_info, never
             with LEAF. (c) ``export_offline_asr`` of phase 16's calibrated
             checkpoint and ``export_chunk_streaming`` of its chunk
             checkpoint, loaded back: the encoder and the picker each hold
             one ``tasr::log_mel_spectrogram`` node and launch K1 and K1b
             once a call; encoder, ctc_model and translator at B=1 x 7 s and
             the picker and decoder over 10 chunks within rtol 1e-4 / atol
             1e-4 of the eager models. (d) ``rnnt_loss`` and its gradient at
             B=8, T=200, U=40, V=256 on the card against the CPU.
22. parallel - two gloo ranks pinned to the one card
             (``parallel/step_check.py``): (a) ConformerCTC(S) and
             ChunkConformer(S) at a global B=32 x 8 s for 3 steps against
             one process on the same rows: loss within 1e-4 relative, the
             gradients' global norm within 1e-3, ranks identical, BatchNorm
             statistics within 1e-4 and parameters within
             PARALLEL_PARAM_REL of each leaf's largest entry after the
             first step and the third; a planted fault (BatchNorm moments
             over each rank's own rows) must exceed a bound; (b) a (1 x 2)
             tensor-parallel SGD step within 1e-4 / TP_PARAM_REL; (c)
             ``cli.train_asr`` under ``torchrun --nproc_per_node 2`` then
             ``cli.eval_am`` restoring; (d) one process at world size 1 on
             NCCL, a step within 1e-5 of the one without a process group.
23. headtohead_quick - ``recipes/headtohead.py::quick``: 2000 steps of the
             offline model (dmodel 64, 4 blocks) on the seed-21 synthetic
             corpus, then ``cli.eval_am`` on its test list: phone CER <=
             0.0764 and char CER <= 0.855 (2x and 1.5x JAX's at the same
             setting), and an untrained checkpoint of the same config must
             miss both.

K1's and K1b's launch counts are set to 0 just before each checked call of
the main path and read just after; where a phase knows its number of
frontend calls the count must be exact (K1b once a log-mel, and K1 once
for each, its FFT pass), every phase but VAD and punctuation training and
the LEAF branch must launch both, and those two must launch neither; RA's
count is read the same way around each E-Branchformer (L) predict step.
The line before the last gives each kernel's main-path launches and the
largest error phase 3 measured (``{"kernels": [...]}``); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import torch

from tensorflowasr_tpu_torch.testing import (
    CHUNK_S,
    CHUNK_SAMPLES,
    EBF_BUCKETS,
    FRAME_SAMPLES,
    KERNEL_LOGMEL_TOL,
    MAIN_PATH,
    N_CHAR,
    N_PHONE,
    POWER_TOL,
    SR,
    TRAIN_B,
    TRAIN_CHARS,
    TRAIN_PHONES,
    TRAIN_SECONDS,
    chunk_models,
    chunk_train_batch,
    ebf_batch,
    ebf_decode,
    ebranchformer_l,
    new_chunk_trainer,
    new_trainer,
    tones,
    train_batch,
)

REQUEST_SAMPLES = 7680               # ASREngine's 0.48 s chunk at B = 1
# the block-streaming encoder folds B = 128 x 7.2 s (15 chunks of 7680
# samples) into [1920, 7680] before K1b 'same'
BLOCK_B, BLOCK_CHUNKS = 128, 15
CLI_B, CLI_BUCKET_SECONDS = 8, (2.0, 4.0)    # the cli phase's batches


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


def noise(shape, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1
            ).astype(np.float32)


def phase_device() -> str:
    from tensorflowasr_tpu_torch.kernels.timing import card_line

    card_line()
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} x {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return name


def phase_build() -> None:
    from tensorflowasr_tpu_torch.kernels import build

    reports = build.build()
    log(f"build: {sorted(reports)}")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


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


def phase_kernel() -> dict:
    """K1 and K1b against their plain versions on card tensors at every
    shape of ``MAIN_PATH`` and the request chunk, in both paddings; K1b
    with a given mel matrix and its backward at the CLI buckets; RA at the
    decode buckets. Returns each kernel's largest error."""
    from tensorflowasr_tpu_torch.kernels import sweep_rel_attention as sweep
    from tensorflowasr_tpu_torch.ops import frontend as fe
    from tensorflowasr_tpu_torch.ops import power_spectrogram as k1
    from tensorflowasr_tpu_torch.ops import rel_attention as ra

    dev = torch.device("cuda")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = {"k1": 0.0, "k1b": 0.0, "k1b_grad": 0.0, "ra": 0.0}
    copies = set()
    shapes = [*MAIN_PATH, (1, REQUEST_SAMPLES)]
    for b, t in shapes:
        wav = torch.from_numpy(noise((b, t), seed=t)).to(dev)
        errs = []
        for padding in ("same", "valid"):
            cfg = fe.LogMelFrontendConfig(padding=padding)
            copies.add(k1.launch_plan(
                b, t, cfg.hop, fe._left_pad(t, cfg), sm_count,
                base_aligned=wav.data_ptr() % 16 == 0).vec16)
            (power, mel), n = counted(lambda: (
                fe.power_spectrogram(wav, cfg),
                fe.log_mel_spectrogram(wav, cfg)))
            # K1 once for the power and once as K1b's FFT pass
            if n != (2, 1):
                raise AssertionError(f"K1 and K1b {padding} B={b} T={t} "
                                     f"launched {n} times, not (2, 1)")
            errs.append(within(power, fe.power_spectrogram_reference(
                wav, cfg), **POWER_TOL))
            errs.append(within(mel, fe.log_mel_spectrogram_reference(
                wav, cfg), **KERNEL_LOGMEL_TOL))
        worst["k1"] = max(worst["k1"], errs[0], errs[2])
        worst["k1b"] = max(worst["k1b"], errs[1], errs[3])
        log(f"kernel: B={b} T={t}: max|err| K1 same {errs[0]:.3e} valid "
            f"{errs[2]:.3e}; K1b same {errs[1]:.3e} valid {errs[3]:.3e}")
        del wav, power, mel
    if copies != {True, False}:
        raise AssertionError("the shapes did not cover both copy paths")

    # a given (trainable) mel matrix: K1, then the dense product kernel,
    # and its backward; the gradient within 1e-4 of its largest entry
    for seconds in CLI_BUCKET_SECONDS:
        t = int(seconds * SR)
        wav = torch.from_numpy(noise((CLI_B, t), seed=t + 1)).to(dev)
        for padding in ("same", "valid"):
            cfg = fe.LogMelFrontendConfig(padding=padding)
            fb = fe._frontend_constants(cfg)[1]
            w0 = torch.from_numpy(fb + np.random.default_rng(t).uniform(
                0, 2e-3, fb.shape).astype(np.float32)).to(dev)
            cot = torch.from_numpy(noise((CLI_B, -(-t // cfg.hop),
                                          cfg.n_mels), seed=t + 2)).to(dev)
            results = []
            for fn in (fe.log_mel_spectrogram,
                       fe.log_mel_spectrogram_reference):
                w = w0.clone().requires_grad_()
                out = fn(wav, cfg, mel_weights=w)
                (out * cot).sum().backward()
                results.append((out.detach(), w.grad))
            (got, got_grad), (want, want_grad) = results
            err = within(got, want, **KERNEL_LOGMEL_TOL)
            scale = float(want_grad.abs().max())
            grad_err = within(got_grad, want_grad, rtol=0, atol=1e-4 * scale)
            worst["k1b"] = max(worst["k1b"], err)
            worst["k1b_grad"] = max(worst["k1b_grad"], grad_err / scale)
            log(f"kernel: K1b {padding} B={CLI_B} T={t} with a given [513, "
                f"80] matrix: max|err| {err:.3e}; its gradient {grad_err:.3e}"
                f" (largest entry {scale:.3e})")

    # RA: one launch a call; against the plain composition in f32 on the
    # same bf16 inputs, at most 1.5x the bf16 plain composition's error
    for t in sweep.LENGTHS:
        q, k, v, bd, u, mask, _ = sweep.inputs(t, seed=t)
        want = ra.rel_attention_reference(
            *(x.float() for x in (q, k, v, bd)), u, mask)
        plain = ra.rel_attention_reference(q, k, v, bd, u, mask)
        ra.rel_attention_cuda.launches = 0
        got = ra.rel_attention(q, k, v, bd, u, mask)
        torch.cuda.synchronize()
        if ra.rel_attention_cuda.launches != 1:
            raise AssertionError(f"RA at T'={t} launched "
                                 f"{ra.rel_attention_cuda.launches} times")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"RA at T'={t}: non-finite values")
        err = float((got.float() - want).abs().max())
        err_plain = float((plain.float() - want).abs().max())
        if err > 1.5 * err_plain:
            raise AssertionError(
                f"RA at T'={t}: largest error {err:.3e} above 1.5x the "
                f"bf16 plain composition's {err_plain:.3e}")
        worst["ra"] = max(worst["ra"], err)
        log(f"kernel: RA B={q.shape[0]} T'={t}: largest error {err:.3e} "
            f"(bf16 plain {err_plain:.3e})")
        del q, k, v, bd, want, plain, got
    torch.cuda.empty_cache()
    return worst


def phase_ebranchformer() -> tuple:
    """The full-width bf16 E-Branchformer (L)'s predict step at each
    decode bucket: RA once a block, K1 and K1b once a call, ids in range.
    Returns (K1's and K1b's launches, RA's launches)."""
    from tensorflowasr_tpu_torch.ops import rel_attention as ra

    model = ebranchformer_l()
    blocks = len(model.encoder.blocks)
    launches, ra_launches = (0, 0), 0
    for seconds in EBF_BUCKETS:
        wav, lengths = ebf_batch(seconds, seed=seconds)
        ebf_decode(model, wav, lengths)      # builds RA at its first call
        ra.rel_attention_cuda.launches = 0
        (phone_ids, phone_lens, char_ids), n = counted(
            lambda: ebf_decode(model, wav, lengths))
        if ra.rel_attention_cuda.launches != blocks or blocks != 17:
            raise AssertionError(
                f"the {seconds} s predict step launched RA "
                f"{ra.rel_attention_cuda.launches} times, not once in each "
                f"of the 17 blocks ({blocks})")
        ra_launches += blocks
        launches = add(launches, expect(n, 1, f"the {seconds} s predict "
                                              f"step"))
        t_enc = seconds * SR // FRAME_SAMPLES
        if phone_ids.shape[0] != wav.shape[0] or not (
                0 <= int(phone_lens.min()) and int(phone_lens.max()) <= t_enc
                and 0 <= int(phone_ids.min()) and int(phone_ids.max())
                < N_PHONE and 0 <= int(char_ids.min())
                and int(char_ids.max()) < N_CHAR):
            raise AssertionError(f"the {seconds} s predict step: ids or "
                                 f"lengths out of range")
    log(f"ebranchformer: predict_step at {list(EBF_BUCKETS)} s, B="
        f"{wav.shape[0]}: RA {blocks} launches a batch, K1 and K1b "
        f"{launches}")
    del model
    torch.cuda.empty_cache()
    return launches, ra_launches


def run_cli(main_fn, args: list) -> tuple:
    """``main_fn(args)`` with its stdout and stderr captured; raises unless
    it returns 0. Returns (the last stdout line as JSON or None, stdout,
    stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main_fn(args)
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__}: rc {rc}, stderr "
                             f"{err.getvalue()[-400:]}")
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return last, out.getvalue(), err.getvalue()


def phase_serve(seconds: float = 7.0, b: int = 128):
    """Returns the models by dtype and K1's and K1b's launches in the
    predict_step calls."""
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
        out, n = counted(lambda: predict_step(model, wav, length))
        check_outputs(out, b, t_enc)
        launches = add(launches, expect(n, 1, f"a {dtype} predict_step"))
    log(f"serve: predict_step f32 and bf16 B={b} x {seconds} s: shapes and "
        f"ids in range, K1 and K1b once a call")

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
            segments = session.transcribe_wav(
                noise(int(seconds * SR), seed=10 + i))
            if not (isinstance(segments, list) and len(segments) == 1
                    and abs(segments[0]["end_s"] - seconds) < 1e-6
                    and isinstance(segments[0]["text"], str)):
                raise AssertionError(f"request {i}: bad segments {segments}")
        log("request: 4 requests of 2, 3.5, 5 and 8 s, one segment each")

    return counted(requests)[1]


def phase_train(steps: int = 10) -> tuple:
    """A warm ``train_step`` and ``steps`` more in bf16 and in f32. Returns
    K1's and K1b's launches in the ``train_step`` calls alone."""
    numpy_batch = train_batch(TRAIN_B, TRAIN_SECONDS, TRAIN_PHONES,
                              TRAIN_CHARS)
    launches = (0, 0)
    for dtype in ("bfloat16", "float32"):
        trainer = new_trainer(dtype, "cuda")
        cfg = trainer.model_cfg
        if (cfg.dmodel, cfg.num_blocks, cfg.dropout) != (144, 13, 0.1):
            raise AssertionError(f"not the full-width config: {cfg}")
        state = trainer.state
        batch = trainer._prepare_batch(numpy_batch)
        before = {k: v.clone() for k, v in state.model.named_buffers()}

        def run():
            return [trainer.train_step(state, batch)[1]["train_loss"]
                    for _ in range(steps + 1)]

        losses, n = counted(run)
        if state.step != steps + 1:
            raise AssertionError(f"{state.step} train steps, not "
                                 f"{steps + 1}")
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
        log(f"train: {dtype} train_step B={TRAIN_B} x {TRAIN_SECONDS} s, "
            f"{TRAIN_PHONES} phones, {TRAIN_CHARS} chars: train_loss first "
            f"{values[0]:.4f}, last {values[-1]:.4f} after {steps} steps; "
            f"{len(moved)} BatchNorm buffers moved")
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


def phase_cli(tmp: str) -> tuple:
    """In ``tmp``, which keeps the corpus and the checkpoints for the
    serve_socket phase. Returns K1's and K1b's launches in the two CLI
    calls."""
    from tensorflowasr_tpu_torch.cli import eval_am, train_asr

    root = os.path.dirname(os.path.abspath(__file__))
    model_yml = os.path.join(root, "configs", "conformerS.yml")
    data_yml = write_corpus(tmp)
    common = ["--data_config", data_yml, "--model_config", model_yml,
              "--device", "cuda", "--data_workers", "2"]

    def run():
        if train_asr.main(common + ["--total_steps", "6"]) != 0:
            raise AssertionError("cli.train_asr failed")
        return run_cli(eval_am.main, common + ["--max_batches", "2"])

    (result, _, err), launches = counted(run)
    ckpts = sorted(os.listdir(os.path.join(tmp, "logs", "checkpoints")))
    with open(os.path.join(tmp, "logs", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    if "no checkpoint found" in err:
        raise AssertionError(f"cli.eval_am: stderr {err[-400:]}")
    if ckpts != ["ckpt_000000003.pt", "ckpt_000000006.pt"]:
        raise AssertionError(f"checkpoints {ckpts}")
    if [m["step"] for m in logged] != [2, 4, 6] or not all(
            math.isfinite(m["train_loss"]) for m in logged):
        raise AssertionError(f"metrics.jsonl {logged}")
    for key in ("phone_cer", "phone_ser", "char_cer", "char_ser"):
        if not math.isfinite(result[key]):
            raise AssertionError(f"eval_am: {key} = {result[key]}")
    if result["phone_N"] <= 0 or result["char_N"] <= 0:
        raise AssertionError(f"eval_am scored nothing: {result}")
    # 6 train steps, and 2 eval batches through predict_step
    expect(launches, 8, "the train_asr and eval_am calls")
    log(f"cli: train_asr bf16, 6 steps of B=8 (train_loss "
        f"{logged[0]['train_loss']:.3f} -> {logged[-1]['train_loss']:.3f}), "
        f"checkpoints {ckpts}; eval_am restored step 6 and scored 2 "
        f"batches: {json.dumps(result)}")
    return launches


# ---------------------------------------------------------------------------
# Chunk streaming (SMLTA2): ChunkConformer(S) from configs/chunk_conformerS.yml
# ---------------------------------------------------------------------------

POOL_SLOTS, POOL_TICKS = 256, 25                 # bench.py:239-286
OFFLINE_B, OFFLINE_SECONDS = 128, 7
STREAM_CHUNKS = 50                   # bench.py:175-203: 50 chained chunks
CLI_CHUNKS = 50                      # the chunk CLI's wav: 8 s, 50 chunks
CHUNK_VS_CPU = (2, 8 * CHUNK_SAMPLES)       # the card-against-CPU batch


def chunk_models_logged() -> dict:
    """``testing.chunk_models``' f32 and bf16 models on the card."""
    models, moved = chunk_models(device="cuda")
    log(f"chunk: ChunkConformer(S) from configs/chunk_conformerS.yml, "
        f"seeded; first conv x10, blank bias moved by {moved:.4f} (the "
        f"median margin over 4 x 4 s of warm-up signals)")
    return models


def check_share(share: float, what: str) -> None:
    if not 0.2 <= share <= 0.8:
        raise AssertionError(f"the picker keeps {share:.1%} of the frames "
                             f"of {what}, not 20-80 %")


def phase_chunk_offline(models: dict) -> int:
    """``make_chunk_predict_step`` at B = 128 x 7 s. Returns K1's and K1b's
    launches in its calls."""
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
        out, n = counted(lambda: make_chunk_predict_step(model)(wav, in_len))
        launches = add(launches, expect(n, 1, f"a {dtype} chunk predict "
                                              f"call"))
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
        log(f"chunk_offline: make_chunk_predict_step {dtype} B={OFFLINE_B} "
            f"x {OFFLINE_SECONDS} s: picked {int(counts.min())}-"
            f"{int(counts.max())} of {t_enc} frames a row ({share:.1%}); "
            f"char lengths {int(char_lens.min())}-{int(char_lens.max())}")
    return launches


def without_syncs(step, n: int) -> None:
    """``step()`` n times with every implicit host sync an error, then one
    sync."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(n):
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def phase_chunk_stream(models: dict) -> int:
    """One stream: ``fused_stream_step`` chained on its caches with no
    implicit sync, and ``ChunkStreamSession`` (a fetch a chunk), in f32 and
    bf16; then, in f32, the session against the offline decode and the
    card's picker logits against the CPU's. Returns K1's and K1b's
    launches."""
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
        state = {"caches": model.init_stream_caches(1), "i": 0}

        def step():
            out = model.fused_stream_step(chunks[state["i"]],
                                          state["caches"])
            state["caches"] = out[4]
            state["i"] += 1

        session = ChunkStreamSession(model, device="cuda")

        def feed():
            for i in range(STREAM_CHUNKS):
                session.feed(signal[i * CHUNK_SAMPLES:(i + 1) * CHUNK_SAMPLES])
            return session.flush()

        with torch.no_grad():
            _, n_dev = counted(lambda: without_syncs(step, STREAM_CHUNKS))
            result, n_feed = counted(feed)
        expect(n_dev, STREAM_CHUNKS, "the chained stream steps")
        expect(n_feed, STREAM_CHUNKS, "the session's chunks")
        launches = add(launches, add(n_dev, n_feed))
        results[dtype] = result
        log(f"chunk_stream: {dtype} fused_stream_step chained over "
            f"{STREAM_CHUNKS} chunks with no implicit sync; "
            f"ChunkStreamSession {len(result['phone_ids'])} phones, "
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
    log(f"chunk_stream: f32 session phone ids = offline encode_to_phones "
        f"argmax, collapsed ({share:.1%} of the frames picked, "
        f"{len(offline)} phones)")

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
    ticks = 0
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
    if [got[i] for i in range(len(wavs))] != singles:
        raise AssertionError("the pool's results differ from independent "
                             "sessions")
    log(f"chunk_pool: f32 request check: {len(wavs)} streams of {seconds} s "
        f"in odd-sized packets through {POOL_SLOTS} slots ({ticks} feed "
        f"rounds) = {len(wavs)} independent sessions "
        f"(phones {[len(r['phone_ids']) for r in singles]}, chars "
        f"{[len(r['char_ids']) for r in singles]})")


def phase_chunk_pool(models: dict) -> int:
    """``MultiStreamChunkServer``'s step over 256 slots, f32 and bf16: the
    step chained on its caches with no implicit sync, and the server's own
    tick (upload, step, fetch) draining 25 chunks of every slot; then the
    request check. Returns K1's and K1b's launches."""
    from tensorflowasr_tpu_torch.serve.multi_session import (
        MultiStreamChunkServer,
    )

    dev = torch.device("cuda")
    signal = np.stack([tones(POOL_TICKS * CHUNK_S, seed=200 + i)
                       for i in range(POOL_SLOTS)])
    first = torch.from_numpy(signal[:, :CHUNK_SAMPLES].copy()).to(dev)
    launches = (0, 0)
    for dtype, model in models.items():
        server = MultiStreamChunkServer(model, n_slots=POOL_SLOTS,
                                        device="cuda")

        def ticks():
            state = {"caches": model.init_multi_stream_caches(POOL_SLOTS)}

            def step():
                *ids, state["caches"] = model.batched_stream_step(
                    first, state["caches"])
                state["sum"] = sum(x.sum() for x in ids)

            without_syncs(step, POOL_TICKS)
            slots = [server.open() for _ in range(POOL_SLOTS)]
            for slot in slots:
                server.feed(slot, signal[slot])
            server.tick()                        # drains POOL_TICKS chunks
            for slot in slots:
                server.close(slot)

        with torch.no_grad():
            _, n = counted(ticks)
        launches = add(launches, expect(n, 2 * POOL_TICKS, "the ticks"))
        log(f"chunk_pool: {dtype} batched_stream_step over {POOL_SLOTS} "
            f"slots chained over {POOL_TICKS} ticks with no implicit sync; "
            f"MultiStreamChunkServer.tick drained {POOL_TICKS} chunks of "
            f"every slot")
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
    log(f"chunk_cli: cli.test_chunk_asr --weights (the f32 model as a flax "
        f".npz) --device cuda on an {CLI_CHUNKS * CHUNK_S:.0f} s wav: "
        f"streamed phones = offline phones ({len(offline)})")
    return launches


# ---------------------------------------------------------------------------
# The fused decoder phase (fused_decoder: true) against the sequential one
# ---------------------------------------------------------------------------

FUSED_POOL_TICKS = 12
NEAR_TIE = 1e-5          # a top-two gap within this share of the logit
NEAR_TIE_SHARE = 0.01    # the most positions a path may differ at, so


class IdDiffs:
    """Char and provisional ids of the fused path against the sequential
    one. The fused decoder's logits of each step are caught by a forward
    hook; an id that differs is accepted only at a near-tie of those
    logits (top-two gap <= NEAR_TIE of the top logit's magnitude), found
    through the row of the decoder's buffer [ring | frames] that emitted
    it: real index k is ring row wb - rf + k for k < rf, else the frame of
    the (k - rf)-th kept frame."""

    def __init__(self, fused):
        self.wb = fused.cfg.decoder.lookahead
        self.blank = fused.phone_blank
        self.logits = None
        self.positions = self.near_ties = 0
        self.gaps = []

        def hook(_module, _inputs, out):
            self.logits = out

        self.handle = fused.decoder.fully_connected.register_forward_hook(
            hook)

    def check(self, seq_out, fused_out, rf, rows, what: str) -> None:
        """seq_out / fused_out: one step's (phone, char, prov, n_final) on
        the host; rf [B] the decoder ring fill before the step; ``rows``
        the streams to compare."""
        (ph_s, ch_s, pv_s, nf_s), (ph_f, ch_f, pv_f, nf_f) = \
            seq_out, fused_out
        if not (np.array_equal(ph_s[rows], ph_f[rows])
                and np.array_equal(nf_s[rows], nf_f[rows])):
            raise AssertionError(f"{what}: phone ids or n_final differ")
        wb, t = self.wb, ph_s.shape[1]
        for b in rows:
            self.positions += int((ch_s[b] >= 0).sum())
            self.positions += int((pv_s[b] >= 0).sum())
            if np.array_equal(ch_s[b], ch_f[b]) and \
                    np.array_equal(pv_s[b], pv_f[b]):
                continue
            if not (np.array_equal(ch_s[b] >= 0, ch_f[b] >= 0)
                    and np.array_equal(pv_s[b] >= 0, pv_f[b] >= 0)):
                raise AssertionError(f"{what}: stream {b} emits at other "
                                     f"positions")
            keep = (ph_f[b] != self.blank) & \
                (np.arange(t) >= t - nf_f[b])
            r = min(int(rf[b]), wb)
            real = [wb - r + k for k in range(r)] + \
                [wb + int(f) for f in np.nonzero(keep)[0]]
            n = int(keep.sum())
            n_adv, new_rf = max(r + n - wb, 0), min(r + n, wb)
            diffs = [real[k] for k, (a, c) in enumerate(
                zip(ch_s[b][ch_s[b] >= 0], ch_f[b][ch_f[b] >= 0])) if a != c]
            diffs += [real[n_adv + s - (wb - new_rf)]
                      for s in range(len(pv_s[b]))
                      if pv_s[b][s] >= 0 and pv_s[b][s] != pv_f[b][s]]
            for row in diffs:
                top = self.logits[b, row].float().topk(2).values
                gap = float(top[0] - top[1])
                self.gaps.append(gap)
                if gap > NEAR_TIE * abs(float(top[0])):
                    raise AssertionError(
                        f"{what}: stream {b} differs at a top-two gap of "
                        f"{gap:.3e} (top logit {float(top[0]):.3e})")
                self.near_ties += 1

    def close(self) -> str:
        self.handle.remove()
        if self.positions == 0:
            raise AssertionError("no char was emitted: nothing compared")
        if self.near_ties > NEAR_TIE_SHARE * max(self.positions, 1):
            raise AssertionError(f"{self.near_ties} near-ties of "
                                 f"{self.positions} positions")
        gaps = (f", top-two gaps {', '.join(f'{g:.3e}' for g in self.gaps)}"
                if self.gaps else "")
        return (f"{self.positions} char and provisional positions, "
                f"{self.near_ties} differing at a near-tie{gaps}")


def cache_error(got: dict, want: dict) -> float:
    """The largest error of a cache leaf over that leaf's largest entry;
    raises above 1e-3."""
    worst = 0.0
    for k, v in want.items():
        if v.numel() == 0:                     # a ring of width 0
            continue
        scale = max(float(v.float().abs().max()), 1e-30)
        err = float((got[k].float() - v.float()).abs().max()) / scale
        if err > 1e-3:
            raise AssertionError(f"cache {k}: error {err:.3e} of its "
                                 f"largest entry")
        worst = max(worst, err)
    return worst


def step_host(out) -> tuple:
    return tuple(x.cpu().numpy() for x in out[:4])


def phase_chunk_fused(models: dict) -> tuple:
    """The fused decoder phase (``fused_decoder`` set by
    ``dataclasses.replace`` on the same f32 weights) against the sequential
    micro-steps: one stream over 50 chunks and a 256-slot pool with reset
    and advance masks, ids (near-ties reported), caches within 1e-3 of each
    leaf's largest entry; then both paths chained, one stream and the
    256-slot tick, with every implicit sync an error. Returns K1's and
    K1b's launches in the chained runs."""
    from tensorflowasr_tpu_torch.testing import with_fused_decoder

    dev = torch.device("cuda")
    seq = models["float32"]
    fused = with_fused_decoder(seq)
    signal = tones(STREAM_CHUNKS * CHUNK_S, seed=70)             # 8 s
    chunks = torch.from_numpy(signal.reshape(STREAM_CHUNKS, 1, -1)).to(dev)

    # one stream, step by step
    diffs, worst = IdDiffs(fused), 0.0
    with torch.no_grad():
        caches = {m: m.init_stream_caches(1) for m in (seq, fused)}
        for i in range(STREAM_CHUNKS):
            rf = caches[fused]["dec_ring_fill"].cpu().numpy()
            outs = {}
            for m in (seq, fused):
                out = m.fused_stream_step(chunks[i], caches[m])
                caches[m] = out[4]
                outs[m] = step_host(out)
            diffs.check(outs[seq], outs[fused], rf, [0], f"chunk {i}")
            worst = max(worst, cache_error(caches[fused], caches[seq]))
    log(f"chunk_fused: one f32 stream, {STREAM_CHUNKS} chunks, fused "
        f"against sequential: phone ids and n_final identical; "
        f"{diffs.close()}; caches within {worst:.3e} of each leaf's largest "
        f"entry")

    # a 256-slot pool with reset and advance masks
    rng = np.random.default_rng(11)
    pool = np.stack([tones(FUSED_POOL_TICKS * CHUNK_S, seed=500 + i)
                     for i in range(POOL_SLOTS)]).reshape(
        POOL_SLOTS, FUSED_POOL_TICKS, CHUNK_SAMPLES)
    pos = np.zeros(POOL_SLOTS, int)
    diffs, worst, advanced = IdDiffs(fused), 0.0, 0
    with torch.no_grad():
        caches = {m: m.init_multi_stream_caches(POOL_SLOTS)
                  for m in (seq, fused)}
        for tick in range(FUSED_POOL_TICKS):
            adv = rng.random(POOL_SLOTS) < 0.8
            reset = (rng.random(POOL_SLOTS) < 0.05) | (tick == 0)
            pos[reset] = 0
            wav = torch.from_numpy(pool[np.arange(POOL_SLOTS),
                                        np.minimum(pos, FUSED_POOL_TICKS - 1)]
                                   ).to(dev)
            rf = np.where(reset, 0,
                          caches[fused]["dec_ring_fill"].cpu().numpy())
            outs = {}
            for m in (seq, fused):
                out = m.batched_stream_step(
                    wav, caches[m], torch.from_numpy(reset).to(dev),
                    torch.from_numpy(adv).to(dev))
                caches[m] = out[4]
                outs[m] = step_host(out)
            diffs.check(outs[seq], outs[fused], rf, np.nonzero(adv)[0],
                        f"tick {tick}")
            worst = max(worst, cache_error(caches[fused], caches[seq]))
            pos += adv
            advanced += int(adv.sum())
    log(f"chunk_fused: {POOL_SLOTS}-slot pool, {FUSED_POOL_TICKS} ticks "
        f"with reset and advance masks ({advanced} slot steps advanced), "
        f"fused against sequential: phone ids and n_final identical; "
        f"{diffs.close()}; caches within {worst:.3e} of each leaf's largest "
        f"entry")

    # both paths chained with no implicit sync
    first = torch.from_numpy(pool[:, 0].copy()).to(dev)

    def run():
        for m in (seq, fused):
            state = {"caches": m.init_stream_caches(1), "i": 0}

            def step():
                out = m.fused_stream_step(chunks[state["i"]],
                                          state["caches"])
                state["caches"] = out[4]
                state["i"] += 1

            without_syncs(step, STREAM_CHUNKS)
            state["caches"] = m.init_multi_stream_caches(POOL_SLOTS)

            def tick():
                *_, state["caches"] = m.batched_stream_step(
                    first, state["caches"])

            without_syncs(tick, POOL_TICKS)

    with torch.no_grad():
        _, launches = counted(run)
    expect(launches, 2 * (STREAM_CHUNKS + POOL_TICKS),
           "the chained fused and sequential steps")
    log(f"chunk_fused: both decoders chained with no implicit sync: one "
        f"stream over {STREAM_CHUNKS} chunks and the {POOL_SLOTS}-slot step "
        f"over {POOL_TICKS} ticks")
    return launches


# ---------------------------------------------------------------------------
# Chunk training: ChunkTrainer on ChunkConformer(S)
# ---------------------------------------------------------------------------

def phase_chunk_train(steps: int = 10) -> int:
    """A warm chunk ``train_step`` and ``steps`` more in f32 and in bf16.
    Returns K1's and K1b's launches in the ``train_step`` calls alone."""
    numpy_batch = chunk_train_batch()
    launches = (0, 0)
    for dtype in ("float32", "bfloat16"):
        trainer = new_chunk_trainer(dtype, "cuda")
        state = trainer.state
        batch = trainer._prepare_batch(numpy_batch)

        def run():
            return [trainer.train_step(state, batch)[1]["train_loss"]
                    for _ in range(steps + 1)]

        losses, n = counted(run)
        if state.step != steps + 1:
            raise AssertionError(f"{state.step} chunk train steps, not "
                                 f"{steps + 1}")
        launches = add(launches, expect(n, state.step,
                                        f"{state.step} chunk train steps"))
        values = [float(v) for v in torch.stack(losses).cpu()]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"non-finite train_loss: {values}")
        log(f"chunk_train: {dtype} train_step B={TRAIN_B} x {TRAIN_SECONDS} "
            f"s, 64 + 64 phones, 32 + 32 chars: train_loss first "
            f"{values[0]:.4f}, last {values[-1]:.4f} after {steps} steps")
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


def phase_chunk_train_cli(tmp: str) -> int:
    """``cli.train_asr`` with the chunk config, then ``cli.eval_am`` and
    ``cli.test_chunk_asr`` restoring its checkpoint, in ``tmp``, which keeps
    the corpus and the checkpoint for the serve_socket phase. Returns K1's
    and K1b's launches."""
    from tensorflowasr_tpu_torch.cli import eval_am, test_chunk_asr, train_asr
    from tensorflowasr_tpu_torch.utils.audio import write_wav

    root = os.path.dirname(os.path.abspath(__file__))
    data_yml = write_corpus(tmp)
    wav_path = os.path.join(tmp, "utt.wav")
    write_wav(wav_path, tones(CLI_CHUNKS * CHUNK_S, seed=91), SR)
    common = ["--data_config", data_yml, "--model_config",
              os.path.join(root, "configs", "chunk_conformerS.yml"),
              "--device", "cuda", "--compute_dtype", "float32"]

    def run():
        if train_asr.main(common + ["--total_steps", "3",
                                    "--data_workers", "2"]) != 0:
            raise AssertionError("cli.train_asr (chunk) failed")
        return (run_cli(eval_am.main, common + ["--max_batches", "1"]),
                run_cli(test_chunk_asr.main, common + ["--wav", wav_path]))

    ((result, _, eval_err), (_, tested, test_err)), launches = counted(run)
    ckpts = sorted(os.listdir(os.path.join(tmp, "logs", "checkpoints")))
    with open(os.path.join(tmp, "logs", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    for what, err in (("eval_am", eval_err), ("test_chunk_asr", test_err)):
        if "no checkpoint found" in err:
            raise AssertionError(f"cli.{what}: stderr {err[-400:]}")
    if ckpts != ["ckpt_000000003.pt"]:
        raise AssertionError(f"checkpoints {ckpts}")
    if [m["step"] for m in logged] != [2] or not math.isfinite(
            logged[0]["train_loss"]):
        raise AssertionError(f"metrics.jsonl {logged}")
    for key in ("phone_cer", "phone_ser", "char_cer", "char_ser"):
        if not math.isfinite(result[key]):
            raise AssertionError(f"eval_am: {key} = {result[key]}")
    lines = dict(line.split(":", 1) for line in tested.splitlines()
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
    log(f"chunk_train_cli: train_asr f32, 3 steps of B={CLI_B} (train_loss "
        f"{logged[0]['train_loss']:.3f} at step 2), checkpoints {ckpts}; "
        f"eval_am restored step 3 and scored 1 batch: {json.dumps(result)}; "
        f"test_chunk_asr restored step 3: streamed phones = offline phones "
        f"({len(offline)}) on an {CLI_CHUNKS * CHUNK_S:.0f} s wav")
    return launches


# ---------------------------------------------------------------------------
# The socket model server: cli.serve_model's build_ops on a TCP port
# ---------------------------------------------------------------------------

SOCKET_SECONDS = (2.0, 3.5, 5.0, 8.0)
SOCKET_PACKETS = (2203, 777, 4100, 1501)      # odd-sized stream_feed packets


def offline_request(client, wav: np.ndarray) -> dict:
    """What ``asr_client`` does for one file, as ``ASREngine.decode`` does
    it: ``info``, ``encode`` for each chunk, the encoder rows padded to
    whole groups of 4 chunks, ``ctc_logits``, greedy CTC on the host, the
    phones padded with 10 zeros, ``translate``. Returns the ids and the
    tensors that came over the wire."""
    cs = int(client.call("info")[0][0])
    encs = [client.call("encode", wav[None, i:i + cs])[0]
            for i in range(0, len(wav), cs)]
    frames = encs[0].shape[0]                 # a whole chunk's rows
    enc = np.concatenate(encs)
    groups = -(-(-(-len(enc) // frames)) // 4) * 4
    buf = np.zeros((groups * frames, enc.shape[1]), np.float32)
    buf[:len(enc)] = enc
    logits = client.call("ctc_logits", buf)[0]
    blank = logits.shape[-1] - 1
    ids = logits[:len(enc)].argmax(-1)
    phones = [int(p) for j, p in enumerate(ids)
              if p != blank and (j == 0 or p != ids[j - 1])]
    padded = np.zeros((1, len(buf) + 10), np.int32)
    padded[0, :len(phones)] = phones
    char_logits = client.call("translate", padded, buf)[0]
    return {"phones": phones, "chars": char_logits.argmax(-1).tolist(),
            "tensors": (encs, buf, logits, padded, char_logits)}


def stream_request(client, wav: np.ndarray) -> dict:
    """``stream_open``, ``stream_feed`` in odd-sized packets,
    ``stream_close``."""
    slot = client.call("stream_open")[0]
    off, k = 0, 0
    while off < len(wav):
        pkt = wav[off:off + SOCKET_PACKETS[k % len(SOCKET_PACKETS)]]
        off, k = off + len(pkt), k + 1
        client.call("stream_feed", slot, pkt)
    ph, ch = client.call("stream_close", slot)
    return {"phone_ids": ph.tolist(), "char_ids": ch.tolist()}


@torch.no_grad()
def calibrate_checkpoints(cli_data: str, model_yml: str, chunk_data: str,
                          chunk_yml: str) -> str:
    """Save each CLI phase's newest checkpoint again as its next step with
    the blank bias moved by the median margin of the blank logit on 4 x 4
    s of gated tones (the chunk model also with its first conv x10:
    ``testing.calibrate``): a few steps from a random init
    decode every frame as blank, and the served ids would be empty."""
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.testing import calibrate
    from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer
    from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    config = UserConfig(cli_data, model_yml)
    phone_f, char_f = build_featurizers(config)[:2]
    trainer = CTCTrainer(config, phone_f.num_classes, char_f.num_classes,
                         blank_id=phone_f.blank, device="cuda")
    ctrainer = ChunkTrainer(UserConfig(chunk_data, chunk_yml),
                            phone_f.num_classes, char_f.num_classes,
                            device="cuda")
    for t in (trainer, ctrainer):
        t.init_state()
        if not t.restore():
            raise AssertionError(f"no checkpoint under {t.outdir}")
    model = trainer.state.model.eval()
    warm = torch.from_numpy(np.stack([tones(4.0, seed=60 + i)
                                      for i in range(4)])).to(trainer.device)
    logits = model.ctc_logits(model.encode(warm))
    blank = model.num_phone_classes - 1
    margin = (logits[..., blank] - logits[..., :blank].amax(-1)).median()
    model.ctc_decoder.fully_connected.bias[blank] -= margin
    moved = calibrate(ctrainer.state.model)
    for t in (trainer, ctrainer):
        t.state.step += 1
        t.save()
    return (f"blank biases moved by {-float(margin):.4f} (offline) and "
            f"{moved:.4f} (chunk, first conv x10), saved as steps "
            f"{trainer.state.step} and {ctrainer.state.step}")


def phase_serve_socket(cli_dir: str, chunk_dir: str) -> tuple:
    """``cli.serve_model``'s ``build_ops`` (the code ``main`` runs) on the
    cli phase's ConformerCTC(S) checkpoint and the chunk train CLI's
    ChunkConformer(S) checkpoint, with ``fused_decoder`` set in a copy of
    the shipped chunk config and a 256-slot pool, served on a 127.0.0.1
    TCP port with the offline ops on this thread. One client streams the 8
    s file alone; then 4 client threads each send one file of 2 / 3.5 / 5 /
    8 s, as an offline request and as a stream. Each result must equal the
    in-process ``ASREngine``'s and an independent ``ChunkStreamSession``'s
    on the same checkpoints. Returns K1's and K1b's launches in the served
    window."""
    import yaml

    from tensorflowasr_tpu_torch.cli import serve_model
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.serve.chunk_session import (
        ChunkStreamSession,
    )
    from tensorflowasr_tpu_torch.serve.engines import ASREngine
    from tensorflowasr_tpu_torch.serve.model_server import (
        ModelClient,
        ModelServer,
    )
    from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer
    from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    root = os.path.dirname(os.path.abspath(__file__))
    model_yml = os.path.join(root, "configs", "conformerS.yml")
    with open(os.path.join(root, "configs", "chunk_conformerS.yml")) as f:
        chunk_cfg = yaml.safe_load(f)
    chunk_cfg["model_config"]["fused_decoder"] = True
    chunk_yml = os.path.join(chunk_dir, "chunk_conformerS_fused.yml")
    with open(chunk_yml, "w") as f:
        yaml.safe_dump(chunk_cfg, f)
    cli_data = os.path.join(cli_dir, "data.yml")
    chunk_data = os.path.join(chunk_dir, "data.yml")
    calibrated = calibrate_checkpoints(cli_data, model_yml, chunk_data,
                                       chunk_yml)
    args = serve_model.parser().parse_args([
        "--data_config", cli_data, "--model_config", model_yml,
        "--chunk_data_config", chunk_data, "--chunk_model_config", chunk_yml,
        "--stream_slots", str(POOL_SLOTS), "--stream_wait_ms", "8",
        "--port", "0", "--device", "cuda", "--compute_dtype", "float32",
        "--log_level", "WARNING"])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        ops, inline_ops, front = serve_model.build_ops(args)
    if "checkpoint under" in err.getvalue():
        raise AssertionError(f"serve_model: {err.getvalue()[-400:]}")

    # the references: the same checkpoints restored independently
    wavs = [tones(s, seed=400 + i) for i, s in enumerate(SOCKET_SECONDS)]
    config = UserConfig(cli_data, model_yml)
    phone_f, char_f = build_featurizers(config)[:2]
    trainer = CTCTrainer(config, phone_f.num_classes, char_f.num_classes,
                         blank_id=phone_f.blank, device="cuda")
    trainer.init_state()
    ctrainer = ChunkTrainer(UserConfig(chunk_data, chunk_yml),
                            phone_f.num_classes, char_f.num_classes,
                            device="cuda")
    ctrainer.init_state()
    if not (trainer.restore() and ctrainer.restore()):
        raise AssertionError("a checkpoint did not restore")
    engine = ASREngine(trainer.state.model.eval(),
                       sample_rate=trainer.sample_rate)
    cmodel = ctrainer.state.model.eval()
    if not cmodel.cfg.fused_decoder:
        raise AssertionError("the chunk model does not run fused")
    offline_want, stream_want = [], []
    for w in wavs:
        encs = [engine.extract_feature(w[i:i + engine.chunk_samples])
                for i in range(0, len(w), engine.chunk_samples)]
        ids, lens, chars = engine._decode(encs, engine.pad_chunks)
        offline_want.append((ids[0, :lens[0]].tolist(), chars[0].tolist(),
                             encs))
        session = ChunkStreamSession(cmodel, device="cuda")
        session.feed(w)
        stream_want.append(session.flush())
    del trainer, ctrainer

    srv = front._srv
    ticks = []
    dispatch = srv._dispatch

    def spy(adv):
        ticks.append(int(adv.sum()))
        return dispatch(adv)

    srv._dispatch = spy
    server = ModelServer(ops, tcp_port=0, inline_exec=False,
                         inline_ops=inline_ops)
    results = {"alone": None, "offline": [None] * 4, "stream": [None] * 4}
    failures = []

    def client_alone():
        client = ModelClient(tcp_port=server.tcp_port)
        try:
            results["alone"] = stream_request(client, wavs[-1])
        finally:
            client.close()

    def client(i):
        cli = ModelClient(tcp_port=server.tcp_port)
        try:
            results["offline"][i] = offline_request(cli, wavs[i])
            results["stream"][i] = stream_request(cli, wavs[i])
        finally:
            cli.close()

    def guarded(fn, *a):
        try:
            fn(*a)
        except BaseException as e:            # raised on the main thread
            failures.append(e)

    def drive():
        try:
            t = threading.Thread(target=guarded, args=(client_alone,),
                                 daemon=True)
            t.start()
            t.join(timeout=300)
            threads = [threading.Thread(target=guarded, args=(client, i),
                                        daemon=True) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            if any(t.is_alive() for t in threads):
                failures.append(AssertionError("a client hung"))
        finally:
            server.stop()

    def serve():
        server.start()
        clients = threading.Thread(target=drive, daemon=True)
        clients.start()
        server.run_worker_loop()          # the offline ops, this thread
        clients.join(timeout=30)

    _, launches = counted(serve)
    front.shutdown()
    if failures:
        raise failures[0]
    encodes = sum(-(-len(w) // engine.chunk_samples) for w in wavs)
    expect(launches, encodes + len(ticks),
           f"the served window ({encodes} encodes, {len(ticks)} ticks)")
    # the tensors that came over the wire against the same calls in
    # process, within 1e-5 of each one's largest entry
    model, dev, worst = engine.model, engine.device, 0.0

    def rel(got, want) -> float:
        err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
        if err > 1e-5:
            raise AssertionError(f"a served tensor is {err:.3e} off")
        return err

    for i, w in enumerate(wavs):
        off, st = results["offline"][i], results["stream"][i]
        encs, buf, logits, padded, char_logits = off["tensors"]
        for got, want in zip(encs, offline_want[i][2]):
            worst = max(worst, rel(got, want))
        with torch.no_grad():
            enc = torch.from_numpy(buf[None]).to(dev)
            worst = max(worst, rel(logits, model.ctc_logits(enc)[0].cpu()
                                   .numpy()))
            worst = max(worst, rel(char_logits, model.translate(
                torch.from_numpy(padded).to(dev), enc)[0].cpu().numpy()))
        if (off["phones"], off["chars"]) != offline_want[i][:2]:
            raise AssertionError(f"file {i}: the offline request differs "
                                 f"from ASREngine's decode")
        want = stream_want[i]
        if [st["phone_ids"], st["char_ids"]] != [want["phone_ids"],
                                                 want["char_ids"]]:
            raise AssertionError(f"file {i}: the stream differs from an "
                                 f"independent ChunkStreamSession's")
    if [results["alone"]["phone_ids"], results["alone"]["char_ids"]] != [
            stream_want[-1]["phone_ids"], stream_want[-1]["char_ids"]]:
        raise AssertionError("the lone stream differs from its session's")
    log(f"serve_socket: checkpoints of phases 8 and 15, {calibrated}; "
        f"{len(wavs)} files of {SOCKET_SECONDS} s over "
        f"127.0.0.1:{server.tcp_port}, offline and streamed, = ASREngine "
        f"and independent ChunkStreamSessions (phones "
        f"{[len(o[0]) for o in offline_want]} offline; phones "
        f"{[len(s['phone_ids']) for s in stream_want]}, chars "
        f"{[len(s['char_ids']) for s in stream_want]} streamed); encoder "
        f"rows, CTC and char logits over the wire within {worst:.3e} of the "
        f"in-process calls")
    if not all(o[0] for o in offline_want) or not all(
            s["phone_ids"] for s in stream_want):
        raise AssertionError("a decode is empty: nothing was compared")
    return launches



# ---------------------------------------------------------------------------
# VAD and punctuation serving: StreamASRSession, the VAD-segmented
# OfflineASRSession, the served vad op, native export from port weights
# ---------------------------------------------------------------------------

VAD_FILE_SECONDS = (2.0, 3.5, 5.0, 8.0)
PUNC_THRESHOLD = 0.65          # PuncEngine's default
PACKET = 320                   # 20 ms of 16 kHz pcm16


class Tap:
    """Keeps what ``obj.name`` returns while it is installed (the method is
    called as before)."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.seen = obj, name, []
        fn = getattr(obj, name)

        def tapped(*args):
            out = fn(*args)
            self.seen.append(out)
            return out
        setattr(obj, name, tapped)

    def remove(self) -> list:
        delattr(self.obj, self.name)
        return self.seen


@torch.no_grad()
def open_char_stops(model, wav: np.ndarray, stop_ids: tuple) -> float:
    """Lower the translator's biases of the char ids that end a decode (0
    and ``</S>``) until neither wins a position of ``wav``'s greedy decode:
    a few-step checkpoint stops after one char or none, and punctuation,
    which needs 5, would never run. Returns how far they moved."""
    from tensorflowasr_tpu_torch.ops.ctc import ctc_greedy_decode

    dev = model.ctc_decoder.fully_connected.weight.device
    enc = model.encode(torch.from_numpy(wav[None]).to(dev))
    logits = model.ctc_logits(enc)
    ids, _ = ctc_greedy_decode(
        logits, torch.tensor([enc.shape[1]], dtype=torch.int32, device=dev),
        model.num_phone_classes - 1)
    chars = model.translate(torch.nn.functional.pad(ids, (0, 10)), enc)[0]
    stops = list(stop_ids)
    rest = torch.ones(chars.shape[-1], dtype=torch.bool, device=dev)
    rest[stops] = False
    margin = float((chars[:, stops].amax(-1) - chars[:, rest].amax(-1))
                   .max()) + 1.0
    model.translator.fully_connected.bias[stops] -= max(margin, 0.0)
    return max(margin, 0.0)


def vad_punc_engines(cli_data: str, work: str, stream: np.ndarray,
                     device: str) -> tuple:
    """The serving engines of the phase on ``device``: ASREngine over the
    cli phase's calibrated ConformerCTC(S) checkpoint; VADEngine over a
    full-width OnlineVAD (``configs/vad_model.yml``) with seeded weights
    whose ``fc`` layer is calibrated on ``stream`` (the ASR's stop chars
    kept from ending its decodes early, ``open_char_stops``); PuncEngine
    over a full-width PuncTransformer (``configs/punc_settings.yml``) on a
    synthetic vocabulary of the ASR's chars, its class layer calibrated.
    The VAD's calibrated weights are saved as the checkpoint of a VAD data
    config in ``work``. Returns (engines, their models, the VAD configs,
    calibration notes, (ASR chars, punctuation chars, punctuation
    tokens))."""
    import yaml

    from tensorflowasr_tpu_torch.cli.common import (
        build_featurizers,
        build_punc_model,
        build_vad_model,
    )
    from tensorflowasr_tpu_torch import testing as synth
    from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer
    from tensorflowasr_tpu_torch.train.checkpoint import CheckpointManager
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    root = os.path.dirname(os.path.abspath(__file__))
    model_yml = os.path.join(root, "configs", "conformerS.yml")
    config = UserConfig(cli_data, model_yml)
    phone_f, char_f = build_featurizers(config)[:2]
    trainer = CTCTrainer(config, phone_f.num_classes, char_f.num_classes,
                         blank_id=phone_f.blank, device=device)
    trainer.init_state()
    if not trainer.restore():
        raise AssertionError(f"no checkpoint under {trainer.outdir}")
    asr_model = trainer.state.model.eval()
    stops = open_char_stops(asr_model, stream, (0, char_f.endid()))

    with open(os.path.join(root, "configs", "vad_data.yml")) as f:
        vad_cfg = yaml.safe_load(f)
    vad_cfg["running_config"]["outdir"] = os.path.join(work, "vad-logs")
    vad_data = os.path.join(work, "vad_data.yml")
    with open(vad_data, "w") as f:
        yaml.safe_dump(vad_cfg, f)
    vad_yml = os.path.join(root, "configs", "vad_model.yml")
    vad_model, vad_state = build_vad_model(UserConfig(vad_data, vad_yml),
                                           device)
    vad_margin = synth.calibrate_vad(vad_model, stream)
    CheckpointManager(os.path.join(work, "vad-logs", "checkpoints")).save(
        1, vad_state)

    # every char of the ASR's vocabulary but each 7th (out of vocabulary)
    chars = [t for t in char_f.vocab_array if t not in ("<S>", "</S>")]
    with open(os.path.join(work, "punc_chars.txt"), "w") as f:
        f.write("\n".join(["<S>", "</S>"] + [
            c for i, c in enumerate(chars) if i % 7]))
    with open(os.path.join(work, "punc_tokens.txt"), "w") as f:
        f.write("\n".join(["<S>", "</S>", *synth.PUNC_TOKENS]))
    with open(os.path.join(work, "punc.list"), "w") as f:
        f.write(f"{chars[1]}{chars[2]}{synth.PUNC_TOKENS[1]}\n")
    with open(os.path.join(root, "configs", "punc_settings.yml")) as f:
        punc_cfg = yaml.safe_load(f)
    punc_cfg["punc_vocab"]["vocabulary"] = os.path.join(work,
                                                        "punc_chars.txt")
    punc_cfg["punc_biaodian"]["vocabulary"] = os.path.join(
        work, "punc_tokens.txt")
    for key in ("train_list", "eval_list"):
        punc_cfg["running_config"][key] = os.path.join(work, "punc.list")
    punc_cfg["running_config"]["outdir"] = os.path.join(work, "punc-logs")
    punc_yml = os.path.join(work, "punc_settings.yml")
    with open(punc_yml, "w") as f:
        yaml.safe_dump(punc_cfg, f, allow_unicode=True)
    punc_f, dl, punc_model, _ = build_punc_model(
        UserConfig(punc_yml, punc_yml), device)
    rng = np.random.default_rng(8)
    ids = rng.integers(3, punc_f.num_classes, (16, 64))
    ids[:, 0], ids[:, -1] = punc_f.startid(), punc_f.endid()
    share = synth.calibrate_punc(punc_model, ids, PUNC_THRESHOLD)

    models = {"asr": asr_model, "vad": vad_model, "punc": punc_model}
    engines = make_engines(models, char_f, punc_f, dl.punc_tokens, device)
    notes = (f"ASR checkpoint step {trainer.state.step} ({len(chars)} "
             f"chars; the stop chars' biases lowered by {stops:.3f}), VAD "
             f"dmodel {vad_model.dmodel} calibrated (smallest "
             f"|logit| off the onsets {vad_margin:.3f}), punctuation "
             f"{punc_model.cfg.num_layers} layers x d {punc_model.cfg.d_model}"
             f" over {punc_f.num_classes} ids, {dl.num_punc_classes} classes, "
             f"{share:.3f} of the calibration positions insert")
    return engines, models, (vad_data, vad_yml), notes, (
        char_f, punc_f, dl.punc_tokens)


def make_engines(models: dict, char_f, punc_f, punc_tokens,
                 device: str) -> dict:
    from tensorflowasr_tpu_torch.serve.engines import (
        ASREngine,
        PuncEngine,
        VADEngine,
    )

    return {"asr": ASREngine(models["asr"], sample_rate=SR,
                             text_featurizer=char_f),
            "vad": VADEngine(models["vad"], device=device),
            "punc": PuncEngine(models["punc"], punc_f, punc_tokens,
                               threshold=PUNC_THRESHOLD, device=device)}


def live_session(engines: dict, packets: list) -> dict:
    """``StreamASRSession`` with VAD and punctuation over ``packets``
    (pcm16 bytes), then ``final_send``: the events (task ids dropped) and
    the encoder rows the ASR engine returned."""
    from tensorflowasr_tpu_torch.serve.stream_session import (
        StreamASRSession,
    )

    tap = Tap(engines["asr"], "extract_feature")
    session = StreamASRSession(engines["asr"], engines["vad"],
                               punc=engines["punc"], sample_rate=SR)
    events = []
    for pkt in packets + [None]:
        ev = session.send(pkt) if pkt is not None else session.final_send()
        if ev:
            ev.pop("task_id", None)
            events.append(ev)
    return {"events": events, "enc": tap.remove()}


def phase_serve_vad_punc(cli_dir: str, chunk_dir: str,
                         device: str = "cuda") -> tuple:
    """The VAD and punctuation serving path on the card: a live
    ``StreamASRSession`` over 8 s of tone bursts in 20 ms pcm16 packets,
    the VAD-segmented and punctuated ``OfflineASRSession`` on 2 / 3.5 / 5 /
    8 s files, each against the same objects on the CPU; the ``vad`` op of
    ``cli.serve_model.build_ops`` with the VAD configs over a TCP socket
    against the in-process engine; and the native artifacts of the
    offline, chunk and VAD models read back. Returns K1's and K1b's
    launches in the session and the files on the card."""
    import copy
    import filecmp

    from tensorflowasr_tpu_torch import testing as synth
    from tensorflowasr_tpu_torch.cli import serve_model
    from tensorflowasr_tpu_torch.export import native_export as nx
    from tensorflowasr_tpu_torch.models import convert
    from tensorflowasr_tpu_torch.ops import frontend as fe
    from tensorflowasr_tpu_torch.serve.model_server import (
        ModelClient,
        ModelServer,
    )
    from tensorflowasr_tpu_torch.serve.offline_session import (
        OfflineASRSession,
    )
    from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    work = os.path.join(cli_dir, "vad_punc")
    os.makedirs(work)
    stream = synth.tone_bursts(synth.STREAM_PATTERN, seed=1)
    pcm = (np.clip(stream, -1, 1) * 32767).astype("<i2")
    packets = [pcm[i:i + PACKET].tobytes()
               for i in range(0, len(pcm), PACKET)]
    cli_data = os.path.join(cli_dir, "data.yml")
    engines, models, (vad_data, vad_yml), notes, vocabs = vad_punc_engines(
        cli_data, work, stream, device)
    log(f"serve_vad_punc: {notes}")

    # the live session and the offline files, on the card and with copies
    # of the same models on the CPU
    files = [synth.tone_bursts(synth.file_pattern(s), seed=40 + i)
             for i, s in enumerate(VAD_FILE_SECONDS)]
    encodes = []
    model = engines["asr"].model
    encode = model.encode

    def counting_encode(wav, *lengths):
        encodes.append(wav.shape)
        return encode(wav, *lengths)
    model.encode = counting_encode

    def card():
        live = live_session(engines, packets)
        n_live = len(encodes)
        offline = []
        for wav in files:
            offline.append(OfflineASRSession(
                engines["asr"], engines["vad"],
                engines["punc"]).transcribe_wav(wav))
            OfflineASRSession(engines["asr"]).transcribe_wav(wav)
        return live, n_live, offline

    (live, n_live, offline), launches = counted(card)
    del model.encode
    # the plain file decodes (without VAD) launched too: every encode
    expect(launches, len(encodes), f"the phase's {len(encodes)} encodes "
           f"({n_live} in the live session)")
    cpu_models = {k: copy.deepcopy(m).cpu() for k, m in models.items()}
    cpu = make_engines(cpu_models, *vocabs, "cpu")
    live_cpu = live_session(cpu, packets)
    offline_cpu = [OfflineASRSession(cpu["asr"], cpu["vad"], cpu["punc"])
                   .transcribe_wav(wav) for wav in files]

    enc_err = max(float(np.abs(a - b).max())
                  for a, b in zip(live["enc"], live_cpu["enc"]))
    if len(live["enc"]) != len(live_cpu["enc"]) or enc_err > 1e-3:
        raise AssertionError(f"encoder rows card vs CPU: {enc_err:.3e} "
                             f"over {len(live['enc'])} / "
                             f"{len(live_cpu['enc'])} encodes")
    if live["events"] != live_cpu["events"]:
        diff = [(a, b) for a, b in zip(live["events"], live_cpu["events"])
                if a != b][:2]
        raise AssertionError(f"the live session's events differ card vs "
                             f"CPU ({len(live['events'])} / "
                             f"{len(live_cpu['events'])}): {diff}")
    types = [e["event_type"] for e in live["events"]]
    texts = [e["best_text"] for e in live["events"]
             if e["event_type"] in ("inter break", "sentence end")]
    if "sentence begin" not in types or "sentence end" not in types or \
            not any(texts):
        raise AssertionError(f"the live session decided nothing: {types}")
    if offline != offline_cpu:
        raise AssertionError("the VAD-segmented files differ card vs CPU")
    if not all(len(segs) > 1 and any(s["text"] for s in segs)
               for segs in offline):
        raise AssertionError(f"a file was not segmented: {offline}")
    punctuated = sum(any(p in t for p in synth.PUNC_TOKENS) for t in texts)
    if not punctuated:
        raise AssertionError(f"no text was punctuated: {texts}")
    log("serve_vad_punc: live session events card = CPU: "
        + ", ".join(f"{types.count(t)} {t}" for t in
                    ("sentence begin", "result change", "inter break",
                     "sentence end"))
        + f"; {punctuated} of {len(texts)} texts punctuated, text lengths "
        f"{[len(t) for t in texts]}; encoder rows within {enc_err:.3e} over "
        f"{len(live['enc'])} encodes; the 4 files' segments "
        f"{[len(s) for s in offline]} and texts card = CPU")

    # the vad op over the socket (cli.serve_model with the VAD configs) on
    # 1 s of 8 kHz audio and on the whole stream
    frames = synth.vad_frames(stream)
    second = np.ascontiguousarray(frames[:, 100:200])
    model_yml = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "configs", "conformerS.yml")
    args = serve_model.parser().parse_args([
        "--data_config", cli_data, "--model_config", model_yml,
        "--vad_data_config", vad_data, "--vad_model_config", vad_yml,
        "--port", "0", "--device", device, "--compute_dtype", "float32",
        "--log_level", "WARNING"])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        ops, inline_ops, _ = serve_model.build_ops(args)
    if "checkpoint" in err.getvalue():
        raise AssertionError(f"serve_model: {err.getvalue()[-400:]}")
    server = ModelServer(ops, tcp_port=0, inline_exec=False,
                         inline_ops=inline_ops)
    served, failures = {}, []

    def client():
        cli = ModelClient(tcp_port=server.tcp_port)
        try:
            for name, x in (("second", second), ("stream", frames)):
                served[name] = cli.call("vad", x)[0]
        except BaseException as e:            # raised on the main thread
            failures.append(e)
        finally:
            cli.close()
            server.stop()

    server.start()
    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    server.run_worker_loop()
    thread.join(timeout=30)
    if failures:
        raise failures[0]
    worst = 0.0
    for name, x in (("second", second), ("stream", frames)):
        want = engines["vad"].inference(x)
        got = served[name]
        err_v = float(np.abs(got - want).max() / np.abs(want).max())
        if got.shape != want.shape or err_v > 1e-5:
            raise AssertionError(f"served vad {name}: {err_v:.3e}")
        worst = max(worst, err_v)
    log(f"serve_vad_punc: cli.serve_model --vad_data_config/"
        f"--vad_model_config, the vad op over 127.0.0.1 on {frames.shape[1]} "
        f"and 100 frames: within {worst:.3e} of VADEngine in process")

    # native export from port weights: offline, chunk, VAD
    chunk_cfg = UserConfig(os.path.join(chunk_dir, "data.yml"),
                           os.path.join(os.path.dirname(model_yml),
                                        "chunk_conformerS.yml"))
    ctrainer = ChunkTrainer(chunk_cfg, engines["asr"].model.num_phone_classes,
                            engines["asr"].model.num_char_classes,
                            device=device)
    ctrainer.init_state()
    if not ctrainer.restore():
        raise AssertionError("no chunk checkpoint")
    artifacts = (("offline", nx.export_native, models["asr"], "same"),
                 ("chunk", nx.export_native_chunk, ctrainer.state.model,
                  "valid"),
                 ("vad", nx.export_native_vad, models["vad"], None))
    sizes = []
    for name, export, m, padding in artifacts:
        a, b = (os.path.join(work, f"{name}_{k}") for k in "ab")
        export(m, a)
        export(m, b)
        for f in ("weights.bin", "manifest.json", "manifest.txt"):
            if not filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                               shallow=False):
                raise AssertionError(f"{name}: {f} differs between writes")
        tensors = nx.read_native(a)
        want = convert.to_flax_names(m)
        if name == "vad":
            want = {k: v for k, v in want.items()
                    if k.split("/")[1] in nx.VAD_LAYERS}
        else:
            dft, fb = fe._frontend_constants(fe.LogMelFrontendConfig(
                sample_rate=m.cfg.sample_rate, stride_ms=m.cfg.stride_ms,
                n_mels=m.cfg.n_mels, padding=padding))
            want.update({"frontend/dft": dft, "frontend/freq2mel": fb})
        if sorted(tensors) != sorted(want) or not all(
                np.array_equal(tensors[k], v) for k, v in want.items()):
            raise AssertionError(f"{name}: the artifact does not hold the "
                                 f"model's weights")
        sizes.append(f"{name} {len(tensors)} tensors, "
                     f"{os.path.getsize(os.path.join(a, 'weights.bin'))} B")
    log(f"serve_vad_punc: native artifacts written twice with the same "
        f"bytes and read back bit for bit: {'; '.join(sizes)}")
    return launches


# ---------------------------------------------------------------------------
# VAD and punctuation training: OnlineVAD / OfflineVAD and PuncTransformer
# ---------------------------------------------------------------------------

VAD_SR, VAD_B, VAD_SECONDS = 8000, 16, 6       # configs/vad_data.yml
PUNC_B, PUNC_LEN, PUNC_VOCAB = 32, 64, 5000     # configs/punc_settings.yml
PUNC_MARKS = ("，", "。", "？", "！", "、")


def write_vad_corpus(root: str, n_utts: int = 24) -> str:
    """Seeded 8 kHz utterances (tone bursts between quiet stretches, 1-3
    s) and their list; returns the list's path."""
    from tensorflowasr_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(3)
    paths = []
    for i in range(n_utts):
        parts = []
        for _ in range(int(rng.integers(2, 5))):
            quiet = 0.003 * rng.standard_normal(
                int(rng.uniform(0.1, 0.4) * VAD_SR))
            t = np.arange(int(rng.uniform(0.2, 0.7) * VAD_SR)) / VAD_SR
            tone = rng.uniform(0.2, 0.8) * np.sin(
                2 * np.pi * rng.uniform(120, 1500) * t)
            parts += [quiet, tone + 0.003 * rng.standard_normal(len(t))]
        path = os.path.join(root, f"vad{i:03d}.wav")
        write_wav(path, np.concatenate(parts).astype(np.float32), VAD_SR)
        paths.append(path)
    lst = os.path.join(root, "vad.list")
    with open(lst, "w", encoding="utf-8") as f:
        f.write("\n".join(paths))
    return lst


def write_punc_corpus(root: str, n_lines: int = 200) -> tuple:
    """A seeded corpus of punctuated lines over a 5000-char vocabulary (the
    reference's is 5038), with 768-d teacher features, one ``.npy`` a line
    under the loader's name. Returns (chars path, tokens path, list path,
    features dir)."""
    import hashlib

    rng = np.random.default_rng(4)
    chars = [chr(0x4E00 + i) for i in range(PUNC_VOCAB)]
    feats = os.path.join(root, "bert")
    os.makedirs(feats)
    lines = []
    for _ in range(n_lines):
        n = int(rng.integers(20, 90))
        text = ""
        for j in range(n):
            text += chars[int(rng.integers(0, PUNC_VOCAB))]
            if rng.random() < 0.12 or j == n - 1:
                text += PUNC_MARKS[int(rng.integers(0, len(PUNC_MARKS)))]
        lines.append(text)
        name = hashlib.sha1(text.encode("utf-8")).hexdigest()[:16]
        np.save(os.path.join(feats, f"{name}.npy"),
                rng.standard_normal((n + 2, 768)).astype(np.float32))
    out = []
    for name, body in (("punc_chars.txt", ["<S>", "</S>"] + chars),
                       ("punc_tokens.txt", ["<S>", "</S>", *PUNC_MARKS]),
                       ("punc.list", lines)):
        out.append(os.path.join(root, name))
        with open(out[-1], "w", encoding="utf-8") as f:
            f.write("\n".join(body) + "\n")
    return (*out, feats)


def vad_punc_configs(root: str) -> dict:
    """The shipped VAD and punctuation YAMLs pointed at the corpora written
    to ``root`` (batch sizes, widths and optimizers as shipped; the VAD
    trains without evaluating). Returns their paths and the teacher
    features' dir."""
    import yaml

    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs")
    lst = write_vad_corpus(root)
    with open(os.path.join(conf, "vad_data.yml")) as f:
        vad = yaml.safe_load(f)
    vad["running_config"].update(
        train_list=lst, eval_list=lst, log_interval_steps=2,
        eval_interval_steps=1000, outdir=os.path.join(root, "vad-logs"))
    chars, tokens, punc_list, feats = write_punc_corpus(root)
    with open(os.path.join(conf, "punc_settings.yml")) as f:
        punc = yaml.safe_load(f)
    punc["punc_vocab"]["vocabulary"] = chars
    punc["punc_biaodian"]["vocabulary"] = tokens
    punc["running_config"].update(
        train_list=punc_list, eval_list=punc_list, log_interval_steps=2,
        eval_interval_steps=1000, outdir=os.path.join(root, "punc-logs"))
    out = {"vad_model": os.path.join(conf, "vad_model.yml"),
           "features": feats}
    for name, cfg in (("vad_data", vad), ("punc", punc)):
        out[name] = os.path.join(root, f"{name}.yml")
        with open(out[name], "w", encoding="utf-8") as f:
            yaml.safe_dump(cfg, f, allow_unicode=True)
    return out


def train_steps(step, state, batch, steps: int) -> list:
    """A warm step, then ``steps`` more: the train losses, which must be
    finite."""
    losses = [step(state, batch)[1]["train_loss"] for _ in range(steps + 1)]
    values = [float(v) for v in torch.stack(losses).cpu()]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite train_loss: {values}")
    return values


def card_vs_cpu(build, loss_fn, batch: dict, what: str) -> None:
    """One loss + backward of ``build(device)`` (the same seeded weights on
    each device) on the card and on the CPU: loss within 1e-4 relative, the
    gradient's global norm within 1e-3 relative."""
    result = {}
    for device in ("cuda", "cpu"):
        m = build(device).train()
        total, _ = loss_fn(m, {k: torch.from_numpy(v).to(device)
                               for k, v in batch.items()})
        total.backward()
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.double().norm() for p in m.parameters()
             if p.grad is not None]))
        result[device] = (float(total.detach()), float(norm))
    (lg, ng), (lc, nc) = result["cuda"], result["cpu"]
    loss_err, norm_err = abs(lg - lc) / abs(lc), abs(ng - nc) / nc
    log(f"vad_punc_train: {what} f32 card vs CPU: train_loss {lg:.6f} vs "
        f"{lc:.6f} (relative {loss_err:.3e}), gradient norm {ng:.6f} vs "
        f"{nc:.6f} (relative {norm_err:.3e})")
    if not (math.isfinite(lg) and loss_err <= 1e-4 and norm_err <= 1e-3):
        raise AssertionError(f"{what}: the step on the card disagrees with "
                             "the CPU")


def phase_vad_punc_train(steps: int = 10) -> tuple:
    """VAD and punctuation training on the card. The shipped models at full
    width with seeded weights: OnlineVAD (``configs/vad_model.yml``, dmodel
    32) on a batch of ``configs/vad_data.yml``'s shape, B = 16 x 6 s at 8
    kHz (x [16, 600, 80]) from ``VADDataLoader`` over a seeded corpus of
    tone bursts: a warm step and ``steps`` f32 steps, one step on the batch
    folded by ``streaming_reshape``, one OfflineVAD step; PuncTransformer
    (``configs/punc_settings.yml``) on B = 32 x 64 tokens from
    ``PuncDataLoader``, with and without 768-d teacher features, each a
    warm step and ``steps`` more. Each model's loss and gradient on the
    card against the CPU. Then ``cli.train_vad`` -> ``cli.eval_vad
    --export_native`` and ``cli.train_punc --bert_feature_dir`` ->
    ``cli.eval_punc`` on the corpora (4 steps each with a save; each eval
    must restore and print its JSON). No kernel of the port runs on this
    path: K1's and K1b's counts must stay 0. Returns them."""
    from tensorflowasr_tpu_torch.cli import (
        eval_punc,
        eval_vad,
        train_punc,
        train_vad,
    )
    from tensorflowasr_tpu_torch.cli.common import (
        build_punc_model,
        build_vad_model,
    )
    from tensorflowasr_tpu_torch.data.vad_dataloader import VADDataLoader
    from tensorflowasr_tpu_torch.models.vad import OfflineVAD
    from tensorflowasr_tpu_torch.train import punc_trainer, vad_trainer
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    with tempfile.TemporaryDirectory() as root:
        paths = vad_punc_configs(root)
        vad_config = UserConfig(paths["vad_data"], paths["vad_model"])
        punc_config = UserConfig(paths["punc"], paths["punc"])

        def run():
            dl = VADDataLoader(vad_config)
            numpy_vad = dl.generate(train=True)
            if numpy_vad["x"].shape != (VAD_B, VAD_SECONDS * 100, 80):
                raise AssertionError(f"VAD batch {numpy_vad['x'].shape}")
            model, state = build_vad_model(vad_config, "cuda")
            batch = {k: torch.from_numpy(v).cuda()
                     for k, v in numpy_vad.items()}
            step = vad_trainer.make_vad_train_step(model, global_batch=VAD_B)
            losses = train_steps(step, state, batch, steps)
            log(f"vad_punc_train: OnlineVAD dmodel {model.dmodel} f32 train "
                f"step B={VAD_B} x {VAD_SECONDS} s at {VAD_SR} Hz (x "
                f"{list(batch['x'].shape)}, "
                f"{float(numpy_vad['labels'].mean()):.3f} of the frames "
                f"voiced): train_loss {losses[0]:.4f} -> {losses[-1]:.4f}")
            folded = vad_trainer.streaming_reshape(
                numpy_vad, 8, np.random.default_rng(0))
            _, m = step(state, {k: torch.from_numpy(v).cuda()
                                for k, v in folded.items()})
            offline, off_state = build_vad_model(UserConfig(
                paths["vad_data"], paths["vad_model"],
                extra={"model_config": {"name": "CNN_Offline_VAD"}}), "cuda")
            if not isinstance(offline, OfflineVAD):
                raise AssertionError("not the offline VAD")
            _, m_off = vad_trainer.make_vad_train_step(
                offline, global_batch=VAD_B)(off_state, batch)
            log(f"vad_punc_train: one step folded by streaming_reshape to "
                f"x {list(folded['x'].shape)} (train_loss "
                f"{float(m['train_loss']):.4f}), one OfflineVAD step "
                f"(train_loss {float(m_off['train_loss']):.4f})")
            card_vs_cpu(lambda d: build_vad_model(vad_config, d)[0],
                        lambda m, b: vad_trainer.loss_and_metrics(m, b,
                                                                  VAD_B),
                        numpy_vad, "OnlineVAD")

            char_f, pdl, pmodel, pstate = build_punc_model(punc_config,
                                                           "cuda")
            pdl.bert_feature_dir = paths["features"]
            numpy_punc = pdl.generate(True)
            shapes = {k: v.shape for k, v in numpy_punc.items()}
            if shapes["ids"] != (PUNC_B, PUNC_LEN) or \
                    shapes["bert_features"] != (PUNC_B, PUNC_LEN, 768):
                raise AssertionError(f"punctuation batch {shapes}")
            pstep = punc_trainer.make_punc_train_step(pmodel)
            for with_feats in (True, False):
                b = {k: torch.from_numpy(v).cuda()
                     for k, v in numpy_punc.items()
                     if with_feats or k != "bert_features"}
                losses = train_steps(pstep, pstate, b, steps)
                log(f"vad_punc_train: PuncTransformer {pmodel.cfg.num_layers}"
                    f" layers x d {pmodel.cfg.d_model} ({char_f.num_classes} "
                    f"ids, {pdl.num_punc_classes} classes) f32 train step B="
                    f"{PUNC_B} x {PUNC_LEN} tokens "
                    f"{'with' if with_feats else 'without'} 768-d teacher "
                    f"features, dropout {pmodel.cfg.dropout}: train_loss "
                    f"{losses[0]:.4f} -> {losses[-1]:.4f}")
            # the card against the CPU at dropout 0 (its masks differ)
            quiet = UserConfig(paths["punc"], paths["punc"],
                               extra={"model_config": {"rate": 0.0}})
            card_vs_cpu(lambda d: build_punc_model(quiet, d)[2],
                        punc_trainer.loss_and_metrics, numpy_punc,
                        "PuncTransformer (teacher features, dropout 0)")

            vad_args = ["--data_config", paths["vad_data"], "--model_config",
                        paths["vad_model"], "--device", "cuda"]
            run_cli(train_vad.main, vad_args + ["--total_steps", "4"])
            native = os.path.join(root, "vad_native")
            got, _, err = run_cli(
                eval_vad.main, vad_args + ["--max_batches", "2",
                                           "--export_native", native])
            if "no VAD checkpoint" in err or set(got) != {"acc", "f1"} or \
                    not os.listdir(native):
                raise AssertionError(f"cli.eval_vad: {got}, {err[-300:]}")
            log(f"vad_punc_train: cli.train_vad 4 steps of B={VAD_B}; "
                f"cli.eval_vad restored step 4, wrote the native artifact "
                f"({sorted(os.listdir(native))}) and scored 2 batches: "
                f"{json.dumps(got)}")
            punc_args = ["--data_config", paths["punc"], "--model_config",
                         paths["punc"], "--device", "cuda"]
            run_cli(train_punc.main, punc_args + [
                "--total_steps", "4", "--bert_feature_dir",
                paths["features"]])
            got, _, err = run_cli(eval_punc.main,
                                  punc_args + ["--max_batches", "2"])
            if "no punctuation checkpoint" in err or \
                    set(got) != {"bd_acc", "bd_loss"}:
                raise AssertionError(f"cli.eval_punc: {got}, {err[-300:]}")
            with open(os.path.join(root, "punc-logs", "metrics.jsonl")) as f:
                logged = [json.loads(line) for line in f]
            if [m["step"] for m in logged] != [2, 4] or not all(
                    m["feature_map_loss"] > 0 for m in logged):
                raise AssertionError(f"train_punc's metrics {logged}")
            log(f"vad_punc_train: cli.train_punc 4 steps of B={PUNC_B} with "
                f"teacher features (train_loss "
                f"{logged[0]['train_loss']:.3f} -> "
                f"{logged[-1]['train_loss']:.3f}); cli.eval_punc restored "
                f"step 4 and scored 2 batches: {json.dumps(got)}")

        _, launches = counted(run)
    if launches != (0, 0):
        raise AssertionError(f"the VAD and punctuation path launched K1 and "
                             f"K1b {launches} times")
    log("vad_punc_train: K1 and K1b launched 0 times (no kernel of the "
        "port is on this path)")
    return launches


# ---------------------------------------------------------------------------
# Block streaming: ConformerCTC with speech_config.streaming (the chunks
# folded into the batch before the frontend), configs/Streaming_ConformerS.yml
# ---------------------------------------------------------------------------

BLOCK_TRAIN_CHUNKS = 17      # the loader's 8 s bucket, 128000 samples,
                             # rounded up to whole 7680-sample chunks
BLOCK_FILE_SECONDS = (2.0, 3.5, 5.0, 8.0)


def streaming_data_yml(root: str, source: str) -> str:
    """A copy of the data YAML ``source`` with ``streaming: true``."""
    import yaml

    with open(source) as f:
        data = yaml.safe_load(f)
    data["speech_config"].update(streaming=True, streaming_bucket=0.5)
    path = os.path.join(root, "streaming_" + os.path.basename(source))
    with open(path, "w") as f:
        yaml.safe_dump(data, f)
    return path


def block_trainer(data_yml: str, device: str, extra=None):
    from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    model_yml = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "configs", "Streaming_ConformerS.yml")
    trainer = CTCTrainer(UserConfig(data_yml, model_yml, extra=extra),
                         N_PHONE, N_CHAR, blank_id=N_PHONE - 1,
                         device=device, compute_dtype="float32")
    trainer.init_state(seed=0)
    return trainer


def phase_block_stream(steps: int = 10) -> tuple:
    """The block-streaming ConformerCTC on the card: seeded full-width
    ``configs/Streaming_ConformerS.yml`` (dmodel 256, 4 blocks, 4 x 64
    heads, kernel 5) with ``configs/am_data.yml``, ``streaming: true``
    written into a temporary copy. ``predict_step`` in f32 at B = 128 x 7.2
    s (15 chunks, folded to [1920, 7680] for K1b 'same'); f32 train steps
    at B = 128 x the loader's chunk-quantised 8 s (17 chunks, input_length
    204), a warm step and ``steps`` more;
    the encoder and one loss + backward on the card against the CPU on B =
    2 x 2 chunks; ``cli.train_asr`` -> ``cli.eval_am`` -> ``cli.test_asr``
    on ``write_corpus``'s corpus (test_asr's wav is a whole number of
    chunks, 16: the JAX package's test_asr pads a wav only to hop x
    reduction factor, so another length raises in its streaming encoder,
    and the port keeps that); ``OfflineASRSession`` on 2 / 3.5 / 5 / 8 s
    files, a file's 7680-sample chunks in one batched encode, its encoder
    rows joined within 1e-3 of the folded encode of the padded file. K1b's
    launches are counted exactly in each. Returns them."""
    from tensorflowasr_tpu_torch.cli import eval_am, test_asr, train_asr
    from tensorflowasr_tpu_torch.models.conformer import (
        StreamingConformerEncoder,
    )
    from tensorflowasr_tpu_torch.serve.engines import ASREngine, predict_step
    from tensorflowasr_tpu_torch.serve.offline_session import (
        MIN_PIECE_SAMPLES,
        OfflineASRSession,
    )
    from tensorflowasr_tpu_torch.utils.audio import write_wav

    root_dir = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda")
    launches = (0, 0)
    with tempfile.TemporaryDirectory() as root:
        data_yml = streaming_data_yml(
            root, os.path.join(root_dir, "configs", "am_data.yml"))
        trainer = block_trainer(data_yml, "cuda")
        model, cfg = trainer.state.model.eval(), trainer.model_cfg
        if (cfg.dmodel, cfg.num_blocks, cfg.num_heads, cfg.head_size,
                cfg.kernel_size, cfg.chunk_samples) != (256, 4, 4, 64, 5,
                                                        REQUEST_SAMPLES) or \
                not isinstance(model.encoder, StreamingConformerEncoder):
            raise AssertionError(f"not the full-width streaming config: {cfg}")
        chunk = cfg.chunk_samples
        seconds = BLOCK_CHUNKS * chunk / SR
        wav = torch.from_numpy(noise((BLOCK_B, BLOCK_CHUNKS * chunk),
                                     seed=21)).to(dev)
        t_enc = BLOCK_CHUNKS * chunk // 640
        length = torch.full((BLOCK_B,), t_enc, dtype=torch.int32, device=dev)

        out, n = counted(lambda: predict_step(model, wav, length))
        check_outputs(out, BLOCK_B, t_enc)
        launches = add(launches, expect(n, 1, "a block predict call"))
        log(f"block_stream: predict_step f32 B={BLOCK_B} x {seconds} s "
            f"({BLOCK_CHUNKS} chunks of {chunk}, K1b on "
            f"[{BLOCK_B * BLOCK_CHUNKS}, {chunk}]): shapes and ids in range")
        del wav

        # training at the loader's chunk-quantised 8 s bucket
        numpy_batch = train_batch(TRAIN_B, BLOCK_TRAIN_CHUNKS * chunk / SR,
                                  TRAIN_PHONES, TRAIN_CHARS)
        numpy_batch["input_length"][:] = BLOCK_TRAIN_CHUNKS * chunk // 640
        batch = trainer._prepare_batch(numpy_batch)
        losses, n = counted(lambda: train_steps(
            trainer.train_step, trainer.state, batch, steps))
        launches = add(launches, expect(n, steps + 1,
                                        f"{steps + 1} block train steps"))
        log(f"block_stream: train_step f32 B={TRAIN_B} x "
            f"{BLOCK_TRAIN_CHUNKS * chunk / SR} s ({BLOCK_TRAIN_CHUNKS} "
            f"chunks, input_length {BLOCK_TRAIN_CHUNKS * chunk // 640}), "
            f"{TRAIN_PHONES} phones, {TRAIN_CHARS} chars, dropout "
            f"{cfg.dropout}: train_loss {losses[0]:.4f} -> {losses[-1]:.4f}")
        del trainer, batch, model
        torch.cuda.empty_cache()

        # the card against the CPU, dropout 0, B = 2 x 2 chunks
        from tensorflowasr_tpu_torch.train.asr_trainer import (
            loss_and_metrics,
        )

        no_dropout = {"model_config": {"dropout": 0.0,
                                       "ctcdecoder_dropout": 0.0,
                                       "translator_dropout": 0.0}}
        small = train_batch(2, 2 * chunk / SR, 8, 4)
        small["input_length"][:] = 2 * chunk // 640
        result = {}
        for device in ("cuda", "cpu"):
            t = block_trainer(data_yml, device, extra=no_dropout)
            m = t.state.model
            b = t._prepare_batch(small)
            with torch.no_grad():
                enc = m.eval().encode(b["wav"]).cpu()
            total, _ = loss_and_metrics(m.train(), b, t.blank_id)
            total.backward()
            norm = torch.linalg.vector_norm(torch.stack(
                [p.grad.double().norm() for p in m.parameters()]))
            result[device] = (enc, float(total.detach()), float(norm))
        enc_err = within(result["cuda"][0], result["cpu"][0], rtol=0,
                         atol=1e-3)
        (_, lg, ng), (_, lc, nc) = result["cuda"], result["cpu"]
        loss_err, norm_err = abs(lg - lc) / abs(lc), abs(ng - nc) / nc
        log(f"block_stream: f32 card vs CPU on B=2 x 2 chunks, dropout 0: "
            f"encoder max|err| {enc_err:.3e}; train_loss {lg:.6f} vs "
            f"{lc:.6f} (relative {loss_err:.3e}), gradient norm {ng:.6f} vs "
            f"{nc:.6f} (relative {norm_err:.3e})")
        if not (math.isfinite(lg) and loss_err <= 1e-4
                and norm_err <= 1e-3):
            raise AssertionError("the block train step on the card "
                                 "disagrees with the CPU")

        # the CLIs on write_corpus's corpus, streaming on
        cli_root = os.path.join(root, "cli")
        os.makedirs(cli_root)
        cli_data = streaming_data_yml(cli_root, write_corpus(cli_root))
        common = ["--data_config", cli_data, "--model_config",
                  os.path.join(root_dir, "configs",
                               "Streaming_ConformerS.yml"),
                  "--device", "cuda"]
        wav_path = os.path.join(cli_root, "whole_chunks.wav")
        write_wav(wav_path, noise(16 * chunk, seed=22) * 3, SR)

        def clis():
            run_cli(train_asr.main, common + ["--total_steps", "3",
                                              "--data_workers", "2",
                                              "--compute_dtype", "float32"])
            scores, _, err = run_cli(eval_am.main,
                                     common + ["--max_batches", "2"])
            if "no checkpoint found" in err:
                raise AssertionError("cli.eval_am did not restore")
            _, out, err = run_cli(test_asr.main, common + [
                "--wav", wav_path, "--compute_dtype", "float32"])
            if "no checkpoint found" in err or "phones:" not in out:
                raise AssertionError(f"cli.test_asr: {out[-300:]}")
            return scores

        scores, n = counted(clis)
        launches = add(launches, expect(
            n, 3 + 2 + 2, "the block train_asr, eval_am and test_asr calls"))
        for key in ("phone_cer", "char_cer"):
            if not math.isfinite(scores[key]):
                raise AssertionError(f"eval_am: {key} = {scores[key]}")
        log(f"block_stream: cli.train_asr 3 f32 steps of B={CLI_B}; "
            f"cli.eval_am restored step 3 and scored 2 batches: "
            f"{json.dumps(scores)}; cli.test_asr restored it and decoded a "
            f"16-chunk wav")

        # OfflineASRSession, one batched encode a file, against the folded
        # encode
        trainer = block_trainer(cli_data, "cuda")
        if not trainer.restore():
            raise AssertionError("no block checkpoint to serve")
        model = trainer.state.model.eval()
        asr = ASREngine(model, sample_rate=SR, text_featurizer=CharVocab())
        session = OfflineASRSession(asr)
        files = [noise(int(s * SR), seed=30 + i)
                 for i, s in enumerate(BLOCK_FILE_SECONDS)]
        pieces = sum(1 for w in files for s in range(0, len(w), chunk)
                     if len(w[s:s + chunk]) >= MIN_PIECE_SAMPLES)
        tap = Tap(asr, "encode_pieces")

        def requests():
            for w in files:
                segments = session.transcribe_wav(w)
                if len(segments) != 1 or not isinstance(
                        segments[0]["text"], str):
                    raise AssertionError(f"bad segments {segments}")

        _, n = counted(requests)
        rows = tap.remove()                 # each file's pieces' rows
        encodes = len(files)
        launches = add(launches, expect(n, encodes,
                                        f"{encodes} block session encodes"))
        worst = 0.0
        for w, used in zip(files, rows):
            n_chunks = -(-len(w) // chunk)
            padded = np.zeros((1, n_chunks * chunk), np.float32)
            padded[0, :len(w)] = w
            with torch.no_grad():
                folded = model.encode(torch.from_numpy(padded).to(dev))[0]
            joined = torch.from_numpy(np.concatenate(used)).to(dev)
            worst = max(worst, within(joined, folded[:len(joined)], rtol=0,
                                      atol=1e-3))
        log(f"block_stream: OfflineASRSession on {BLOCK_FILE_SECONDS} s "
            f"files, {pieces} chunks in {encodes} batched encodes; its "
            f"encoder rows joined vs the folded encode of each padded file: "
            f"max|err| {worst:.3e}")
    log(f"block_stream: K1 and K1b launched {launches}")
    return launches


# ---------------------------------------------------------------------------
# CTC prefix beam search with the n-gram LM fused on the card
# ---------------------------------------------------------------------------

BEAM_B, BEAM_SECONDS = 128, 7.0
BEAM_W, BEAM_K, BEAM_LM_WEIGHT = 8, 16, 0.3
BEAM_CPU_ROWS = 8
# a best beam that differs between the card and the CPU is a near-tie only
# where its top two beams' scores are this share of the top score apart
BEAM_NEAR_TIE = 1e-4
# score_candidates against NGramLM.score: the device adds up to three f32
# values where numpy adds them in float64 and rounds once, so one f32 ulp
# (2^-23 of the value) is allowed beside the 1e-6
LM_SCORE_TOL = dict(rtol=2.0 ** -23, atol=1e-6)


def full_vocab_lm(n_seqs: int = 1500, seed: int = 0):
    """An order-3 phone LM over all 231 classes from a seeded corpus whose
    next token follows the last two by a rule 70 % of the time, so that the
    table holds seen trigrams and bigrams and the lookups back off."""
    from tensorflowasr_tpu_torch.utils.ngram_lm import train_ngram_lm

    rng = np.random.default_rng(seed)
    v = N_PHONE - 1
    seqs = []
    for _ in range(n_seqs):
        s = [int(x) for x in rng.integers(0, v, 2)]
        for _ in range(int(rng.integers(4, 30))):
            s.append((3 * s[-2] + s[-1] + 1) % v if rng.random() < 0.7
                     else int(rng.integers(0, v)))
        seqs.append(s)
    return train_ngram_lm(seqs, N_PHONE, order=3)


def check_lm_on_card(lm) -> str:
    """The card's hash lanes against ``_hash_tuple`` (tokens just below
    2^32, so that every multiply wraps) and ``score_candidates`` on the
    card against ``NGramLM.score`` for seeded contexts, BOS contexts among
    them, and candidates, seen continuations among them."""
    from tensorflowasr_tpu_torch.utils.ngram_lm import (
        _hash_torch,
        _hash_tuple,
        lm_pack,
        score_candidates,
    )

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    toks = rng.integers(2 ** 32 - 2 ** 12, 2 ** 32 - 1, size=(256, 3))
    toks[:64] = rng.integers(0, N_PHONE + 1, size=(64, 3))
    cols = [torch.from_numpy(toks[:, j]).to(dev) for j in range(3)]
    n_hashes = 0
    for kind in ("p", "b"):
        for n in (1, 2, 3):
            h1, h2 = (h.cpu().numpy() for h in _hash_torch(kind, n, cols[:n]))
            want = np.asarray([_hash_tuple(kind, [int(t) for t in row[:n]])
                               for row in toks])
            if not (np.array_equal(h1, want[:, 0])
                    and np.array_equal(h2, want[:, 1])):
                raise AssertionError(f"hash lanes of ({kind}, {n}) differ "
                                     f"from _hash_tuple on the card")
            n_hashes += len(toks)
    packed = lm_pack(lm, dev)
    v = N_PHONE - 1
    ctx = rng.integers(0, v, size=(512, 2))
    ctx[:64] = lm.bos                              # sentence start
    ctx[64:128, 0] = lm.bos                        # one token in
    cand = rng.integers(0, v, size=(512, BEAM_K))
    cand[:, 0] = (3 * ctx[:, 0] + ctx[:, 1] + 1) % v   # seen trigrams
    got = score_candidates(packed, torch.from_numpy(ctx).to(dev),
                           torch.from_numpy(cand).to(dev))
    golden = torch.tensor([[lm.score([t for t in c if t != lm.bos], int(k))
                            for k in row] for c, row in zip(ctx, cand)])
    err = within(got.cpu(), golden, **LM_SCORE_TOL)
    return (f"{n_hashes} hash lanes equal to _hash_tuple's (tokens up to "
            f"2^32 - 2); score_candidates on {cand.size} (context, "
            f"candidate) pairs, 2048 of them from BOS-padded contexts, within "
            f"{err:.3e} of NGramLM.score (table cap {len(lm.key1)}, "
            f"{lm.n_probe} probes, {len(lm.raw)} entries)")


def best_and_gap(beams) -> tuple:
    """(best prefixes as lists, the top two beams' score gap over the top
    score's magnitude, per row) of ``ctc_beam_search_decode``'s output."""
    prefixes, lens, scores = (x.cpu() for x in beams)
    best = [prefixes[b, 0, :int(lens[b, 0])].tolist()
            for b in range(len(lens))]
    gap = ((scores[:, 0] - scores[:, 1]) / scores[:, 0].abs()).tolist()
    return best, gap


def compare_best(card, cpu, what: str) -> tuple:
    """Best beams of the card against the CPU: equal, or a near-tie of the
    CPU's top two beams (reported with its gap); live scores within 1e-4
    relative where the prefixes agree. Returns (report, near-tied rows)."""
    from tensorflowasr_tpu_torch.ops.beam import NEG_INF

    (cb, _), (pb, pgap) = best_and_gap(card), best_and_gap(cpu)
    ties, worst = {}, 0.0
    for b, (x, y) in enumerate(zip(cb, pb)):
        if x != y:
            if pgap[b] > BEAM_NEAR_TIE:
                raise AssertionError(f"{what}: row {b} best beam differs at "
                                     f"a top-two gap of {pgap[b]:.3e}")
            ties[b] = pgap[b]
            continue
        cs, ps = card[2][b].cpu(), cpu[2][b].cpu()
        live = ps > NEG_INF / 2
        if not bool(((cs > NEG_INF / 2) == live).all()):
            raise AssertionError(f"{what}: row {b} live beams differ")
        rel = ((cs[live] - ps[live]).abs() / ps[live].abs()).max().item()
        if rel > 1e-4:
            raise AssertionError(f"{what}: row {b} scores {rel:.3e} apart")
        worst = max(worst, rel)
    listed = ", ".join(f"row {b} gap {g:.3e}" for b, g in ties.items())
    return (f"best beams equal in {len(cb) - len(ties)} of {len(cb)} rows "
            f"(near-ties: {listed or 'none'}; smallest top-two gap "
            f"{min(pgap):.3e}), live scores within {worst:.3e} relative",
            set(ties))


def served_beam_request(client, wav: np.ndarray, host_lm, blank: int):
    """One file over the served offline ops with the beam on the host, as
    ``ASREngine.decode`` does it: ``encode`` a chunk at a time, the rows
    padded to whole groups of 4 chunks, ``ctc_logits``, the beam with the
    LM on the CPU, the best beam padded with 10 zeros, ``translate``.
    Returns (phones, char ids, the beam's output, encodes)."""
    from tensorflowasr_tpu_torch.ops.beam import ctc_beam_search_decode
    from tensorflowasr_tpu_torch.utils.ngram_lm import lm_pack

    cs = int(client.call("info")[0][0])
    encs = [client.call("encode", wav[None, i:i + cs])[0]
            for i in range(0, len(wav), cs)]
    frames, enc = encs[0].shape[0], np.concatenate(encs)
    groups = -(-(-(-len(enc) // frames)) // 4) * 4
    buf = np.zeros((groups * frames, enc.shape[1]), np.float32)
    buf[:len(enc)] = enc
    logits = torch.tensor(client.call("ctc_logits", buf)[0])[None]
    beams = ctc_beam_search_decode(
        logits, torch.tensor([len(enc)]), blank_id=blank,
        beam_width=BEAM_W, prune_k=BEAM_K, ngram_lm=lm_pack(host_lm, "cpu"),
        lm_weight=BEAM_LM_WEIGHT)
    phones = beams[0][0, 0, :int(beams[1][0, 0])].tolist()
    padded = np.zeros((1, len(buf) + 10), np.int32)
    padded[0, :len(phones)] = phones
    chars = client.call("translate", padded, buf)[0].argmax(-1).tolist()
    return phones, chars, beams, len(encs)


def read_chars(ids, stop: int) -> list:
    out = []
    for v in ids:
        if v == 0 or v == stop:
            break
        out.append(CharVocab().iextract(int(v)))
    return out


def phase_beam_lm(cli_dir: str) -> tuple:
    """CTC prefix beam search with the n-gram LM fused on the card, on the
    cli phase's corpus and its calibrated ConformerCTC(S) checkpoint: (a) an
    order-3 phone LM by ``cli.train_lm`` on that corpus, and one over all
    231 phones from a seeded corpus; (b) the card's hash lanes and
    ``score_candidates`` against numpy; (c) ``make_beam_predict_step`` (W 8,
    K 16, the 231-phone LM at 0.3) at B = 128 x 7 s of gated tones beside
    the greedy ``predict_step``, one beam call with every implicit sync an
    error, and 8 rows against the same step on the CPU; (d) ``cli.eval_am
    --lm`` on the card and on the CPU, the same JSON; (e)
    ``cli.serve_model.build_ops --lm`` served on 127.0.0.1, an 8 s file
    decoded with the beam from the served ops against the in-process beam
    ``ASREngine`` on the CPU; (f) ``cli.train_asr --data_procs 2`` and
    ``0``, 3 steps each. K1b's launches are counted exactly in (c)-(f).
    Returns them."""
    import yaml

    from tensorflowasr_tpu_torch.cli import (
        eval_am,
        serve_model,
        train_asr,
        train_lm,
    )
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.ops.beam import ctc_beam_search_decode
    from tensorflowasr_tpu_torch.serve.engines import ASREngine
    from tensorflowasr_tpu_torch.serve.model_server import (
        ModelClient,
        ModelServer,
    )
    from tensorflowasr_tpu_torch.train.asr_trainer import (
        CTCTrainer,
        make_beam_predict_step,
    )
    from tensorflowasr_tpu_torch.utils.config import UserConfig
    from tensorflowasr_tpu_torch.utils.ngram_lm import NGramLM, lm_pack

    root = os.path.dirname(os.path.abspath(__file__))
    model_yml = os.path.join(root, "configs", "conformerS.yml")
    cli_data = os.path.join(cli_dir, "data.yml")
    dev = torch.device("cuda")
    launches = (0, 0)

    # (a) the LMs
    lm_npz = os.path.join(cli_dir, "lm_phone3.npz")
    _, out, _ = run_cli(train_lm.main, [
        "--data_config", cli_data, "--unit", "phone", "--order", "3",
        "--output", lm_npz, "--eval_lists",
        os.path.join(cli_dir, "eval.list")])
    cli_lm = NGramLM.load(lm_npz)
    if (cli_lm.order, cli_lm.vocab_size) != (3, N_PHONE):
        raise AssertionError(f"cli.train_lm: order {cli_lm.order}, "
                             f"vocabulary {cli_lm.vocab_size}")
    log("beam_lm: cli.train_lm: " + " / ".join(out.strip().splitlines()))
    full_lm = full_vocab_lm()

    # (b) the hash lanes and the scores on the card
    log(f"beam_lm: {check_lm_on_card(full_lm)}")

    # (c) make_beam_predict_step at full width on the calibrated checkpoint
    config = UserConfig(cli_data, model_yml)
    phone_f, char_f = build_featurizers(config)[:2]
    trainers = {}
    for where in ("cuda", "cpu"):
        t = CTCTrainer(config, phone_f.num_classes, char_f.num_classes,
                       blank_id=phone_f.blank, device=where)
        t.init_state()
        if not t.restore():
            raise AssertionError(f"no checkpoint under {t.outdir}")
        trainers[where] = t
    trainer = trainers["cuda"]
    model, state, blank = trainer.state.model.eval(), trainer.state, \
        phone_f.blank
    wav = torch.from_numpy(np.stack([tones(BEAM_SECONDS, seed=300 + i)
                                     for i in range(BEAM_B)])).to(dev)
    t_enc = int(BEAM_SECONDS * SR) // 640
    length = torch.full((BEAM_B,), t_enc, dtype=torch.int32, device=dev)
    dev_lm = lm_pack(full_lm, dev)
    beam_step = make_beam_predict_step(model, blank, beam_width=BEAM_W,
                                       ngram_lm=dev_lm,
                                       lm_weight=BEAM_LM_WEIGHT)
    for what, step in (("beam", beam_step), ("greedy", trainer.predict_step)):
        out, n = counted(lambda: step(state, wav, length))
        check_outputs(out, BEAM_B, t_enc)
        launches = add(launches, expect(n, 1, f"a {what} predict call"))
        if what == "beam":
            beam_out = out
    lens = beam_out[1].cpu()
    if int((lens > 0).sum()) < BEAM_B // 2:
        raise AssertionError(f"the beam decoded {int((lens > 0).sum())} of "
                             f"{BEAM_B} rows to something")
    log(f"beam_lm: make_beam_predict_step f32 B={BEAM_B} x {BEAM_SECONDS} s "
        f"({t_enc} frames, W {BEAM_W}, K {BEAM_K}, order-3 LM over "
        f"{N_PHONE} phones at {BEAM_LM_WEIGHT}) and the greedy "
        f"predict_step: shapes and ids in range, best beams "
        f"{float(lens.float().mean()):.1f} phones a row on average")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        checked = beam_step(state, wav, length)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for got, want in zip(checked, beam_out):
        if not torch.equal(got, want):
            raise AssertionError("the beam call under the sync check gave "
                                 "other ids")

    # the card against the CPU on the first rows
    rows = BEAM_CPU_ROWS
    cpu_model = trainers["cpu"].state.model.eval()
    cpu_lm = lm_pack(full_lm, "cpu")
    cpu_step = make_beam_predict_step(cpu_model, blank, beam_width=BEAM_W,
                                      ngram_lm=cpu_lm,
                                      lm_weight=BEAM_LM_WEIGHT)
    cpu_out = cpu_step(trainers["cpu"].state, wav[:rows].cpu(),
                       length[:rows].cpu())
    with torch.no_grad():
        card_logits = model.ctc_logits(model.encode(wav[:rows]))
        cpu_logits = cpu_model.ctc_logits(cpu_model.encode(wav[:rows].cpu()))
    beam_args = dict(blank_id=blank, beam_width=BEAM_W, prune_k=BEAM_K,
                     lm_weight=BEAM_LM_WEIGHT)
    card_beams = ctc_beam_search_decode(card_logits, length[:rows],
                                        ngram_lm=dev_lm, **beam_args)
    cpu_beams = ctc_beam_search_decode(cpu_logits, length[:rows].cpu(),
                                       ngram_lm=cpu_lm, **beam_args)
    report, tied = compare_best(card_beams, cpu_beams, "beam_lm card vs CPU")
    step_rows = [b for b in range(rows)
                 if beam_out[0][b, :int(lens[b])].tolist()
                 == cpu_out[0][b, :int(cpu_out[1][b])].tolist()]
    chars_equal = sum(torch.equal(beam_out[2][b].cpu(), cpu_out[2][b])
                      for b in range(rows))
    log(f"beam_lm: {rows} rows on the card vs the CPU (same checkpoint and "
        f"LM): {report}; make_beam_predict_step's phone ids equal in "
        f"{len(step_rows)} of {rows} rows (the card's at B={BEAM_B}), char "
        f"ids in {chars_equal}")
    if set(range(rows)) - set(step_rows) - tied:
        raise AssertionError("make_beam_predict_step differs from the CPU "
                             "away from a near-tie")
    del wav, out, beam_out, checked
    torch.cuda.empty_cache()

    # (d) cli.eval_am --lm on both devices
    common = ["--data_config", cli_data, "--model_config", model_yml,
              "--lm", lm_npz, "--max_batches", "2", "--log_level", "WARNING"]
    (card_json, _, err), n = counted(
        lambda: run_cli(eval_am.main, common + ["--device", "cuda"]))
    launches = add(launches, expect(n, 2, "eval_am --lm's 2 batches"))
    cpu_json, _, cpu_err = run_cli(eval_am.main, common + ["--device", "cpu"])
    if "no checkpoint found" in err + cpu_err:
        raise AssertionError("eval_am --lm did not restore the checkpoint")
    if card_json != cpu_json:
        raise AssertionError(f"eval_am --lm: card {card_json} vs CPU "
                             f"{cpu_json}")
    if card_json["phone_D"] >= card_json["phone_N"]:
        raise AssertionError(f"eval_am --lm decoded nothing: {card_json}")
    log(f"beam_lm: cli.eval_am --lm {os.path.basename(lm_npz)}, 2 batches: "
        f"the same JSON on the card and the CPU: {json.dumps(card_json)}")

    # (e) the beam over the socket against the in-process engine on the CPU
    args = serve_model.parser().parse_args([
        "--data_config", cli_data, "--model_config", model_yml, "--lm",
        lm_npz, "--port", "0", "--device", "cuda", "--compute_dtype",
        "float32", "--log_level", "WARNING"])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        ops, inline_ops, _ = serve_model.build_ops(args)
    if "checkpoint under" in err.getvalue():
        raise AssertionError(f"serve_model: {err.getvalue()[-400:]}")
    server = ModelServer(ops, tcp_port=0, inline_exec=False,
                         inline_ops=inline_ops)
    wav8 = tones(8.0, seed=77)
    served, failures = {}, []

    def client():
        cli = ModelClient(tcp_port=server.tcp_port)
        try:
            served["out"] = served_beam_request(cli, wav8, cli_lm, blank)
        except BaseException as e:            # raised on the main thread
            failures.append(e)
        finally:
            cli.close()
            server.stop()

    def serve():
        server.start()
        thread = threading.Thread(target=client, daemon=True)
        thread.start()
        server.run_worker_loop()
        thread.join(timeout=60)

    _, n = counted(serve)
    if failures:
        raise failures[0]
    phones, chars, beams, encodes = served["out"]
    launches = add(launches, expect(n, encodes,
                                    f"{encodes} served encodes"))
    engine = ASREngine(cpu_model, sample_rate=SR, text_featurizer=CharVocab(),
                       phone_featurizer=phone_f, beam_width=BEAM_W,
                       ngram_lm=lm_pack(cli_lm, "cpu"),
                       lm_weight=BEAM_LM_WEIGHT)
    encs = [engine.extract_feature(wav8[i:i + engine.chunk_samples])
            for i in range(0, len(wav8), engine.chunk_samples)]
    ids, ids_len, char_ids = engine._decode(encs, engine.pad_chunks)
    frames = sum(len(e) for e in encs)
    cap = -(-(-(-frames // engine.chunk_frames)) // 4) * 4 \
        * engine.chunk_frames
    buf = np.zeros((1, cap, encs[0].shape[1]), np.float32)
    buf[0, :frames] = np.concatenate(encs)
    with torch.no_grad():
        cpu_logits = cpu_model.ctc_logits(torch.from_numpy(buf))
    cpu_beams = ctc_beam_search_decode(
        cpu_logits, torch.tensor([frames]), ngram_lm=lm_pack(cli_lm, "cpu"),
        **beam_args)
    report, tied = compare_best(beams, cpu_beams,
                                "beam_lm served vs CPU engine")
    if ids[0, :int(ids_len[0])].tolist() != best_and_gap(cpu_beams)[0][0]:
        raise AssertionError("ASREngine's beam is not the beam of its "
                             "logits")
    text = engine.decode(encs)
    if not tied:
        if read_chars(chars, CharVocab().endid()) != text:
            raise AssertionError(f"served chars {chars[:20]} vs the "
                                 f"engine's {text[:20]}")
    if not phones:
        raise AssertionError("the served beam decoded no phone")
    log(f"beam_lm: cli.serve_model.build_ops --lm, an 8 s file over "
        f"127.0.0.1 ({encodes} encodes, the beam on the host), "
        f"{len(phones)} phones, {len(text)} chars, against the in-process "
        f"beam ASREngine on the CPU: {report}")
    del trainers, trainer, model, state, engine, ops
    torch.cuda.empty_cache()

    # (f) cli.train_asr with batches from worker processes
    with open(cli_data) as f:
        data = yaml.safe_load(f)
    for procs in (2, 0):
        d = dict(data, running_config=dict(
            data["running_config"], log_interval_steps=3,
            save_interval_steps=1000, eval_interval_steps=1000,
            outdir=os.path.join(cli_dir, f"procs{procs}")))
        d_yml = os.path.join(cli_dir, f"data_procs{procs}.yml")
        with open(d_yml, "w") as f:
            yaml.safe_dump(d, f)
        _, n = counted(lambda: run_cli(train_asr.main, [
            "--data_config", d_yml, "--model_config", model_yml,
            "--device", "cuda", "--total_steps", "3", "--data_procs",
            str(procs), "--data_workers", "2", "--log_level", "WARNING"]))
        launches = add(launches, expect(n, 3, f"3 train steps with "
                                               f"--data_procs {procs}"))
        with open(os.path.join(cli_dir, f"procs{procs}",
                               "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        if [m["step"] for m in logged] != [3] or \
                not math.isfinite(logged[0]["train_loss"]):
            raise AssertionError(f"--data_procs {procs}: {logged}")
    log("beam_lm: cli.train_asr bf16, 3 steps of B=8 with --data_procs 2 "
        "and 0: finite losses (the workers hide the card from themselves and "
        "check that CUDA stayed uninitialised after every batch)")
    log(f"beam_lm: K1 and K1b launched {launches}")
    return launches


# ---------------------------------------------------------------------------
# LEAF and add_wav_info, export through torch.export, rnnt_loss
# ---------------------------------------------------------------------------

OPTION_B, OPTION_SECONDS = 128, 7.0          # predict_step, as phase_serve
OPTION_TRAIN_B = 32                          # x TRAIN_SECONDS (8 s)
OPTION_TRAIN_STEPS = 3                       # a warm step and 2 more
EXPORT_CHUNKS = 10
EXPORT_DECODER_STEP = 4                      # the picker's frames a chunk
# a loaded program against the eager model it was exported from, on the
# same card: the same aten ops, which may pick other kernels
EXPORT_TOL = dict(rtol=1e-4, atol=1e-4)
RNNT_SHAPE = (8, 200, 40, 256)               # B, T, U, V


def option_trainer(option: dict, device: str, dropout: bool = True):
    """The full-width f32 ``CTCTrainer`` (seed 0) with ``option`` in its
    ``speech_config``; dropout 0 where ``dropout`` is off."""
    extra = {"speech_config": option}
    if not dropout:
        extra["model_config"] = {"dropout": 0.0, "ctcdecoder_dropout": 0.0,
                                 "translator_dropout": 0.0}
    return new_trainer("float32", device, extra=extra)


def option_card_vs_cpu(option: dict, what: str) -> None:
    """The encoder (eval) and one loss + backward (train, dropout 0) of the
    same seeded model on B = 2 x 1 s on the card and on the CPU: encoder
    within 1e-3, loss within 1e-4 relative, the gradient's global norm
    within 1e-3 relative."""
    from tensorflowasr_tpu_torch.train.asr_trainer import loss_and_metrics

    small = train_batch(2, 1.0, 8, 4)
    result = {}
    for device in ("cuda", "cpu"):
        t = option_trainer(option, device, dropout=False)
        m = t.state.model
        b = t._prepare_batch(small)
        with torch.no_grad():
            enc = m.eval().encode(b["wav"]).cpu()
        total, _ = loss_and_metrics(m.train(), b, t.blank_id)
        total.backward()
        norm = torch.linalg.vector_norm(torch.stack(
            [p.grad.double().norm() for p in m.parameters()]))
        result[device] = (enc, float(total.detach()), float(norm))
    enc_err = within(result["cuda"][0], result["cpu"][0], rtol=0, atol=1e-3)
    (_, lg, ng), (_, lc, nc) = result["cuda"], result["cpu"]
    loss_err, norm_err = abs(lg - lc) / abs(lc), abs(ng - nc) / nc
    log(f"leaf_wav_export: {what} f32 card vs CPU on B=2 x 1 s, dropout 0: "
        f"encoder max|err| {enc_err:.3e}; train_loss {lg:.6f} vs {lc:.6f} "
        f"(relative {loss_err:.3e}), gradient norm {ng:.6f} vs {nc:.6f} "
        f"(relative {norm_err:.3e})")
    if not (math.isfinite(lg) and loss_err <= 1e-4 and norm_err <= 1e-3):
        raise AssertionError(f"{what}: the train step on the card disagrees "
                             "with the CPU")


def option_part(option: dict, what: str) -> tuple:
    """(a) / (b): ``predict_step`` f32 at B = 128 x 7 s; 3 train steps at
    B = 32 x 8 s; the card against the CPU. Returns K1's and K1b's launches
    in the predict and train calls (one each a call with ``add_wav_info``,
    none with LEAF) and the number of calls."""
    from tensorflowasr_tpu_torch.serve.engines import predict_step

    dev = torch.device("cuda")
    trainer = option_trainer(option, "cuda")
    model, cfg = trainer.state.model.eval(), trainer.model_cfg
    if (cfg.dmodel, cfg.num_blocks) != (144, 13) or any(
            getattr(cfg, k) != v for k, v in option.items()):
        raise AssertionError(f"not the full-width {what} config: {cfg}")
    wav, length = batch_inputs(OPTION_B, OPTION_SECONDS, dev)
    out, n_pred = counted(lambda: predict_step(model, wav, length))
    check_outputs(out, OPTION_B, -(-(-(-wav.shape[1] // 160)) // 4))
    del wav, length, out

    numpy_batch = train_batch(OPTION_TRAIN_B, TRAIN_SECONDS, TRAIN_PHONES,
                              TRAIN_CHARS)
    batch = trainer._prepare_batch(numpy_batch)
    losses, n_train = counted(lambda: train_steps(
        trainer.train_step, trainer.state, batch, OPTION_TRAIN_STEPS - 1))
    log(f"leaf_wav_export: {what} predict_step f32 B={OPTION_B} x "
        f"{OPTION_SECONDS} s: shapes and ids in range; train_step f32 "
        f"B={OPTION_TRAIN_B} x {TRAIN_SECONDS} s, dropout {cfg.dropout}: "
        f"train_loss {' -> '.join(f'{v:.4f}' for v in losses)}")
    del trainer, model, batch
    torch.cuda.empty_cache()
    option_card_vs_cpu(option, what)
    return add(n_pred, n_train), 1 + OPTION_TRAIN_STEPS


def frontend_nodes(call) -> list:
    """The ``tasr::`` calls in a graph that ``load_exported`` loaded."""
    return [str(n.target) for n in call.program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("tasr.")]


def export_part(cli_dir: str, chunk_dir: str) -> tuple:
    """(c): the cli phase's calibrated ConformerCTC(S) checkpoint through
    ``export_offline_asr`` and the chunk train CLI's ChunkConformer(S)
    checkpoint through ``export_chunk_streaming``, on the card, loaded
    back in this process and run against the eager models. Returns K1's
    and K1b's launches in the loaded graphs, with the number of encoder and
    picker calls."""
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.export import exporter
    from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer
    from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    root = os.path.dirname(os.path.abspath(__file__))
    dev = torch.device("cuda")
    config = UserConfig(os.path.join(cli_dir, "data.yml"),
                        os.path.join(root, "configs", "conformerS.yml"))
    phone_f, char_f = build_featurizers(config)[:2]
    trainer = CTCTrainer(config, phone_f.num_classes, char_f.num_classes,
                         blank_id=phone_f.blank, device="cuda")
    ctrainer = ChunkTrainer(
        UserConfig(os.path.join(chunk_dir, "data.yml"),
                   os.path.join(root, "configs", "chunk_conformerS.yml")),
        phone_f.num_classes, char_f.num_classes, device="cuda")
    for t in (trainer, ctrainer):
        t.init_state()
        if not t.restore():
            raise AssertionError(f"no checkpoint under {t.outdir}")
    model, cmodel = trainer.state.model.eval(), ctrainer.state.model.eval()

    # offline: encoder, ctc_model, translator at JAX's example shapes
    out_dir = os.path.join(cli_dir, "export_offline")
    exporter.export_offline_asr(model, out_dir)          # B=1 x 7 s, U 64
    graphs = exporter.load_exported(out_dir)
    nodes = {name: frontend_nodes(call) for name, call in graphs.items()}
    if nodes != {"encoder": ["tasr.log_mel_spectrogram.default"],
                 "ctc_model": [], "translator": []}:
        raise AssertionError(f"tasr:: nodes in the offline graphs: {nodes}")
    wav = tones(7.0, seed=70)[None]
    enc, n_enc = counted(lambda: graphs["encoder"](wav))
    launches = expect(n_enc, 1, "the exported encoder's call")
    ids = np.random.default_rng(71).integers(
        0, phone_f.num_classes, (1, 64)).astype(np.int32)
    (logits, chars), n_heads = counted(lambda: (
        graphs["ctc_model"](enc), graphs["translator"](ids, enc)))
    if n_heads != (0, 0):
        raise AssertionError(f"the heads launched the frontend {n_heads}")
    with torch.no_grad():
        enc_live = model.encode(torch.from_numpy(wav).to(dev))
        live = (enc_live, model.ctc_logits(enc_live),
                model.translate(torch.from_numpy(ids).to(dev), enc_live))
    errs = [within(torch.from_numpy(got), want.cpu(), **EXPORT_TOL)
            for got, want in zip((enc, logits, chars), live)]
    log(f"leaf_wav_export: export_offline_asr of the calibrated "
        f"ConformerCTC(S) checkpoint on the card, loaded back; the encoder "
        f"graph holds "
        f"{nodes['encoder']}; loaded vs eager at B=1 x 7 s: max|err| "
        f"encoder {errs[0]:.3e}, ctc_model {errs[1]:.3e}, translator "
        f"{errs[2]:.3e}; K1 and K1b launched {n_enc} by one encoder call")

    # chunk: picker and decoder threaded over EXPORT_CHUNKS chunks
    out_dir = os.path.join(chunk_dir, "export_chunk")
    exporter.export_chunk_streaming(cmodel, out_dir,
                                    decoder_step=EXPORT_DECODER_STEP)
    graphs = exporter.load_exported(out_dir)
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    nodes = {name: frontend_nodes(call) for name, call in graphs.items()}
    if nodes != {"picker": ["tasr.log_mel_spectrogram.default"],
                 "decoder": []}:
        raise AssertionError(f"tasr:: nodes in the chunk graphs: {nodes}")
    cs = cmodel.cfg.chunk_samples
    stream = tones(EXPORT_CHUNKS * cs / SR, seed=72)[None]
    pk_keys, dec_keys = (manifest["picker_cache_keys"],
                         manifest["decoder_cache_keys"])
    flat = [v.cpu().numpy() for v in map(cmodel.init_picker_caches(1).get,
                                         pk_keys)]

    def thread(flat):
        """Each call's new caches feed the next."""
        outs = []
        for i in range(EXPORT_CHUNKS):
            outs.append(graphs["picker"](stream[:, i * cs:(i + 1) * cs],
                                         *flat))
            flat = outs[-1][3:]
        return outs

    outs, n_pick = counted(lambda: thread(flat))
    expect(n_pick, EXPORT_CHUNKS, f"{EXPORT_CHUNKS} exported picker calls")
    launches = add(launches, n_pick)
    caches, worst, picked = cmodel.init_picker_caches(1), 0.0, []
    with torch.no_grad():
        for i, out in enumerate(outs):
            chunk = torch.from_numpy(stream[:, i * cs:(i + 1) * cs]).to(dev)
            lg, hid, nf, caches = cmodel.picker_stream_step(chunk, caches)
            if not np.array_equal(out[2], nf.cpu().numpy()):
                raise AssertionError(f"chunk {i}: n_final {out[2]} vs "
                                     f"{nf.cpu().numpy()}")
            for got, want in [(out[0], lg), (out[1], hid)] + [
                    (g, caches[k]) for k, g in zip(pk_keys, out[3:])]:
                if got.shape != tuple(want.shape):
                    raise AssertionError(f"chunk {i}: shape {got.shape} vs "
                                         f"{tuple(want.shape)}")
                if want.numel():          # a ring of lookahead 0 is empty
                    worst = max(worst, within(
                        torch.from_numpy(got).float(), want.cpu().float(),
                        **EXPORT_TOL))
            picked.append(hid[:, -EXPORT_DECODER_STEP:].cpu().numpy())
    dflat = [v.cpu().numpy() for v in map(cmodel.init_decoder_caches(1).get,
                                          dec_keys)]
    dcaches, dworst = cmodel.init_decoder_caches(1), 0.0
    for x in picked:
        out = graphs["decoder"](x, *dflat)
        dflat = out[3:]
        with torch.no_grad():
            want = cmodel.decoder_stream_step(torch.from_numpy(x).to(dev),
                                              dcaches)
        dcaches = want[3]
        for got, w in zip(out[:3], want[:3]):
            dworst = max(dworst, within(torch.from_numpy(got).float(),
                                        w.cpu().float(), **EXPORT_TOL))
    log(f"leaf_wav_export: export_chunk_streaming of the chunk train CLI's "
        f"ChunkConformer(S) checkpoint on the card, loaded back; the picker "
        f"graph holds "
        f"{nodes['picker']}; {EXPORT_CHUNKS} chunks threaded through the "
        f"loaded picker ({len(pk_keys)} caches) and decoder ({len(dec_keys)}"
        f" caches) vs eager: max|err| picker {worst:.3e} (logits, hidden, "
        f"caches; n_final equal), decoder {dworst:.3e}; K1 and K1b launched "
        f"{n_pick} by {EXPORT_CHUNKS} picker calls")
    return launches, 1 + EXPORT_CHUNKS


def rnnt_part() -> None:
    """(d): ``rnnt_loss`` and its gradient on the card against the CPU."""
    from tensorflowasr_tpu_torch.ops.rnnt import rnnt_loss

    b, t, u, v = RNNT_SHAPE
    rng = np.random.default_rng(80)
    logits = rng.standard_normal((b, t, u + 1, v)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(1, v, (b, u)).astype(np.int64))
    t_lens = torch.tensor([200, 180, 150, 200, 120, 199, 60, 1])
    u_lens = torch.tensor([40, 35, 20, 40, 30, 39, 10, 0])
    result = {}
    for device in ("cuda", "cpu"):
        x = torch.from_numpy(logits).to(device).requires_grad_()
        loss = rnnt_loss(x, labels.to(device), t_lens.to(device),
                         u_lens.to(device))
        loss.sum().backward()
        result[device] = (loss.detach().cpu(), x.grad.cpu())
    loss_err = within(result["cuda"][0], result["cpu"][0], rtol=1e-4,
                      atol=0)
    scale = float(result["cpu"][1].abs().max())
    grad_err = within(result["cuda"][1], result["cpu"][1], rtol=0,
                      atol=1e-4 * scale)
    log(f"leaf_wav_export: rnnt_loss [B, T, U+1, V] = [{b}, {t}, {u + 1}, "
        f"{v}] card vs CPU: loss max|err| {loss_err:.3e} (losses "
        f"{float(result['cpu'][0].min()):.2f}-"
        f"{float(result['cpu'][0].max()):.2f}, within 1e-4 relative), "
        f"gradient max|err| {grad_err:.3e} (within 1e-4 of its largest "
        f"entry {scale:.3e})")


def phase_leaf_wav_export(cli_dir: str, chunk_dir: str) -> tuple:
    """(a) ``add_wav_info: true`` and (b) ``mel_layer_type: leaf`` on the
    full-width ConformerCTC(S); (c) the offline and chunk export round trip
    on the card; (d) ``rnnt_loss``. K1 and K1b are counted exactly: once a
    predict, train and exported encoder or picker call with add_wav_info
    and in the exported graphs, never on the LEAF branch. Returns the
    launches of (a) and (c)."""
    n, calls = option_part({"add_wav_info": True}, "add_wav_info")
    launches = expect(n, calls, f"{calls} add_wav_info predict and train "
                                f"calls")
    n, leaf_calls = option_part({"mel_layer_type": "leaf"}, "leaf")
    if n != (0, 0):
        raise AssertionError(f"the LEAF branch launched K1 and K1b {n}")
    exported, calls = export_part(cli_dir, chunk_dir)
    expect(exported, calls, "the exported graphs' encoder and picker calls")
    rnnt_part()
    log(f"leaf_wav_export: K1 and K1b launched {add(launches, exported)} "
        f"({launches} with add_wav_info, {exported} in the loaded graphs, "
        f"(0, 0) in the LEAF branch's {leaf_calls} predict and train "
        f"calls)")
    return add(launches, exported)


# ---------------------------------------------------------------------------
# Data and tensor parallelism: parallel/ with two ranks on the one card
# ---------------------------------------------------------------------------

PARALLEL_B, PARALLEL_STEPS = 32, 3           # am_data.yml's batch_size, x 8 s
# Adam at epsilon 1, as the CPU gate runs it (tests/test_torch_parallel.py):
# at 1e-6 a gradient that is rounding noise steps +-lr, in either run
PARALLEL_ADAM = {"lr": 1e-3, "epsilon": 1.0}
# each step's loss, relative; the gradients' global norm as the optimizer
# computes it after its all-reduce, relative; the BatchNorm statistics, of
# each leaf's largest entry
PARALLEL_LOSS_REL, PARALLEL_NORM_REL, PARALLEL_STAT_REL = 1e-4, 1e-3, 1e-4
# every parameter after the first step and after the third, of its leaf's
# largest entry: fixed bounds over the readings of two ranks against one
# process in the runs PERF.md records (NVIDIA H100 80GB HBM3 at 700.00 W):
# the card's rounding of a long gradient sum (a subsampling conv's, a
# depthwise kernel's) sets them, and grows with each Adam step at epsilon
# 1. After step 1: ConformerCTC(S) 2.403e-5 -
# 3.0e-5, ChunkConformer(S) 1.050e-4 - 1.110e-4 (its first block's
# depthwise kernel). After step 3: ConformerCTC(S) 2.270e-4 - 2.402e-4,
# ChunkConformer(S) 2.195e-4 - 3.073e-4. BatchNorm moments over each rank's
# own rows (the planted fault) read 3.433e-2 after step 1.
PARALLEL_PARAM_REL = {"ctc": (1e-4, 5e-4), "chunk": (2.5e-4, 5e-4)}
TP_LR = 1e-2                                 # tests/test_tp.py's SGD
# the (1 x 2) tensor-parallel SGD step's parameters, of each leaf's largest
# entry: a fixed bound over the readings 1.499e-4 and 1.506e-4 (PERF.md, the
# same card); tests/test_tp.py's lr x 1e-2 absolute is printed beside it
# (7.501e-5 and 7.540e-5)
TP_PARAM_REL = 5e-4


def perturb_biases(model, seed: int) -> None:
    """Every bias moved off its zero start by 0.02 x N(0, 1): a leaf that
    starts at 0 would be held, after the steps, to 1e-4 of a few
    lr-sized moves, finer than the rounding of its gradient's long sum
    (``tests/test_torch_train.py`` draws its biases so for the same
    reason)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.add_((torch.randn(p.shape, generator=g) * 0.02).to(
                    p.device))


def parallel_spec(work: str, name: str, kind: str, model, numpy_batch,
                  steps: int, **kw) -> dict:
    """A ``parallel/step_check.py`` spec: the shipped configs of ``kind``
    at dropout 0 and f32, ``model``'s weights, ``steps`` steps on
    ``numpy_batch``, ranks pinned to cuda:0 over gloo."""
    root = os.path.dirname(os.path.abspath(__file__))
    model_yml = {"ctc": "conformerS.yml",
                 "chunk": "chunk_conformerS.yml"}[kind]
    extra = {"optimizer_config": dict(PARALLEL_ADAM)}
    if kind == "ctc":
        extra["model_config"] = {"dropout": 0.0, "ctcdecoder_dropout": 0.0,
                                 "translator_dropout": 0.0}
    d = os.path.join(work, name)
    os.makedirs(d)
    torch.save(model.state_dict(), os.path.join(d, "weights.pt"))
    np.savez(os.path.join(d, "batches.npz"),
             **{f"{i}/{k}": v for i in range(steps)
                for k, v in numpy_batch.items()})
    return {"kind": kind,
            "config_files": [os.path.join(root, "configs", "am_data.yml"),
                             os.path.join(root, "configs", model_yml)],
            "extra": extra, "n_phone": N_PHONE, "n_char": N_CHAR,
            "weights": os.path.join(d, "weights.pt"),
            "batches": os.path.join(d, "batches.npz"), "steps": steps,
            "device": "cuda:0", "backend": "gloo", "threads": 2, **kw}


def leaves(result: dict, key: str = "params") -> dict:
    return {k: v["value"] for k, v in result[key].items()}


def worst_leaf(got: dict, want: dict) -> tuple:
    """(the largest max |got - want| of a leaf over that leaf's largest
    entry in ``want``, the leaf)."""
    return max((float((v - want[k]).abs().max())
                / max(float(want[k].abs().max()), 1e-30), k)
               for k, v in got.items())


def parity(ranks: list, one: dict, first: bool) -> dict:
    """The ranks against the one-process run: the largest relative error of
    each step's loss and gradient norm over the steps the ranks took, and
    the worst leaf of the parameters and of the buffers (the BatchNorm
    statistics), after the first step (``first``) or after the last;
    ``differ`` names the leaves that are not identical across ranks."""
    worst = {"loss": 0.0, "norm": 0.0, "differ": []}
    for i in range(len(ranks[0]["metrics"])):
        want = one["metrics"][i]["train_loss"]
        norm = one["grad_norms"][i]
        for r in ranks:
            worst["loss"] = max(worst["loss"], abs(
                r["metrics"][i]["train_loss"] - want) / abs(want))
            worst["norm"] = max(worst["norm"],
                                abs(r["grad_norms"][i] - norm) / norm)
    # a run of one step keeps its leaves after that step at the top level
    ranks = [r["first"] or r for r in ranks] if first else ranks
    for key in ("params", "buffers"):
        got = leaves(ranks[0], key)
        for r in ranks[1:]:
            worst["differ"] += [k for k, v in leaves(r, key).items()
                                if not torch.equal(v, got[k])]
        worst[key] = worst_leaf(got, leaves(
            one["first"] if first else one, key))
    return worst


def hold_ranks(what: str, kind: str, ranks: list, one: dict) -> list:
    """Two ranks against one process: every step's loss within 1e-4
    relative and gradient norm within 1e-3, the parameters and BatchNorm
    statistics identical across ranks, after the first step and after the
    last the statistics within 1e-4 of each leaf's largest entry and the
    parameters within PARALLEL_PARAM_REL[kind]. Logs the readings; returns
    what failed."""
    first, last = parity(ranks, one, True), parity(ranks, one, False)
    bound_first, bound_last = PARALLEL_PARAM_REL[kind]
    failed = [f"{k} {last[k]:.3e}" for k, bound in (
        ("loss", PARALLEL_LOSS_REL), ("norm", PARALLEL_NORM_REL))
        if last[k] > bound]
    failed += [f"{stage} {key} {w[key][0]:.3e} ({w[key][1]})"
               for stage, w, key, bound in (
                   ("step 1", first, "params", bound_first),
                   ("step 1", first, "buffers", PARALLEL_STAT_REL),
                   (f"step {PARALLEL_STEPS}", last, "params", bound_last),
                   (f"step {PARALLEL_STEPS}", last, "buffers",
                    PARALLEL_STAT_REL))
               if w[key][0] > bound]
    differ = first["differ"] + last["differ"]
    failed += [f"{k} differs between ranks" for k in differ]
    grad = one["grad_max"]

    def leaf(w, key):
        name = w[key][1]
        g = f", its largest gradient {grad[name]:.3e}" if name in grad \
            else ""
        return f"{w[key][0]:.3e} ({name}{g})"

    log(f"parallel: {what}: 2 ranks against one process over "
        f"{len(one['metrics'])} steps: loss {last['loss']:.3e}, gradient "
        f"norm {last['norm']:.3e} (relative, bounds {PARALLEL_LOSS_REL:g} "
        f"and {PARALLEL_NORM_REL:g}); the worst leaf, of its largest entry, "
        f"after step 1: parameters {leaf(first, 'params')} (bound "
        f"{bound_first:g}), BatchNorm statistics {leaf(first, 'buffers')} "
        f"(bound {PARALLEL_STAT_REL:g}); after step {PARALLEL_STEPS}: "
        f"parameters {leaf(last, 'params')} (bound {bound_last:g}), "
        f"statistics {leaf(last, 'buffers')}; "
        f"ranks {'differ' if differ else 'identical'}"
        + (f"; FAILED: {failed}" if failed else ""))
    return [f"{what}: {f}" for f in failed]


def hold_fault(what: str, kind: str, ranks: list, one: dict) -> list:
    """A planted fault's one step against the one-process first step: logs
    what each bound of :func:`hold_ranks` sees; returns a failure when no
    bound sees it."""
    w = parity(ranks, one, True)
    seen = {"loss": w["loss"] > PARALLEL_LOSS_REL,
            "gradient norm": w["norm"] > PARALLEL_NORM_REL,
            "parameters": w["params"][0] > PARALLEL_PARAM_REL[kind][0],
            "BatchNorm statistics": w["buffers"][0] > PARALLEL_STAT_REL}
    log(f"parallel: planted fault, {what}: one step of 2 ranks against one "
        f"process: loss {w['loss']:.3e}, gradient norm {w['norm']:.3e} "
        f"(relative), parameters {w['params'][0]:.3e} ({w['params'][1]}), "
        f"BatchNorm statistics {w['buffers'][0]:.3e} ({w['buffers'][1]}) of "
        f"the leaf's largest entry; over the bounds: "
        f"{[k for k, v in seen.items() if v] or 'NONE'}")
    return [] if any(seen.values()) else [
        f"the planted fault ({what}) passes every bound"]


def half_t_refs(trainer, numpy_batch) -> tuple:
    """(global t_ref, each half's own) from the picks of one training-mode
    forward on the whole batch, no statistics moved: what each of two ranks
    would take alone."""
    from tensorflowasr_tpu_torch.models.layers import BatchNorm

    batch = trainer._prepare_batch(numpy_batch)
    model = trainer.state.model.train()
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.track_stats = False
    try:
        with torch.no_grad():
            fwd = model.train_forward(
                batch["wav"], batch["extra_phones"], None,
                label_width=int(numpy_batch["phone_length"].max()))
    finally:
        for m in norms:
            m.track_stats = True
    counts = fwd["picked_counts"].cpu().numpy()
    t = fwd["phone_logits"].shape[1]
    half = len(counts) // 2
    lw = numpy_batch["phone_length"]
    return int(fwd["t_ref"]), tuple(
        int(np.clip(max(counts[s].max(), lw[s].max()), 1, t))
        for s in (slice(0, half), slice(half, None)))


def rank_launches(results: list) -> tuple:
    out = (0, 0)
    for r in results:
        out = add(out, tuple(r["launches"]))
    return out


def phase_parallel(work: str) -> tuple:
    """(a) data parallel: two gloo ranks pinned to the one card train the
    full-width ConformerCTC(S), then ChunkConformer(S) (calibrated picker),
    at a global B=32 x 8 s for 3 steps, held to one process on the same 32
    rows from the same weights; (b) a (1 x 2) tensor-parallel SGD step of
    ConformerCTC(S) against one process; (c) ``cli.train_asr`` under
    ``torchrun --nproc_per_node 2`` (gloo, cuda:0) on phase 8's kind of
    corpus, then a one-process ``eval_am`` restoring its checkpoint; (d) one
    process at world size 1 on the default backend (NCCL) taking a step.
    Returns K1's and K1b's launches: the ranks' (each counts its own and
    sends them back), the one-process runs' and eval_am's."""
    from tensorflowasr_tpu_torch.cli import eval_am
    from tensorflowasr_tpu_torch.parallel import step_check
    from tensorflowasr_tpu_torch.testing import (
        CALIBRATION_ROWS,
        bench_wav,
        calibrate,
        shipped_config,
    )
    from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer

    launches = (0, 0)
    numpy_batch = train_batch(PARALLEL_B, TRAIN_SECONDS, TRAIN_PHONES,
                              TRAIN_CHARS)
    trainer = new_trainer("float32", "cuda")
    perturb_biases(trainer.state.model, 1)
    spec = parallel_spec(work, "ctc", "ctc", trainer.state.model,
                         numpy_batch, PARALLEL_STEPS)
    del trainer
    one = step_check.run(spec)

    # new_chunk_trainer's model, its biases perturbed before the picker's
    # calibration
    chunk = ChunkTrainer(shipped_config("chunk_conformerS.yml"), N_PHONE,
                         N_CHAR, device="cuda", compute_dtype="float32")
    chunk.init_state(seed=0)
    perturb_biases(chunk.state.model, 2)
    calibrate(chunk.state.model, training=True,
              wav=bench_wav(CALIBRATION_ROWS, TRAIN_SECONDS))
    chunk_batch = chunk_train_batch(PARALLEL_B)
    t_ref, halves = half_t_refs(chunk, chunk_batch)
    cspec = parallel_spec(work, "chunk", "chunk", chunk.state.model,
                          chunk_batch, PARALLEL_STEPS)
    del chunk
    torch.cuda.empty_cache()
    cone = step_check.run(cspec)

    # (b) tensor parallel, 4 heads over a model axis of 2
    trainer = new_trainer("float32", "cuda")
    perturb_biases(trainer.state.model, 3)
    tp_batch = train_batch(8, TRAIN_SECONDS, TRAIN_PHONES, TRAIN_CHARS)
    tspec = parallel_spec(work, "tp", "ctc", trainer.state.model, tp_batch,
                          1, sgd=TP_LR)
    del trainer
    tone = step_check.run(tspec)

    # the three, and a planted fault (BatchNorm moments over each rank's
    # rows), in one launch of two ranks (one start-up)
    both = step_check.launch(
        dict(spec, jobs=[spec, cspec, dict(tspec, tp=[1, 2]),
                         dict(spec, steps=1, local_batchnorm=True)]), 2,
        os.path.join(work, "ranks"), timeout=300)
    ranks, cranks, tranks, franks = ([r["jobs"][i] for r in both]
                                     for i in range(4))
    failed = hold_ranks("ConformerCTC(S) f32", "ctc", ranks, one)
    n = expect(rank_launches(ranks), 2 * PARALLEL_STEPS,
               "the ranks' ConformerCTC(S) steps")
    launches = add(launches, add(n, tuple(one["launches"])))
    failed += hold_fault("BatchNorm moments over each rank's own rows",
                         "ctc", franks, one)
    launches = add(launches, expect(rank_launches(franks), 2,
                                    "the planted fault's step"))

    failed += hold_ranks(f"ChunkConformer(S) f32 (t_ref {t_ref}; each half "
                         f"alone {halves[0]} and {halves[1]})", "chunk",
                         cranks, cone)
    n = expect(rank_launches(cranks), 2 * PARALLEL_STEPS,
               "the ranks' ChunkConformer(S) steps")
    launches = add(launches, add(n, tuple(cone["launches"])))

    full = step_check.assemble(tranks)
    tp_loss = max(abs(r["metrics"][0]["train_loss"]
                      - tone["metrics"][0]["train_loss"])
                  / abs(tone["metrics"][0]["train_loss"]) for r in tranks)
    tp_param = worst_leaf(full, leaves(tone))
    tp_abs = max(float((full[k] - v).abs().max())
                 for k, v in leaves(tone).items())
    sharded = sum(1 for v in tranks[0]["params"].values()
                  if v["dim"] is not None)
    log(f"parallel: (1 x 2) tensor parallel ConformerCTC(S), SGD lr {TP_LR} "
        f"at B=8 x {TRAIN_SECONDS} s: {sharded} of "
        f"{len(tranks[0]['params'])} parameters sharded; against one "
        f"process: loss {tp_loss:.3e} relative (bound "
        f"{PARALLEL_LOSS_REL:g}), the worst parameter {tp_param[0]:.3e} of "
        f"its largest entry ({tp_param[1]}; bound {TP_PARAM_REL:g}), "
        f"{tp_abs:.3e} absolute (tests/test_tp.py's lr x 1e-2: "
        f"{TP_LR * 1e-2:g})")
    if not (tp_loss <= PARALLEL_LOSS_REL and tp_param[0] <= TP_PARAM_REL
            and sharded > 0):
        failed.append("the tensor-parallel step differs from the "
                      "one-process step")
    n = expect(rank_launches(tranks), 2, "the tensor-parallel ranks' step")
    launches = add(launches, add(n, tuple(tone["launches"])))
    if failed:
        raise AssertionError(f"parallel: {failed}")

    # (d) one process, world size 1, the default backend for a card
    nspec = dict(spec, backend=None, init_world_one=True, steps=1)
    (nccl,) = step_check.launch(nspec, 1, os.path.join(work, "ctc", "nccl"),
                                timeout=300)
    nccl_err = abs(nccl["metrics"][0]["train_loss"]
                   - one["metrics"][0]["train_loss"]) / abs(
        one["metrics"][0]["train_loss"])
    log(f"parallel: world size 1 on NCCL (the default on a card), one step "
        f"of ConformerCTC(S) at B={PARALLEL_B}: loss {nccl_err:.3e} relative "
        f"to the one-process step without a process group")
    if nccl_err > 1e-5:
        raise AssertionError("the NCCL world-1 step differs")
    launches = add(launches, expect(tuple(nccl["launches"]), 1,
                                    "the NCCL step"))

    # (c) train_asr under torchrun, eval_am restoring in one process
    cli_dir = os.path.join(work, "cli")
    os.makedirs(cli_dir)
    data_yml = write_corpus(cli_dir)
    root = os.path.dirname(os.path.abspath(__file__))
    model_yml = os.path.join(root, "configs", "conformerS.yml")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "tensorflowasr_tpu_torch.cli.train_asr", "--data_config", data_yml,
         "--model_config", model_yml, "--device", "cuda:0",
         "--dist_backend", "gloo", "--total_steps", "6", "--data_workers",
         "2"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=root), cwd=cli_dir)
    if run.returncode != 0:
        raise AssertionError(f"torchrun train_asr: rc {run.returncode}, "
                             f"stderr {run.stderr[-2000:]}")
    ckpts = sorted(os.listdir(os.path.join(cli_dir, "logs", "checkpoints")))
    with open(os.path.join(cli_dir, "logs", "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    if ckpts != ["ckpt_000000003.pt", "ckpt_000000006.pt"]:
        raise AssertionError(f"torchrun train_asr checkpoints {ckpts}")
    if [m["step"] for m in logged] != [2, 4, 6] or not all(
            math.isfinite(m["train_loss"]) for m in logged):
        raise AssertionError(f"torchrun train_asr metrics.jsonl {logged} "
                             f"(rank 0 alone writes it)")

    def evaluate():
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = eval_am.main(["--data_config", data_yml, "--model_config",
                               model_yml, "--device", "cuda",
                               "--max_batches", "2"])
        return rc, out.getvalue(), err.getvalue()

    (rc, out, err), n = counted(evaluate)
    if rc != 0 or "no checkpoint found" in err:
        raise AssertionError(f"cli.eval_am after torchrun: rc {rc}, stderr "
                             f"{err[-400:]}")
    result = json.loads(out.strip().splitlines()[-1])
    if not all(math.isfinite(result[k]) for k in ("phone_cer", "char_cer")):
        raise AssertionError(f"eval_am after torchrun: {result}")
    launches = add(launches, expect(n, 2, "eval_am's 2 batches"))
    log(f"parallel: torchrun --nproc_per_node 2 cli.train_asr (gloo, both "
        f"ranks on cuda:0, bf16, global B={CLI_B}) 6 steps (train_loss "
        f"{logged[0]['train_loss']:.3f} -> {logged[-1]['train_loss']:.3f}), "
        f"checkpoints {ckpts}; one-process eval_am restored step 6: "
        f"{json.dumps(result)}")
    log(f"parallel: K1 and K1b launched {launches} (ranks' and one-process "
        f"train steps, eval_am)")
    return launches


# ---------------------------------------------------------------------------
# The head-to-head quick run: learning quality over 2000 steps
# ---------------------------------------------------------------------------

# JAX's offline model after the quick setting's 2000 steps on the seed-21
# corpus (examples/headtohead/RESULTS.json, key quick_note)
JAX_QUICK_PHONE_CER, JAX_QUICK_CHAR_CER = 0.0382, 0.570
# fixed from JAX's reading, never from the card's: 2x its phone CER and
# 1.5x its char CER
QUICK_PHONE_CER_MAX = 2 * JAX_QUICK_PHONE_CER
QUICK_CHAR_CER_MAX = 1.5 * JAX_QUICK_CHAR_CER


def untrained_config(data_yml: str, model_yml: str, root: str) -> str:
    """A copy of ``data_yml`` in ``root`` whose outdir (``root``/logs)
    holds a freshly initialised checkpoint (step 0) of the same model
    config; returns its path."""
    import argparse

    import yaml

    from tensorflowasr_tpu_torch.cli.common import offline_ctc_setup
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    with open(data_yml) as f:
        data = yaml.safe_load(f)
    data["running_config"]["outdir"] = os.path.join(root, "logs")
    os.makedirs(root)
    path = os.path.join(root, "untrained_data.yml")
    with open(path, "w") as f:
        yaml.safe_dump(data, f, allow_unicode=True)
    _, trainer, _ = offline_ctc_setup(argparse.Namespace(device="cuda"),
                                      UserConfig(path, model_yml),
                                      "float32")
    trainer.save()
    return path


def phase_headtohead_quick(work: str) -> tuple:
    """``recipes/headtohead.py::quick`` in this process on the card: the
    seed-21 corpus and its preparation, 2000 steps of the offline model at
    B=16 with the noise and masking augmenters through ``cli.train_asr``,
    then ``cli.eval_am`` on the test list restoring the last checkpoint;
    phone and char CER held to bounds fixed from JAX's reading, which must
    also reject a freshly initialised checkpoint of the same config.
    Returns K1's and K1b's launches in the training and both evaluations."""
    from tensorflowasr_tpu_torch.recipes import headtohead

    def run():
        quick = headtohead.quick(work, "cuda")
        cold = headtohead.evaluate(
            untrained_config(quick["data_yml"], quick["model_yml"],
                             os.path.join(work, "untrained")),
            quick["model_yml"], "cuda")
        return quick, cold

    (quick, cold), launches = counted(run)
    result = quick["result"]
    steps = int(headtohead.QUICK_RUN[headtohead.QUICK_RUN.index(
        "--total_steps") + 1])
    batch = int(headtohead.QUICK_RUN[headtohead.QUICK_RUN.index(
        "--batch") + 1])
    logs = os.path.join(work, "ours", "logs")
    ckpts = sorted(os.listdir(os.path.join(logs, "checkpoints")))
    if ckpts != [f"ckpt_{s:09d}.pt" for s in range(500, steps + 1, 500)]:
        raise AssertionError(f"headtohead_quick: checkpoints {ckpts}")
    with open(os.path.join(logs, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    if [m["step"] for m in logged] != list(range(100, steps + 1, 100)) \
            or not all(math.isfinite(m["train_loss"]) for m in logged) \
            or not logged[-1]["train_loss"] < logged[0]["train_loss"]:
        raise AssertionError(f"headtohead_quick: metrics.jsonl {logged}")
    model = torch.load(os.path.join(logs, "checkpoints", ckpts[-1]),
                       weights_only=True)["model"]
    devices = sorted({str(t.device) for t in model.values()})
    if [d.split(":")[0] for d in devices] != ["cuda"]:
        raise AssertionError(f"headtohead_quick: trained parameters on "
                             f"{devices}")
    with open(os.path.join(work, "work", "test.list"),
              encoding="utf-8") as f:
        n_test = sum(1 for line in f if line.strip())
    # a train step and an eval batch each launch K1b once
    expect(launches, steps + 2 * -(-n_test // batch),
           "the quick run's train steps and both evaluations")
    log(f"headtohead_quick: train_asr {steps} steps at B={batch}, "
        f"train_loss {logged[0]['train_loss']:.3f} -> "
        f"{logged[-1]['train_loss']:.3f}, parameters on {devices}")
    log(f"headtohead_quick: phone CER {result['phone_cer']:.4f} (JAX "
        f"{JAX_QUICK_PHONE_CER}, bound {QUICK_PHONE_CER_MAX:.4f}), char CER "
        f"{result['char_cer']:.4f} (JAX {JAX_QUICK_CHAR_CER}, bound "
        f"{QUICK_CHAR_CER_MAX:.4f}): {json.dumps(result)}")
    log(f"headtohead_quick: untrained checkpoint phone CER "
        f"{cold['phone_cer']:.4f}, char CER {cold['char_cer']:.4f}: "
        f"{json.dumps(cold)}")
    if not (result["phone_cer"] <= QUICK_PHONE_CER_MAX
            and result["char_cer"] <= QUICK_CHAR_CER_MAX):
        raise AssertionError("headtohead_quick: the trained model misses "
                             "the bounds")
    if cold["phone_cer"] <= QUICK_PHONE_CER_MAX \
            or cold["char_cer"] <= QUICK_CHAR_CER_MAX:
        raise AssertionError("headtohead_quick: the bounds do not reject "
                             "the untrained checkpoint")
    log(f"headtohead_quick: K1 and K1b launched {launches}")
    return launches


def main() -> int:
    name = phase_device()
    phase_build()
    errors = phase_kernel()
    ebranchformer, ra_launches = phase_ebranchformer()
    models, batched = phase_serve()
    requested = phase_requests(models["float32"])
    del models
    torch.cuda.empty_cache()
    trained = phase_train()
    phase_train_card_vs_cpu()
    # the two CLI phases' corpora and checkpoints stay for serve_socket
    with tempfile.TemporaryDirectory() as work:
        cli_dir, chunk_dir = (os.path.join(work, d) for d in ("cli", "chunk"))
        os.makedirs(cli_dir)
        os.makedirs(chunk_dir)
        cli = phase_cli(cli_dir)
        torch.cuda.empty_cache()
        models = chunk_models_logged()
        chunk = {"offline": phase_chunk_offline(models),
                 "stream": phase_chunk_stream(models),
                 "pool": phase_chunk_pool(models),
                 "fused": phase_chunk_fused(models),
                 "cli": phase_chunk_cli(models["float32"])}
        del models
        torch.cuda.empty_cache()
        chunk["chunk_train"] = phase_chunk_train()
        phase_chunk_train_card_vs_cpu()
        chunk["train_cli"] = phase_chunk_train_cli(chunk_dir)
        torch.cuda.empty_cache()
        socket = phase_serve_socket(cli_dir, chunk_dir)
        vad_punc = phase_serve_vad_punc(cli_dir, chunk_dir)
        torch.cuda.empty_cache()
        beam = phase_beam_lm(cli_dir)
        torch.cuda.empty_cache()
        phase_vad_punc_train()
        torch.cuda.empty_cache()
        block = phase_block_stream()
        torch.cuda.empty_cache()
        leaf_wav = phase_leaf_wav_export(cli_dir, chunk_dir)
        torch.cuda.empty_cache()
        parallel_dir = os.path.join(work, "parallel")
        os.makedirs(parallel_dir)
        parallel = phase_parallel(parallel_dir)
        torch.cuda.empty_cache()
        quick_dir = os.path.join(work, "headtohead")
        os.makedirs(quick_dir)
        quick = phase_headtohead_quick(quick_dir)
    phases = {"E-Branchformer (L) predict_step calls": ebranchformer,
              "predict_step calls": batched, "session's requests": requested,
              "train steps": trained, "train_asr and eval_am CLI calls": cli,
              "chunk predict calls": chunk["offline"],
              "one-stream chunk steps": chunk["stream"],
              "pool's ticks and the request check": chunk["pool"],
              "fused and sequential decoder steps": chunk["fused"],
              "test_chunk_asr CLI call": chunk["cli"],
              "chunk train steps": chunk["chunk_train"],
              "chunk train_asr, eval_am and test_chunk_asr CLI calls":
                  chunk["train_cli"],
              "model server's served window": socket,
              "VAD and punctuation sessions": vad_punc,
              "block-streaming predict, train, CLI and session calls":
                  block,
              "beam and LM phase's predict calls, eval_am, served encodes "
              "and train steps": beam,
              "add_wav_info predict and train calls and the exported "
              "encoder and picker calls": leaf_wav,
              "data- and tensor-parallel ranks' and one-process train "
              "steps and eval_am": parallel,
              "head-to-head quick run's train steps and evaluations":
                  quick}
    launches = (0, 0)
    for n in phases.values():
        launches = add(launches, n)
    log(f"launches on the main path: K1 {launches[0]}, K1b {launches[1]} ("
        + ", ".join(f"{n[0]} and {n[1]} in the {what}"
                    for what, n in phases.items())
        + f"), RA {ra_launches} (in the E-Branchformer (L) predict_step "
        f"calls)")
    if min(min(n) for n in phases.values()) == 0:
        raise AssertionError("the main path did not launch K1 and K1b in "
                             "every phase")
    log(json.dumps({"kernels": [
        {"name": "power_spectrogram", "route": "cuda",
         "source": "tensorflowasr_tpu_torch/csrc/power_spectrogram.cu",
         "replaces": "tensorflowasr_tpu/ops/pallas_frontend.py:77",
         # every launch of the FFT kernel: on the main path each is K1b's
         # FFT pass
         "launches": launches[0], "max_abs_err": errors["k1"]},
        {"name": "log_mel_spectrogram", "route": "cuda",
         "source": "tensorflowasr_tpu_torch/csrc/power_spectrogram.cu",
         "replaces": "tensorflowasr_tpu/ops/pallas_frontend.py:136",
         "launches": launches[1], "max_abs_err": errors["k1b"],
         # the given matrix's gradient, over its largest entry
         "grad_max_rel_err": errors["k1b_grad"]},
        {"name": "rel_attention", "route": "triton",
         "source": "tensorflowasr_tpu_torch/ops/rel_attention.py",
         # the JAX package has no E-Branchformer
         "replaces": None, "launches": ra_launches,
         "max_abs_err": errors["ra"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
