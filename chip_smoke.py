"""Drive the PyTorch port's offline ConformerCTC(S) serving and training
paths, its chunk-streaming ChunkConformer(S) serving and training paths, its
socket model server, its VAD and punctuation serving and training, its
block-streaming ConformerCTC, its CTC prefix beam search with n-gram
shallow fusion, the LEAF and ``add_wav_info`` options, its export through
``torch.export``, its RNN-T loss, its data and tensor parallelism and the
head-to-head recipe's quick run (learning quality) on one CUDA card, and
check them.

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
             CPU batch (B=2 x 1 s), the block-streaming fold (B=1920 x
             7680: 128 x 7.2 s in chunks); and 'valid' at B=16 x 7680
             samples and a ragged T, so that both of K1's slab-copy paths
             are taken;
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
             does it); K1b also at the block-streaming fold. Then K1b with
             a given (trainable) [513, 80]
             matrix (K1 + ``dense_mel_kernel``) at B=128 x 7 s, 'same' and
             'valid', beside its plain version and ``torch.stft`` + the
             same dB + ``torch.matmul`` by that matrix.
3b. rel_attention - RA (the relative-position attention kernel,
             ``ops/rel_attention.py``) at the E-Branchformer (L) decode
             buckets (B=32, 8 x 64 heads, T'=200 / 300 / 400 / 500, ragged
             key masks, ``kernels/sweep_rel_attention.py::inputs``) through
             ``rel_attention`` on card tensors: one launch a call, finite,
             and its largest error against the plain composition in f32 at
             most 1.5x the bf16 plain composition's. Times the kernel, the
             plain composition it replaces and, as a yardstick the port
             never calls, ``F.scaled_dot_product_attention`` with the
             shifted, scaled position scores and the key mask as one
             additive bf16 mask made beforehand, beside the bound of those
             inputs' FLOPs and bytes. Then the full-width bf16
             E-Branchformer (L) (``serve/bench_ebf_buckets.py``: 17 blocks)
             decodes one B=32 batch a bucket with ``predict_step``, which
             must launch RA once a block.
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
11b. chunk_fused - the f32 model with ``fused_decoder`` set on the same
             weights (``serve/bench_chunk.py::with_fused_decoder``) against
             the sequential decoder micro-steps: one stream over 50 chunks
             and a 256-slot pool over 12 ticks with random reset and advance
             masks. Phone ids and n_final identical; char and provisional
             ids identical except at a near-tie of the fused decoder's
             logits (top-two gap within 1e-5 of the top logit's magnitude,
             each reported with its gap; more than 1 % such positions
             fails); every cache leaf within 1e-3 of its largest entry (the
             largest error printed). Then both paths timed in turns: one
             stream chained over 50 chunks (best of 3) and the 256-slot tick
             (best of 10 x 25), with median, minimum and spread, every
             implicit sync an error, K1b once a chunk and a tick exactly;
             then each profiled at 1 and 256 slots
             (``serve/profile_chunk.py::profile``: kernels and copies, device
             time and wall a chunk).
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
16. serve_socket - ``cli.serve_model.build_ops`` (what ``main`` serves) on
             phase 7's ConformerCTC(S) checkpoint and phase 15's
             ChunkConformer(S) checkpoint, ``fused_decoder`` set in a copy
             of the shipped chunk config, a 256-slot pool, served by
             ``ModelServer`` on a 127.0.0.1 TCP port with the offline ops on
             the main thread, after each checkpoint is saved again as
             its next step with its blank bias calibrated (as
             ``serve/bench_chunk.py`` does; else every frame decodes as
             blank). One ``ModelClient`` streams the 8 s file
             alone, then 4 client threads each send one file of 2 / 3.5 / 5
             / 8 s: offline (``info``, ``encode`` a 0.48 s chunk,
             ``ctc_logits``, ``translate``, decoded as ``ASREngine.decode``
             does) and streamed (``stream_open``, ``stream_feed`` in
             odd-sized packets, ``stream_close``). Every result must equal
             the in-process ``ASREngine``'s and an independent
             ``ChunkStreamSession``'s on the same checkpoints, none empty,
             and the encoder rows, CTC and char logits that came over the
             wire must be within 1e-5 of the same calls in process; a
             failing client fails the phase. Prints each file's request round trip,
             ``stream_feed``'s wall a chunk (median, p90) alone and with 4
             clients, and how many chunks each tick coalesced.
17. serve_vad_punc - phase 7's calibrated ConformerCTC(S) checkpoint
             under the VAD state machine with punctuation: a full-width
             OnlineVAD (``configs/vad_model.yml``) and PuncTransformer
             (``configs/punc_settings.yml``, over the ASR's chars but every
             7th) with seeded weights, their last layers calibrated
             (``serve/bench_vad_punc.py``: tone bursts >= 0, gaps < 0; a
             quarter of the positions punctuated). ``StreamASRSession`` on 8
             s of tone bursts in 20 ms pcm16 packets then ``final_send``, and
             ``OfflineASRSession`` with VAD and punctuation on 2 / 3.5 / 5 / 8
             s files (each also without VAD, timed), after a warm pass; the
             same objects copied to the CPU must give the same events, texts
             and segments, the encoder rows within 1e-3; near-ties are
             reported (VAD |logit|, punctuation probability against its
             threshold, CTC and char top-two gaps); no sentence begin or end,
             or every text empty, fails. Then ``cli.serve_model.build_ops``
             with the VAD configs (the calibrated VAD saved as their
             checkpoint) serves the ``vad`` op over 127.0.0.1 to one client,
             within 1e-5 of the in-process ``VADEngine``; and the offline,
             chunk (phase 15's checkpoint) and VAD native artifacts are
             written twice (the same bytes) and read back through their
             manifests, every tensor equal to the model's bit for bit.
             Prints each packet's wall by event type (median, p90), the
             stream's wall against its 8 s, each file's wall with and without
             VAD, ``VADEngine.inference`` on 1 s of 8 kHz audio and one 64-
             token ``PuncEngine`` window, and its exact K1b launches (one an
             encode).
18. vad_punc_train - VAD and punctuation training at the shipped widths:
             OnlineVAD (``configs/vad_model.yml``) f32 train steps at
             ``configs/vad_data.yml``'s B=16 x 6 s at 8 kHz from
             ``VADDataLoader`` on a seeded corpus, one step folded by
             ``streaming_reshape``, one OfflineVAD step; PuncTransformer
             (``configs/punc_settings.yml``) at B=32 x 64 tokens with and
             without 768-d teacher features; each traced once
             (``utils/profiling.py::trace``), each model's loss and gradient
             norm on the card against the CPU (1e-4 / 1e-3 relative); then
             ``cli.train_vad`` -> ``cli.eval_vad --export_native`` and
             ``cli.train_punc --bert_feature_dir`` -> ``cli.eval_punc``,
             each eval restoring. K1 and K1b must not launch on this path.
19. block_stream - ConformerCTC with ``streaming: true`` (a temporary copy
             of ``configs/am_data.yml``) and
             ``configs/Streaming_ConformerS.yml`` at full width, seeded: ``predict_step`` f32 at B=128 x 7.2 s
             (K1b 'same' on the fold [1920, 7680]) with its stage split; f32
             train steps at B=128 x 8.16 s (the loader's 8 s bucket in whole
             chunks) with their split and a trace; the encoder, loss and
             gradient norm on the card against the CPU on B=2 x 2 chunks;
             ``cli.train_asr`` -> ``cli.eval_am`` -> ``cli.test_asr`` on
             phase 7's kind of corpus (a 16-chunk wav: the JAX test_asr
             raises on a wav that is not whole chunks, and the port keeps
             that); ``OfflineASRSession`` on 2 / 3.5 / 5 / 8 s files, its
             per-chunk encoder rows within 1e-3 of the folded encode.
20. beam_lm - on phase 7's corpus and its calibrated checkpoint (phase
             16): an order-3 phone LM by ``cli.train_lm`` on that corpus and
             one over all 231 phones by ``train_ngram_lm`` on a seeded
             corpus; the card's hash lanes equal to ``_hash_tuple``'s
             (tokens just below 2^32) and ``score_candidates`` on the card
             within 1e-6 (and one f32 ulp) of ``NGramLM.score``, BOS contexts
             included; ``make_beam_predict_step`` (W 8, K 16, the 231-phone
             LM at 0.3) on B=128 x 7 s of gated tones beside the greedy
             ``predict_step`` (median of 5 each, waited for), one trace of
             each (kernels and copies a call, device busy share), one beam
             call with every implicit sync an error, and 8 rows against the
             same step on the CPU: best-beam phone ids equal except at a
             near-tie of the top two beams (reported with its gap), live
             scores within 1e-4 relative; ``cli.eval_am --lm`` on the card
             and on the CPU, the same JSON; ``cli.serve_model.build_ops
             --lm`` served on 127.0.0.1, an 8 s file decoded with the beam on
             the host from the served ops against the in-process beam
             ``ASREngine`` on the CPU; ``cli.train_asr --data_procs 2`` and
             ``0`` for 3 steps each, finite losses, steps/s side by side (the
             workers hide the card and fail if CUDA starts in them).
21. leaf_wav_export - (a) ``add_wav_info: true`` and (b) ``mel_layer_type:
             leaf`` on the full-width ConformerCTC(S) (seeded): f32
             ``predict_step`` at B=128 x 7 s, median of 5, in turns with
             the plain model's (5 calls before and 5 after), with the
             ``wav_layer``'s, LEAF's and PCEN's CUDA-event share of one step
             and the peak memory; a warm and 2 timed f32 train steps at
             B=32 x 8 s with finite losses; the encoder, loss and gradient
             norm on the card against the CPU on B=2 x 1 s (1e-3, 1e-4 and
             1e-3 relative); K1 and K1b once a call with add_wav_info,
             never with LEAF. (c) ``export_offline_asr`` of phase 16's
             calibrated ConformerCTC(S) checkpoint and
             ``export_chunk_streaming`` of its ChunkConformer(S) checkpoint
             on the card, loaded back (``load_exported``): the encoder and
             the picker each hold one ``tasr::log_mel_spectrogram`` node and
             launch K1 and K1b once a call; encoder, ctc_model and
             translator at B=1 x 7 s, and the picker and decoder threaded
             over 10 chunks, within rtol 1e-4 / atol 1e-4 of the eager
             models (n_final equal); export and load wall times. (d)
             ``rnnt_loss`` and its gradient at B=8, T=200, U=40, V=256 on
             the card against the CPU (1e-4 relative, 1e-4 of the largest
             gradient entry), timed forward and backward.
22. parallel - data and tensor parallelism (``parallel/``) with two gloo
             ranks pinned to the one card (``parallel/step_check.py``
             starts them; each counts its own K1 and K1b launches and sends
             them back): (a) the full-width ConformerCTC(S) (dropout 0,
             f32, Adam lr 1e-3 at epsilon 1) at a global B=32 x 8 s for 3
             steps, then ChunkConformer(S) with the calibrated picker, each
             held to one process on the same 32 rows from the same weights:
             loss within 1e-4 relative a step, the gradients' global norm
             as the optimizer computes it after its all-reduce within 1e-3,
             parameters and BatchNorm statistics identical across ranks;
             after the first step and after the third, the statistics
             within 1e-4 of each
             leaf's largest entry and the parameters within the fixed
             bounds set from earlier readings (PARALLEL_PARAM_REL: 1e-4 /
             5e-4 for ConformerCTC(S), 2.5e-4 / 5e-4 for the chunk model),
             every bias first moved off zero by
             0.02 x N(0, 1); the chunk batch's halves would take other
             ``t_ref`` alone, printed; a planted fault (BatchNorm moments
             over each rank's own rows) must exceed a bound; (b) a (1 x 2)
             tensor-parallel SGD step of ConformerCTC(S) (4 heads over 2)
             at B=8 (biases moved off zero), loss within 1e-4, every
             parameter within 5e-4 of its largest entry in one process (a
             fixed bound over an earlier reading, TP_PARAM_REL); (c)
             ``cli.train_asr --device cuda:0 --dist_backend gloo`` under
             ``torchrun --nproc_per_node 2`` on phase 7's kind of corpus for
             6 steps with saves, rank 0 alone writing, then a one-process
             ``cli.eval_am`` restoring the checkpoint; (d) one process at
             world size 1 on the default backend (NCCL) taking a step equal
             to the one without a process group. Prints the 2-rank and
             one-process step times (two ranks share one card: not a
             scaling figure). A failing rank fails the phase.
23. headtohead_quick - ``recipes/headtohead.py::quick`` in this process:
             the seed-21 synthetic Mandarin corpus
             (``recipes/synthetic_mandarin.py``, 500 / 50 / 100 utterances,
             12 speakers) and its lists (``recipes/aishell1_prepare.py``),
             then ``cli.train_asr`` for 2000 steps of the offline model
             (dmodel 64, 4 blocks, dropout 0.1) at B=16, lr 5e-4, with the
             noise and masking augmenters, checkpoints every 500 steps, and
             ``cli.eval_am`` on the test list restoring the last one: the
             setting of ``bench.py::bench_headtohead_live``. Phone CER must
             be <= 0.0764 and char CER <= 0.855 (2x and 1.5x JAX's 0.0382
             and 0.570 at the same setting, fixed constants), and
             ``eval_am`` on a freshly initialised checkpoint of the same
             config must miss both. Prints the wall time of the corpus, of
             training (steps/s) and of eval, the trained parameters' device
             and the card.

K1's and K1b's launch counts are set to 0 just before the ``predict_step``
calls, the session's 4 requests, each dtype's train steps, the two CLI
calls, each chunk phase's timed runs (the fused phase's too), the chunk
CLI call, each dtype's chunk train steps, the three chunk train CLI calls,
the model server's served window, the VAD and punctuation phase's timed
sessions and files, the VAD and punctuation training phase (which must
launch neither), the block-streaming phase's predict, train, CLI and
session calls, the beam phase's predict calls, ``eval_am --lm``, served
encodes and train steps, each of the leaf_wav_export phase's predict and
train windows and loaded-graph calls, the parallel phase's rank,
one-process and eval_am steps, and the quick run's train steps and both
evaluations, and read just after each; all but the
training of VAD and punctuation and the LEAF branch must have launched
both. K1b counts one launch a
log-mel (the launch that writes it); K1 counts every launch of the FFT
kernel, in any epilogue: two a 'same' log-mel (the max pass and the log-mel
pass), one a 'valid' one. Where a phase knows its number of frontend calls
it must be exact. The stage breakdowns and the card-vs-CPU checks run
outside those windows. K1's times at the request and the train shape go on
``k1_request_shape`` and ``k1_train_shape`` JSON lines in the kernel phase.
RA's launch count is set to 0 just before each of its calls and each
predict step of the rel_attention phase, and read just after.
The last lines are a JSON line of kernel numbers (K1's times at the serve
shape, with the request, train, cli and the 'valid' shapes beside them, the
largest error over all shapes and the launches inside loaded exported
graphs; K1b's the same way; RA's at the 12 s bucket, with the four buckets
and the predict steps' launches beside them), then ``{"ok":
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
import threading
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
# the block-streaming encoder folds B = 128 x 7.2 s (15 chunks of 7680
# samples) into [1920, 7680] before K1b 'same'
BLOCK_B, BLOCK_CHUNKS = 128, 15
BLOCK_FOLD = (BLOCK_B * BLOCK_CHUNKS, REQUEST_SAMPLES)
CLI_B, CLI_BUCKET_SECONDS = 8, (2.0, 4.0)    # the cli phase's batches
POWER_TOL = dict(rtol=2e-4, atol=2e-3)
# torch.stft's log-mel against the plain version's (the Pallas kernel's
# tolerance, for two DFTs that round differently)
LOGMEL_TOL = dict(rtol=1e-3, atol=5e-2)
# K1b against its plain version, as tests/test_torch_kernels_cuda.py holds
# it: 8.0e-5 seen at most, where a bulk 'valid' log-mel of this noise is
# about 0.02
KERNEL_LOGMEL_TOL = dict(rtol=1e-4, atol=5e-4)


CARD = "not read yet"    # nvidia-smi's "name, power limit", from phase_device


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
    global CARD
    CARD = smi.splitlines()[0]
    log(CARD)
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
            log_mel: bool = False, replaced: bool = False,
            given: bool = False) -> dict:
    """Times of K1, its plain version and ``torch.stft`` on one input, and
    the bound for that input; with ``graph`` also the kernel replayed from a
    CUDA graph. With ``log_mel``, K1b instead (log_mel_spectrogram_pallas's
    counterpart, the fused kernel), its plain version (the plain power, dB
    and mel matmul) and ``torch.stft`` + ``abs()**2`` + the same dB and
    matmul, with the bound counted both ways; with ``replaced`` also K1 +
    the plain dB and mel matmul, the path K1b replaced. With ``given``, K1b
    with a given (trainable) matrix, the shipped basis plus seeded noise so
    that no entry is 0: K1 + ``dense_mel_kernel``, the plain version and
    the library path with that matrix; its banded bound is the dense one."""
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
    basis = fe._frontend_constants(cfg)[1]
    if given:
        basis = basis + np.random.default_rng(t).uniform(
            0, 2e-3, basis.shape).astype(np.float32)
    mel = torch.from_numpy(basis).to(dev)
    given_kw = {"mel_weights": mel} if given else {}

    def epilogue(power):
        return torch.matmul(fe._to_db(power, cfg), mel) if log_mel \
            else power

    def library():
        spec = torch.stft(padded, n_fft, cfg.hop, window=window,
                          center=False, return_complex=True)
        return epilogue((spec.abs() ** 2).transpose(1, 2))

    if log_mel:
        def kernel_fn():
            return fe.log_mel_spectrogram(wav, cfg, **given_kw)

        def plain_fn():
            return fe.log_mel_spectrogram_reference(wav, cfg, **given_kw)
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
    nnz = int(np.count_nonzero(basis))
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
              ("same", 2, SR), ("same", *BLOCK_FOLD))
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
    # a given (trainable) [513, 80] matrix at that shape, both paddings
    given = {}
    for padding in ("same", "valid"):
        times = time_k1(padding, 128, 7 * SR, reps=50, log_mel=True,
                        given=True)
        log_k1b("kernel", f"{padding} B=128 T={7 * SR} with a given [513, "
                f"80] matrix (K1 + dense_mel_kernel)", times)
        given[padding] = {"ms": times["kernel"]["median"],
                          "plain_ms": times["plain"]["median"],
                          "library_ms": times["library"]["median"],
                          "dense_bound_ms": times["dense"]["bound_ms"],
                          "dense_bound_by": times["dense"]["bound_by"]}
    k1b_train = time_k1("same", TRAIN_B, TRAIN_SECONDS * SR, reps=50,
                        log_mel=True)
    log_k1b("kernel", f"same B={TRAIN_B} T={TRAIN_SECONDS * SR} (train)",
            k1b_train)
    # the block-streaming predict_step's fold: 59 MB in, 31 MB out
    k1b_block = time_k1("same", *BLOCK_FOLD, reps=50, log_mel=True)
    log_k1b("kernel", f"same B={BLOCK_FOLD[0]} T={BLOCK_FOLD[1]} (block "
            f"streaming: B={BLOCK_B} x {BLOCK_CHUNKS} chunks folded) "
            f"[{CARD}]", k1b_block)
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
        "given_matrix": given,
        "serve": k1_numbers(128, 7 * SR, k1b),
        "train": k1_numbers(TRAIN_B, TRAIN_SECONDS * SR, k1b_train),
        "request": k1_numbers(1, REQUEST_SAMPLES, k1b_request),
        "block_stream": k1_numbers(*BLOCK_FOLD, k1b_block)}
    result["request_shape"] = k1_numbers(1, REQUEST_SAMPLES, request)
    log(json.dumps({"k1_request_shape": result["request_shape"]}))
    log(json.dumps({"k1_train_shape": result["train_shape"]}))
    result.update(k1_numbers(128, 7 * SR, batched))
    return result


def phase_rel_attention() -> dict:
    """RA at the decode buckets, then its launches in the full-width
    E-Branchformer (L)'s predict step; returns its entry of the kernels
    line (the 12 s bucket's numbers, the four buckets beside them)."""
    import torch.nn.functional as F

    from tensorflowasr_tpu_torch.kernels import sweep_rel_attention as sweep
    from tensorflowasr_tpu_torch.kernels.timing import cuda_times
    from tensorflowasr_tpu_torch.ops import rel_attention as ra
    from tensorflowasr_tpu_torch.serve import bench_ebf_buckets as ebf

    buckets, worst = {}, 0.0
    for t in sweep.LENGTHS:
        q, k, v, bd, u, mask, _ = sweep.inputs(t, seed=t)
        b, _, d = q.shape
        h, hd = u.shape
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
        worst = max(worst, err)

        def heads(x):
            return x.view(b, t, h, hd).transpose(1, 2)

        qu, kh, vh = heads(q) + u[:, None].to(q.dtype), heads(k), heads(v)
        bias = (ra.rel_shift(bd).float() / math.sqrt(hd)).masked_fill(
            ~mask, float("-inf")).to(q.dtype)

        def library():
            return F.scaled_dot_product_attention(qu, kh, vh,
                                                  attn_mask=bias)

        lib_err = float((library().transpose(1, 2).reshape(b, t, d).float()
                         - want).abs().max())
        times = {
            "kernel": cuda_times(
                lambda: ra.rel_attention(q, k, v, bd, u, mask), 20, 10),
            "plain": cuda_times(lambda: ra.rel_attention_reference(
                q, k, v, bd, u, mask), 10, 2),
            "library": cuda_times(library, 20, 10)}
        work = sweep.bound(q, bd)
        log(f"rel_attention: B={b}, {h} x {hd} heads, T'={t}: largest "
            f"error {err:.3e} (bf16 plain {err_plain:.3e}, library "
            f"{lib_err:.3e}) of entries up to {float(want.abs().max()):.3f};"
            f" kernel {fmt_times(times['kernel'])}; plain "
            f"{fmt_times(times['plain'])}; library "
            f"{fmt_times(times['library'])}; bound_ms "
            f"{work['bound_ms']:.4f} by {work['bound_by']} "
            f"({work['whole_ms']:.4f} with bd whole)")
        buckets[t] = {"ms": times["kernel"]["median"],
                      "plain_ms": times["plain"]["median"],
                      "library_ms": times["library"]["median"],
                      "bound_ms": work["bound_ms"],
                      "bound_by": work["bound_by"],
                      "bd_whole_bound_ms": work["whole_ms"],
                      "max_abs_err": err,
                      "plain_bf16_max_abs_err": err_plain,
                      "library_max_abs_err": lib_err}
        del q, k, v, bd, want, plain, got, qu, kh, vh, bias
        torch.cuda.empty_cache()

    model = ebf.model()
    blocks = len(model.encoder.blocks)
    launches = {}
    for seconds in ebf.BUCKETS:
        wav, lengths = ebf.batch(seconds, seed=seconds)
        ebf.decode(model, wav, lengths)             # warm
        ra.rel_attention_cuda.launches = 0
        ebf.decode(model, wav, lengths)
        launches[seconds] = ra.rel_attention_cuda.launches
        if launches[seconds] != blocks:
            raise AssertionError(
                f"the {seconds} s predict step launched RA "
                f"{launches[seconds]} times, not once a block ({blocks})")
    log(f"rel_attention: E-Branchformer (L) predict_step, B={ebf.B}: RA "
        f"launches a batch at " + ", ".join(
            f"{s} s {n}" for s, n in launches.items()))
    del model
    torch.cuda.empty_cache()
    return {
        "name": "rel_attention", "route": "triton",
        "source": "tensorflowasr_tpu_torch/ops/rel_attention.py",
        # the JAX package has no E-Branchformer
        "replaces": None,
        "launches": sum(launches.values()), "launches_per_batch": blocks,
        "max_abs_err": worst,
        # the numbers above are the 12 s bucket's: B=32, 8 x 64, T'=300
        **{key: buckets[300][key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "batch": sweep.B, "heads": sweep.H, "head_size": sweep.HD,
        "frames": 300,
        "buckets": buckets,
    }


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

    c = model.cfg
    with torch.no_grad():
        mark("start")
        # the block-streaming encoder folds the chunks into the batch first
        mel = enc_mod.mel_layer(wav.reshape(-1, c.chunk_samples)
                                if c.streaming else wav)
        mark("frontend (K1b: FFT, dB and banded mel in one kernel)")
        x = enc_mod.conv_subsampling(mel[..., None])
        mark("conv subsampling")
        for block in enc_mod.blocks:
            x = block(x)
        enc = x.float().reshape(wav.shape[0], -1, c.dmodel)
        mark(f"{len(enc_mod.blocks)} conformer blocks")
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


def spread_ms(times: list) -> str:
    ms = [x * 1e3 for x in times]
    return (f"median {statistics.median(ms):.3f} min {min(ms):.3f} spread "
            f"{max(ms) - min(ms):.3f} ms")


def phase_chunk_fused(models: dict) -> tuple:
    """The fused decoder phase (``fused_decoder`` set by
    ``dataclasses.replace`` on the same f32 weights) against the sequential
    micro-steps: one stream over 50 chunks and a 256-slot pool with reset
    and advance masks, ids (near-ties reported), caches within 1e-3 of each
    leaf's largest entry; then both timed in turns, one stream chained
    (best of 3) and the 256-slot tick (best of 10 x 25), every implicit
    sync an error; then kernels and copies a chunk of each from
    ``serve/profile_chunk.py``. Returns K1's and K1b's launches in the
    timed runs."""
    from tensorflowasr_tpu_torch.serve.bench_chunk import with_fused_decoder
    from tensorflowasr_tpu_torch.serve.profile_chunk import profile

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

    # times, the two paths in turns
    first = torch.from_numpy(pool[:, 0].copy()).to(dev)
    stream_t = {seq: [], fused: []}
    tick_t = {seq: [], fused: []}

    def timed():
        for rep in range(max(STREAM_REPS, POOL_REPS)):
            order = (seq, fused) if rep % 2 == 0 else (fused, seq)
            for m in order:
                state = {}
                if rep < STREAM_REPS:
                    state["caches"], state["i"] = m.init_stream_caches(1), 0

                    def step():
                        out = m.fused_stream_step(chunks[state["i"]],
                                                  state["caches"])
                        state["caches"] = out[4]
                        state["i"] += 1

                    stream_t[m].append(chained(step, STREAM_CHUNKS))
                state["caches"] = m.init_multi_stream_caches(POOL_SLOTS)

                def tick():
                    *_, state["caches"] = m.batched_stream_step(
                        first, state["caches"])

                tick_t[m].append(chained(tick, POOL_TICKS))

    with torch.no_grad():
        for m in (seq, fused):                                 # warm-up
            m.fused_stream_step(chunks[0], m.init_stream_caches(1))
            m.batched_stream_step(first,
                                  m.init_multi_stream_caches(POOL_SLOTS))
        _, launches = counted(timed)
    expect(launches, 2 * (STREAM_REPS * STREAM_CHUNKS
                          + POOL_REPS * POOL_TICKS),
           "the timed fused and sequential steps")
    numbers = {}
    for name, m in (("sequential", seq), ("fused", fused)):
        s, k = min(stream_t[m]), min(tick_t[m])
        numbers[name] = {"stream_ms": s * 1e3, "tick_ms": k * 1e3}
        log(f"chunk_fused: f32 {name} decoder: one stream chained "
            f"({STREAM_CHUNKS} chunks, one sync, no implicit sync) "
            f"{spread_ms(stream_t[m])} a chunk over {STREAM_REPS}, best RTF "
            f"{s / CHUNK_S:.4f}; {POOL_SLOTS}-slot tick chained "
            f"{spread_ms(tick_t[m])} over {POOL_REPS} x {POOL_TICKS}, best "
            f"{POOL_SLOTS * CHUNK_S / k:.1f} streams in real time")

    # kernels and copies a chunk, profiled
    with torch.no_grad():
        for slots in (1, POOL_SLOTS):
            for name, m in (("sequential", seq), ("fused", fused)):
                numbers[name][f"profile_{slots}"] = profile(m, slots, top=8)
    log("chunk_fused: " + json.dumps({"chunk_fused": numbers}))
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
    times."""
    t0 = time.perf_counter()
    cs = int(client.call("info")[0][0])
    calls = []
    encs = []
    for i in range(0, len(wav), cs):
        c0 = time.perf_counter()
        encs.append(client.call("encode", wav[None, i:i + cs])[0])
        calls.append(time.perf_counter() - c0)
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
            "wall": time.perf_counter() - t0, "encode_calls": calls,
            "tensors": (encs, buf, logits, padded, char_logits)}


def stream_request(client, wav: np.ndarray, cs: int) -> dict:
    """``stream_open``, ``stream_feed`` in odd-sized packets,
    ``stream_close``; each feed's wall over the chunks it completed."""
    slot = client.call("stream_open")[0]
    per_chunk, buffered, off, k = [], 0, 0, 0
    while off < len(wav):
        pkt = wav[off:off + SOCKET_PACKETS[k % len(SOCKET_PACKETS)]]
        off, k = off + len(pkt), k + 1
        t0 = time.perf_counter()
        client.call("stream_feed", slot, pkt)
        wall = time.perf_counter() - t0
        done, buffered = divmod(buffered + len(pkt), cs)
        if done:
            per_chunk.extend([wall / done] * done)
    ph, ch = client.call("stream_close", slot)
    return {"phone_ids": ph.tolist(), "char_ids": ch.tolist(),
            "per_chunk": per_chunk}


def pct(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs) * 1e3, q))


@torch.no_grad()
def calibrate_checkpoints(cli_data: str, model_yml: str, chunk_data: str,
                          chunk_yml: str) -> str:
    """Save each CLI phase's newest checkpoint again as its next step with
    the blank bias moved by the median margin of the blank logit on 4 x 4
    s of gated tones (the chunk model also with its first conv x10:
    ``serve/bench_chunk.py::calibrate``): a few steps from a random init
    decode every frame as blank, and the served ids would be empty."""
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.serve.bench_chunk import calibrate
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
    t0 = time.perf_counter()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        ops, inline_ops, front = serve_model.build_ops(args)
    if "checkpoint under" in err.getvalue():
        raise AssertionError(f"serve_model: {err.getvalue()[-400:]}")
    built = time.perf_counter() - t0

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
    cs = srv.cfg.chunk_samples
    coalesced = []
    dispatch = srv._dispatch

    def spy(adv):
        coalesced.append(int(adv.sum()))
        return dispatch(adv)

    srv._dispatch = spy
    server = ModelServer(ops, tcp_port=0, inline_exec=False,
                         inline_ops=inline_ops)
    results = {"alone": None, "offline": [None] * 4, "stream": [None] * 4}
    failures = []

    def client_alone():
        client = ModelClient(tcp_port=server.tcp_port)
        try:
            results["alone"] = stream_request(client, wavs[-1], cs)
        finally:
            client.close()

    def client(i):
        cli = ModelClient(tcp_port=server.tcp_port)
        try:
            results["offline"][i] = offline_request(cli, wavs[i])
            results["stream"][i] = stream_request(cli, wavs[i], cs)
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

    t0 = time.perf_counter()
    _, launches = counted(serve)
    served = time.perf_counter() - t0
    front.shutdown()
    if failures:
        raise failures[0]
    encodes = sum(-(-len(w) // engine.chunk_samples) for w in wavs)
    expect(launches, encodes + len(coalesced),
           f"the served window ({encodes} encodes, {len(coalesced)} ticks)")
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
    four = [x for st in results["stream"] for x in st["per_chunk"]]
    alone = results["alone"]["per_chunk"]
    log(f"serve_socket: checkpoints of phases 7 and 15, {calibrated}; "
        f"cli.serve_model build_ops (restore, build, warm) {built:.2f} s; "
        f"{len(wavs)} files of {SOCKET_SECONDS} s over "
        f"127.0.0.1:{server.tcp_port}, offline and streamed, = ASREngine "
        f"and independent ChunkStreamSessions (phones "
        f"{[len(o[0]) for o in offline_want]} offline; phones "
        f"{[len(s['phone_ids']) for s in stream_want]}, chars "
        f"{[len(s['char_ids']) for s in stream_want]} streamed); encoder "
        f"rows, CTC and char logits over the wire within {worst:.3e} of the "
        f"in-process calls; served window {served:.2f} s")
    if not all(o[0] for o in offline_want) or not all(
            s["phone_ids"] for s in stream_want):
        raise AssertionError("a decode is empty: nothing was compared")
    for i, s in enumerate(SOCKET_SECONDS):
        off = results["offline"][i]
        log(f"serve_socket: {s} s file, offline request round trip (info, "
            f"{len(off['encode_calls'])} encodes, ctc_logits, translate) "
            f"{off['wall'] * 1e3:.3f} ms; encode round trip median "
            f"{statistics.median(off['encode_calls']) * 1e3:.3f} ms")
    log(f"serve_socket: stream_feed wall a chunk, 1 client (8 s file, "
        f"{len(alone)} chunks): median {pct(alone, 50):.3f} p90 "
        f"{pct(alone, 90):.3f} ms; 4 concurrent clients ({len(four)} "
        f"chunks): median {pct(four, 50):.3f} p90 {pct(four, 90):.3f} ms; "
        f"{len(coalesced)} ticks coalesced {sum(coalesced)} chunks (mean "
        f"{statistics.mean(coalesced):.2f}, max {max(coalesced)}, "
        f"{sum(c > 1 for c in coalesced)} ticks with more than one)")
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


def decode_margins(asr, encs) -> tuple:
    """The smallest top-two gap of the CTC logits over the decoded rows and
    of the char logits over the emitted positions, for one
    ``ASREngine.decode`` of ``encs`` (its padding, its greedy CTC)."""
    from tensorflowasr_tpu_torch.ops.ctc import ctc_greedy_decode

    enc = np.concatenate(encs)
    t = len(enc)
    cap = -(-(-(-t // asr.chunk_frames)) // asr.pad_chunks) \
        * asr.pad_chunks * asr.chunk_frames
    buf = np.zeros((1, cap, enc.shape[1]), np.float32)
    buf[0, :t] = enc
    with torch.no_grad():
        enc_t = torch.from_numpy(buf).to(asr.device)
        logits = asr.model.ctc_logits(enc_t)
        ids, lens = ctc_greedy_decode(
            logits, torch.tensor([t], dtype=torch.int32,
                                 device=asr.device), asr.blank)
        padded = torch.nn.functional.pad(ids, (0, 10))
        chars = asr.model.translate(padded, enc_t)[0]
    top = logits[0, :t].topk(2, -1).values
    ctop = chars[:int(lens[0]) + 1].topk(2, -1).values
    return (float((top[:, 0] - top[:, 1]).min()),
            float((ctop[:, 0] - ctop[:, 1]).min()))


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
    from tensorflowasr_tpu_torch.serve import bench_vad_punc as bvp
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
    vad_margin = bvp.calibrate_vad(vad_model, stream)
    CheckpointManager(os.path.join(work, "vad-logs", "checkpoints")).save(
        1, vad_state)

    # every char of the ASR's vocabulary but each 7th (out of vocabulary)
    chars = [t for t in char_f.vocab_array if t not in ("<S>", "</S>")]
    with open(os.path.join(work, "punc_chars.txt"), "w") as f:
        f.write("\n".join(["<S>", "</S>"] + [
            c for i, c in enumerate(chars) if i % 7]))
    with open(os.path.join(work, "punc_tokens.txt"), "w") as f:
        f.write("\n".join(["<S>", "</S>", *bvp.PUNC_TOKENS]))
    with open(os.path.join(work, "punc.list"), "w") as f:
        f.write(f"{chars[1]}{chars[2]}{bvp.PUNC_TOKENS[1]}\n")
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
    share = bvp.calibrate_punc(punc_model, ids, PUNC_THRESHOLD)

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
    (pcm16 bytes), then ``final_send``: the events (task ids dropped), each
    packet's wall by event type, the whole wall, and what the engines
    returned (encoder rows, VAD logits, punctuation probabilities, the
    decodes' encoder inputs)."""
    from tensorflowasr_tpu_torch.serve.stream_session import (
        StreamASRSession,
    )

    taps = {"enc": Tap(engines["asr"], "extract_feature"),
            "vad": Tap(engines["vad"], "inference"),
            "probs": Tap(engines["punc"], "_window_probs")}
    decodes = []
    decode = engines["asr"].decode

    def recorded(encs):
        decodes.append([np.array(e) for e in encs])
        return decode(encs)
    engines["asr"].decode = recorded
    session = StreamASRSession(engines["asr"], engines["vad"],
                               punc=engines["punc"], sample_rate=SR)
    events, walls = [], []
    t0 = time.perf_counter()
    for pkt in packets + [None]:
        t = time.perf_counter()
        ev = session.send(pkt) if pkt is not None else session.final_send()
        walls.append((ev["event_type"] if ev else "none",
                      time.perf_counter() - t))
        if ev:
            ev.pop("task_id", None)
            events.append(ev)
    wall = time.perf_counter() - t0
    del engines["asr"].decode
    out = {k: tap.remove() for k, tap in taps.items()}
    out.update(events=events, walls=walls, wall=wall, decodes=decodes)
    return out


def phase_serve_vad_punc(cli_dir: str, chunk_dir: str,
                         device: str = "cuda") -> tuple:
    """The VAD and punctuation serving path on the card: a live
    ``StreamASRSession`` over 8 s of tone bursts in 20 ms pcm16 packets,
    the VAD-segmented and punctuated ``OfflineASRSession`` on 2 / 3.5 / 5 /
    8 s files, each against the same objects on the CPU; the ``vad`` op of
    ``cli.serve_model.build_ops`` with the VAD configs over a TCP socket
    against the in-process engine; and the native artifacts of the
    offline, chunk and VAD models read back. Returns K1's and K1b's
    launches in the timed session and the files on the card."""
    import copy
    import filecmp

    from tensorflowasr_tpu_torch.cli import serve_model
    from tensorflowasr_tpu_torch.export import native_export as nx
    from tensorflowasr_tpu_torch.models import convert
    from tensorflowasr_tpu_torch.ops import frontend as fe
    from tensorflowasr_tpu_torch.serve import bench_vad_punc as bvp
    from tensorflowasr_tpu_torch.serve.model_server import (
        ModelClient,
        ModelServer,
    )
    from tensorflowasr_tpu_torch.serve.offline_session import (
        OfflineASRSession,
    )
    from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    t_phase = time.perf_counter()
    work = os.path.join(cli_dir, "vad_punc")
    os.makedirs(work)
    stream = bvp.tone_bursts(bvp.STREAM_PATTERN, seed=1)
    pcm = (np.clip(stream, -1, 1) * 32767).astype("<i2")
    packets = [pcm[i:i + PACKET].tobytes()
               for i in range(0, len(pcm), PACKET)]
    cli_data = os.path.join(cli_dir, "data.yml")
    engines, models, (vad_data, vad_yml), notes, vocabs = vad_punc_engines(
        cli_data, work, stream, device)
    log(f"serve_vad_punc: {notes}")

    # the live session and the offline files, on the card (a warm pass
    # first) and with copies of the same models on the CPU
    files = [bvp.tone_bursts(bvp.file_pattern(s), seed=40 + i)
             for i, s in enumerate(VAD_FILE_SECONDS)]
    encodes = []
    model = engines["asr"].model
    encode = model.encode

    def counting_encode(wav, *lengths):
        encodes.append(wav.shape)
        return encode(wav, *lengths)
    model.encode = counting_encode
    live_session(engines, packets)
    for wav in files[:1]:
        OfflineASRSession(engines["asr"], engines["vad"],
                          engines["punc"]).transcribe_wav(wav)

    def card():
        del encodes[:]
        live = live_session(engines, packets)
        n_live = len(encodes)
        offline, walls = [], []
        for wav in files:
            t0 = time.perf_counter()
            segs = OfflineASRSession(engines["asr"], engines["vad"],
                                     engines["punc"]).transcribe_wav(wav)
            t1 = time.perf_counter()
            OfflineASRSession(engines["asr"]).transcribe_wav(wav)
            walls.append((t1 - t0, time.perf_counter() - t1))
            offline.append(segs)
        return live, n_live, offline, walls

    (live, n_live, offline, walls), launches = counted(card)
    del model.encode
    # the plain file decodes (without VAD) launched too: every encode
    expect(launches, len(encodes), f"the phase's {len(encodes)} encodes "
           f"({n_live} in the live session)")
    cpu_models = {k: copy.deepcopy(m).cpu() for k, m in models.items()}
    cpu = make_engines(cpu_models, *vocabs, "cpu")
    live_cpu = live_session(cpu, packets)
    offline_cpu = [OfflineASRSession(cpu["asr"], cpu["vad"], cpu["punc"])
                   .transcribe_wav(wav) for wav in files]

    # near-ties: VAD logits near 0, punctuation probabilities near the
    # threshold, CTC and char top-two gaps of every decode
    vad_min = min(float(np.abs(x).min()) for x in live["vad"])
    punc_min = min([float(np.abs(p[1:-1].max(-1) - PUNC_THRESHOLD).min())
                    for p in live["probs"] if len(p) > 2] or [math.inf])
    gaps = [decode_margins(engines["asr"], encs)
            for encs in live["decodes"] if encs]
    ctc_gap = min([g[0] for g in gaps] or [math.inf])
    char_gap = min([g[1] for g in gaps] or [math.inf])
    log(f"serve_vad_punc: near-ties on the card: smallest VAD |logit| "
        f"{vad_min:.3e} over {sum(x.size for x in live['vad'])} frames of "
        f"{len(live['vad'])} calls; punctuation |p - {PUNC_THRESHOLD}| "
        f"{punc_min:.3e} over {len(live['probs'])} calls; top-two gap of "
        f"the CTC logits {ctc_gap:.3e}, of the char logits {char_gap:.3e} "
        f"over {len(gaps)} decodes")
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
    punctuated = sum(any(p in t for p in bvp.PUNC_TOKENS) for t in texts)
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

    by_type = {}
    for kind, wall in live["walls"]:
        by_type.setdefault(kind, []).append(wall)
    log("serve_vad_punc: live session wall a 20 ms packet (ms): " + "; ".join(
        f"{kind} median {pct(w, 50):.3f} p90 {pct(w, 90):.3f} ({len(w)})"
        for kind, w in sorted(by_type.items())))
    log(f"serve_vad_punc: whole 8 s stream ({len(packets)} packets + "
        f"final_send) {live['wall']:.3f} s of wall (RTF "
        f"{live['wall'] / 8.0:.4f}); {n_live} encodes (K1b B=1 x 7680)")
    for s, (with_vad, without) in zip(VAD_FILE_SECONDS, walls):
        log(f"serve_vad_punc: {s} s file, OfflineASRSession with VAD and "
            f"punctuation {with_vad * 1e3:.3f} ms, without (PRs 1-7) "
            f"{without * 1e3:.3f} ms")

    # the engines alone: VAD on 1 s of 8 kHz audio, one 64-token window
    frames = bvp.vad_frames(stream)
    second = np.ascontiguousarray(frames[:, 100:200])
    times = []
    for _ in range(60):
        t0 = time.perf_counter()
        engines["vad"].inference(second)
        times.append(time.perf_counter() - t0)
    window = np.zeros((1, 64), np.int32)
    window[0, :40] = np.random.default_rng(9).integers(
        3, vocabs[1].num_classes, 40)
    ptimes = []
    for _ in range(60):
        t0 = time.perf_counter()
        engines["punc"]._infer(window)
        ptimes.append(time.perf_counter() - t0)
    log(f"serve_vad_punc: VADEngine.inference on 1 s at 8 kHz (100 "
        f"frames) median {pct(times[10:], 50):.3f} ms (min "
        f"{min(times) * 1e3:.3f}); PuncEngine one 64-token window median "
        f"{pct(ptimes[10:], 50):.3f} ms (min {min(ptimes) * 1e3:.3f})")

    # the vad op over the socket: cli.serve_model with the VAD configs
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
                t0 = time.perf_counter()
                served[name] = (cli.call("vad", x)[0],
                                time.perf_counter() - t0)
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
        got = served[name][0]
        err_v = float(np.abs(got - want).max() / np.abs(want).max())
        if got.shape != want.shape or err_v > 1e-5:
            raise AssertionError(f"served vad {name}: {err_v:.3e}")
        worst = max(worst, err_v)
    log(f"serve_vad_punc: cli.serve_model --vad_data_config/"
        f"--vad_model_config, the vad op over 127.0.0.1: {frames.shape[1]} "
        f"frames in {served['stream'][1] * 1e3:.3f} ms, 100 in "
        f"{served['second'][1] * 1e3:.3f} ms, within {worst:.3e} of "
        f"VADEngine in process")

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
        t0 = time.perf_counter()
        export(m, a)
        took = time.perf_counter() - t0
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
                     f"{os.path.getsize(os.path.join(a, 'weights.bin'))} B "
                     f"in {took * 1e3:.1f} ms")
    log(f"serve_vad_punc: native artifacts written twice with the same "
        f"bytes and read back bit for bit: {'; '.join(sizes)}; phase "
        f"{time.perf_counter() - t_phase:.2f} s")
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


def timed_steps(step, state, batch, steps: int) -> tuple:
    """A warm step, then ``steps`` steps each waited for: (median ms,
    minimum ms, the train losses)."""
    losses, times = [], []
    _, m = step(state, batch)
    torch.cuda.synchronize()
    losses.append(m["train_loss"])
    for _ in range(steps):
        t0 = time.perf_counter()
        _, m = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["train_loss"])
    values = [float(v) for v in torch.stack(losses).cpu()]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"non-finite train_loss: {values}")
    return statistics.median(times), min(times), values


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


def run_cli(main_fn, args: list) -> tuple:
    """``main_fn(args)`` with its stdout and stderr captured: (the last
    stdout line as JSON or None, stdout, stderr, seconds)."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main_fn(args)
    took = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__}: rc {rc}, stderr "
                             f"{err.getvalue()[-400:]}")
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return last, out.getvalue(), err.getvalue(), took


def phase_vad_punc_train(steps: int = 10) -> tuple:
    """VAD and punctuation training on the card. The shipped models at full
    width with seeded weights: OnlineVAD (``configs/vad_model.yml``, dmodel
    32) on a batch of ``configs/vad_data.yml``'s shape, B = 16 x 6 s at 8
    kHz (x [16, 600, 80]) from ``VADDataLoader`` over a seeded corpus of
    tone bursts: a warm step and 10 timed f32 steps, one step on the batch
    folded by ``streaming_reshape``, one OfflineVAD step; PuncTransformer
    (``configs/punc_settings.yml``) on B = 32 x 64 tokens from
    ``PuncDataLoader``, with and without 768-d teacher features, each a
    warm step and 10 timed steps. Each model's loss and gradient on the
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
    from tensorflowasr_tpu_torch.utils.profiling import trace

    t_phase = time.perf_counter()
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
            med, low, losses = timed_steps(step, state, batch, steps)
            n_params = sum(p.numel() for p in model.parameters())
            log(f"vad_punc_train: OnlineVAD dmodel {model.dmodel} "
                f"({n_params} parameters) f32 train step B={VAD_B} x "
                f"{VAD_SECONDS} s at {VAD_SR} Hz (x {list(batch['x'].shape)},"
                f" {float(numpy_vad['labels'].mean()):.3f} of the frames "
                f"voiced): median {med:.3f} ms (min {low:.3f}; {steps} "
                f"steps, each waited for), "
                f"{VAD_B * VAD_SECONDS / med * 1e3:.1f} audio s/s; train_loss {losses[0]:.4f} -> {losses[-1]:.4f}"
                f" [{CARD}]")
            trace(lambda: [step(state, batch) for _ in range(steps)], steps,
                  f"vad_punc_train: OnlineVAD train step B={VAD_B}, back to "
                  f"back [{CARD}]", "step", 8)
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
            torch.cuda.synchronize()
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
            n_params = sum(p.numel() for p in pmodel.parameters())
            for with_feats in (True, False):
                b = {k: torch.from_numpy(v).cuda()
                     for k, v in numpy_punc.items()
                     if with_feats or k != "bert_features"}
                med, low, losses = timed_steps(pstep, pstate, b, steps)
                log(f"vad_punc_train: PuncTransformer {pmodel.cfg.num_layers}"
                    f" layers x d {pmodel.cfg.d_model} ({n_params} "
                    f"parameters, {char_f.num_classes} ids, "
                    f"{pdl.num_punc_classes} classes) f32 train step B="
                    f"{PUNC_B} x {PUNC_LEN} tokens "
                    f"{'with' if with_feats else 'without'} 768-d teacher "
                    f"features, dropout {pmodel.cfg.dropout}: median "
                    f"{med:.3f} ms (min {low:.3f}), "
                    f"{PUNC_B * PUNC_LEN / med * 1e3:.0f} tokens/s; "
                    f"train_loss {losses[0]:.4f} -> {losses[-1]:.4f} [{CARD}]")
                if with_feats:
                    trace(lambda: [pstep(pstate, b) for _ in range(steps)],
                          steps, f"vad_punc_train: PuncTransformer train "
                          f"step B={PUNC_B} x {PUNC_LEN} with teacher "
                          f"features, back to back [{CARD}]", "step", 8)
            # the card against the CPU at dropout 0 (its masks differ)
            quiet = UserConfig(paths["punc"], paths["punc"],
                               extra={"model_config": {"rate": 0.0}})
            card_vs_cpu(lambda d: build_punc_model(quiet, d)[2],
                        punc_trainer.loss_and_metrics, numpy_punc,
                        "PuncTransformer (teacher features, dropout 0)")

            vad_args = ["--data_config", paths["vad_data"], "--model_config",
                        paths["vad_model"], "--device", "cuda"]
            _, _, _, t_train = run_cli(train_vad.main,
                                       vad_args + ["--total_steps", "4"])
            native = os.path.join(root, "vad_native")
            got, out, err, t_eval = run_cli(
                eval_vad.main, vad_args + ["--max_batches", "2",
                                           "--export_native", native])
            if "no VAD checkpoint" in err or set(got) != {"acc", "f1"} or \
                    not os.listdir(native):
                raise AssertionError(f"cli.eval_vad: {got}, {err[-300:]}")
            log(f"vad_punc_train: cli.train_vad 4 steps of B={VAD_B} in "
                f"{t_train:.2f} s; cli.eval_vad restored step 4, wrote the "
                f"native artifact ({sorted(os.listdir(native))}) and scored "
                f"2 batches in {t_eval:.2f} s: {json.dumps(got)}")
            punc_args = ["--data_config", paths["punc"], "--model_config",
                         paths["punc"], "--device", "cuda"]
            _, _, _, t_train = run_cli(
                train_punc.main, punc_args + [
                    "--total_steps", "4", "--bert_feature_dir",
                    paths["features"]])
            got, out, err, t_eval = run_cli(eval_punc.main,
                                            punc_args + ["--max_batches",
                                                         "2"])
            if "no punctuation checkpoint" in err or \
                    set(got) != {"bd_acc", "bd_loss"}:
                raise AssertionError(f"cli.eval_punc: {got}, {err[-300:]}")
            with open(os.path.join(root, "punc-logs", "metrics.jsonl")) as f:
                logged = [json.loads(line) for line in f]
            if [m["step"] for m in logged] != [2, 4] or not all(
                    m["feature_map_loss"] > 0 for m in logged):
                raise AssertionError(f"train_punc's metrics {logged}")
            log(f"vad_punc_train: cli.train_punc 4 steps of B={PUNC_B} with "
                f"teacher features in {t_train:.2f} s (train_loss "
                f"{logged[0]['train_loss']:.3f} -> "
                f"{logged[-1]['train_loss']:.3f}); cli.eval_punc restored "
                f"step 4 and scored 2 batches in {t_eval:.2f} s: "
                f"{json.dumps(got)}")

        _, launches = counted(run)
    if launches != (0, 0):
        raise AssertionError(f"the VAD and punctuation path launched K1 and "
                             f"K1b {launches} times")
    log(f"vad_punc_train: K1 and K1b launched 0 times (no kernel of the "
        f"port is on this path); phase {time.perf_counter() - t_phase:.2f} s")
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


def phase_block_stream(reps: int = 5, steps: int = 10) -> tuple:
    """The block-streaming ConformerCTC on the card: seeded full-width
    ``configs/Streaming_ConformerS.yml`` (dmodel 256, 4 blocks, 4 x 64
    heads, kernel 5) with ``configs/am_data.yml``, ``streaming: true``
    written into a temporary copy. ``predict_step`` in f32 at B = 128 x 7.2
    s (15 chunks, folded to [1920, 7680] for K1b 'same'), median of 5, and
    its stage split; f32 train steps at B = 128 x the loader's chunk-
    quantised 8 s (17 chunks, input_length 204), a warm step and 10 timed;
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
    from tensorflowasr_tpu_torch.utils.profiling import trace

    t_phase = time.perf_counter()
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

        def predict():
            out = predict_step(model, wav, length)
            torch.cuda.synchronize()
            check_outputs(out, BLOCK_B, t_enc)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = predict_step(model, wav, length)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            check_outputs(out, BLOCK_B, t_enc)
            return times

        times, n = counted(predict)
        launches = add(launches, expect(n, reps + 1,
                                        f"{reps + 1} block predict calls"))
        step = statistics.median(times)
        log(f"block_stream: predict_step f32 B={BLOCK_B} x {seconds} s "
            f"({BLOCK_CHUNKS} chunks of {chunk}, K1b on "
            f"[{BLOCK_B * BLOCK_CHUNKS}, {chunk}]): median "
            f"{step * 1e3:.3f} ms (min {min(times) * 1e3:.3f}), per-stream "
            f"RTF {step / (BLOCK_B * seconds):.3e}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{CARD}]")
        log(f"block_stream: f32 stages (ms): "
            f"{json.dumps(stage_breakdown(model, wav, length))} [{CARD}]")
        predict_launches = n
        del wav

        # training at the loader's chunk-quantised 8 s bucket
        numpy_batch = train_batch(TRAIN_B, BLOCK_TRAIN_CHUNKS * chunk / SR,
                                  TRAIN_PHONES, TRAIN_CHARS)
        numpy_batch["input_length"][:] = BLOCK_TRAIN_CHUNKS * chunk // 640
        batch = trainer._prepare_batch(numpy_batch)
        state = trainer.state
        torch.cuda.reset_peak_memory_stats()
        (med, low, losses), n = counted(
            lambda: timed_steps(trainer.train_step, state, batch, steps))
        launches = add(launches, expect(n, steps + 1,
                                        f"{steps + 1} block train steps"))
        audio_s = TRAIN_B * BLOCK_TRAIN_CHUNKS * chunk / SR
        log(f"block_stream: train_step f32 B={TRAIN_B} x "
            f"{BLOCK_TRAIN_CHUNKS * chunk / SR} s ({BLOCK_TRAIN_CHUNKS} "
            f"chunks, input_length {BLOCK_TRAIN_CHUNKS * chunk // 640}), "
            f"{TRAIN_PHONES} phones, {TRAIN_CHARS} chars, dropout "
            f"{cfg.dropout}: median {med:.3f} ms (min {low:.3f}; {steps} "
            f"steps, each waited for), {audio_s / med * 1e3:.1f} audio s/s, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; train_loss {losses[0]:.4f} -> {losses[-1]:.4f} [{CARD}]")
        log(f"block_stream: f32 train stages (ms): "
            f"{json.dumps(train_stage_split(trainer, batch))} [{CARD}]")
        trace(lambda: [trainer.train_step(state, batch) for _ in range(3)],
              3, f"block_stream: train_step f32 B={TRAIN_B}, back to back "
              f"[{CARD}]", "step", 8)
        del trainer, state, batch, model
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
            t0 = time.perf_counter()
            run_cli(train_asr.main, common + ["--total_steps", "3",
                                              "--data_workers", "2",
                                              "--compute_dtype", "float32"])
            t_train = time.perf_counter() - t0
            scores, _, err, t_eval = run_cli(eval_am.main,
                                             common + ["--max_batches", "2"])
            if "no checkpoint found" in err:
                raise AssertionError("cli.eval_am did not restore")
            _, out, err, t_test = run_cli(test_asr.main, common + [
                "--wav", wav_path, "--compute_dtype", "float32"])
            if "no checkpoint found" in err or "phones:" not in out:
                raise AssertionError(f"cli.test_asr: {out[-300:]}")
            return scores, out, t_train, t_eval, t_test

        (scores, out, t_train, t_eval, t_test), n = counted(clis)
        launches = add(launches, expect(
            n, 3 + 2 + 2, "the block train_asr, eval_am and test_asr calls"))
        for key in ("phone_cer", "char_cer"):
            if not math.isfinite(scores[key]):
                raise AssertionError(f"eval_am: {key} = {scores[key]}")
        decoded = [line for line in out.splitlines()
                   if line.startswith(("phones:", "audio"))]
        log(f"block_stream: cli.train_asr 3 f32 steps of B={CLI_B} in "
            f"{t_train:.2f} s; cli.eval_am restored step 3 and scored 2 "
            f"batches in {t_eval:.2f} s: {json.dumps(scores)}; cli.test_asr "
            f"on a 16-chunk wav in {t_test:.2f} s: {decoded[-1]}")

        # OfflineASRSession, one batched encode a file, against the folded
        # encode
        trainer = block_trainer(cli_data, "cuda")
        if not trainer.restore():
            raise AssertionError("no block checkpoint to serve")
        model = trainer.state.model.eval()
        asr = ASREngine(model, sample_rate=SR, text_featurizer=CharVocab())
        session = OfflineASRSession(asr)
        session.transcribe_wav(noise(SR, seed=23))              # warm-up
        files = [noise(int(s * SR), seed=30 + i)
                 for i, s in enumerate(BLOCK_FILE_SECONDS)]
        pieces = sum(1 for w in files for s in range(0, len(w), chunk)
                     if len(w[s:s + chunk]) >= MIN_PIECE_SAMPLES)
        tap = Tap(asr, "encode_pieces")

        def requests():
            walls = []
            for w in files:
                t0 = time.perf_counter()
                segments = session.transcribe_wav(w)
                walls.append(time.perf_counter() - t0)
                if len(segments) != 1 or not isinstance(
                        segments[0]["text"], str):
                    raise AssertionError(f"bad segments {segments}")
            return walls

        walls, n = counted(requests)
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
        log(f"block_stream: OfflineASRSession "
            + ", ".join(f"{s} s {t * 1e3:.3f} ms" for s, t in
                        zip(BLOCK_FILE_SECONDS, walls))
            + f" ({pieces} chunks in {encodes} batched encodes); its "
            f"encoder rows joined vs the folded encode of each padded file: "
            f"max|err| {worst:.3e} [{CARD}]")
    log(f"block_stream: K1 and K1b launched {launches}; phase "
        f"{time.perf_counter() - t_phase:.2f} s")
    return launches, predict_launches


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
    Returns (phones, char ids, the beam's output, encodes, wall s)."""
    from tensorflowasr_tpu_torch.ops.beam import ctc_beam_search_decode
    from tensorflowasr_tpu_torch.utils.ngram_lm import lm_pack

    t0 = time.perf_counter()
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
    return phones, chars, beams, len(encs), time.perf_counter() - t0


def read_chars(ids, stop: int) -> list:
    out = []
    for v in ids:
        if v == 0 or v == stop:
            break
        out.append(CharVocab().iextract(int(v)))
    return out


def phase_beam_lm(cli_dir: str, reps: int = 5) -> tuple:
    """CTC prefix beam search with the n-gram LM fused on the card, on the
    cli phase's corpus and its calibrated ConformerCTC(S) checkpoint: (a) an
    order-3 phone LM by ``cli.train_lm`` on that corpus, and one over all
    231 phones from a seeded corpus; (b) the card's hash lanes and
    ``score_candidates`` against numpy; (c) ``make_beam_predict_step`` (W 8,
    K 16, the 231-phone LM at 0.3) at B = 128 x 7 s of gated tones beside
    the greedy ``predict_step`` (median of 5 each, waited for), one trace
    of each, one beam call with every implicit sync an error, and 8 rows
    against the same step on the CPU; (d) ``cli.eval_am --lm`` on the card
    and on the CPU, the same JSON; (e) ``cli.serve_model.build_ops --lm``
    served on 127.0.0.1, an 8 s file decoded with the beam from the served
    ops against the in-process beam ``ASREngine`` on the CPU; (f)
    ``cli.train_asr --data_procs 2`` and ``0``, 3 steps each. K1b's
    launches are counted exactly in (c)-(f). Returns them."""
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
    from tensorflowasr_tpu_torch.utils.profiling import trace

    laps = [time.perf_counter()]

    def lap() -> str:
        """Seconds since the previous lap, for the phase's log lines."""
        laps.append(time.perf_counter())
        return f"{laps[-1] - laps[-2]:.1f} s"

    root = os.path.dirname(os.path.abspath(__file__))
    model_yml = os.path.join(root, "configs", "conformerS.yml")
    cli_data = os.path.join(cli_dir, "data.yml")
    dev = torch.device("cuda")
    launches = (0, 0)

    # (a) the LMs
    lm_npz = os.path.join(cli_dir, "lm_phone3.npz")
    _, out, _, took = run_cli(train_lm.main, [
        "--data_config", cli_data, "--unit", "phone", "--order", "3",
        "--output", lm_npz, "--eval_lists",
        os.path.join(cli_dir, "eval.list")])
    cli_lm = NGramLM.load(lm_npz)
    if (cli_lm.order, cli_lm.vocab_size) != (3, N_PHONE):
        raise AssertionError(f"cli.train_lm: order {cli_lm.order}, "
                             f"vocabulary {cli_lm.vocab_size}")
    log(f"beam_lm: cli.train_lm in {took:.2f} s: "
        + " / ".join(out.strip().splitlines()))
    t0 = time.perf_counter()
    full_lm = full_vocab_lm()
    log(f"beam_lm: order-3 LM over {N_PHONE} phones from a seeded corpus in "
        f"{time.perf_counter() - t0:.2f} s (part (a) {lap()})")

    # (b) the hash lanes and the scores on the card
    log(f"beam_lm: {check_lm_on_card(full_lm)} ({lap()})")

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

    def timed(step):
        out = step(state, wav, length)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = step(state, wav, length)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        check_outputs(out, BEAM_B, t_enc)
        return out, times

    (beam_out, beam_times), n = counted(lambda: timed(beam_step))
    launches = add(launches, expect(n, reps + 1,
                                    f"{reps + 1} beam predict calls"))
    (greedy_out, greedy_times), n = counted(
        lambda: timed(trainer.predict_step))
    launches = add(launches, expect(n, reps + 1,
                                    f"{reps + 1} greedy predict calls"))
    beam_ms = statistics.median(beam_times) * 1e3
    greedy_ms = statistics.median(greedy_times) * 1e3
    lens = beam_out[1].cpu()
    if int((lens > 0).sum()) < BEAM_B // 2:
        raise AssertionError(f"the beam decoded {int((lens > 0).sum())} of "
                             f"{BEAM_B} rows to something")
    same_as_greedy = sum(
        beam_out[0][b, :int(lens[b])].tolist()
        == greedy_out[0][b, :int(greedy_out[1][b])].tolist()
        for b in range(BEAM_B))
    log(f"beam_lm: make_beam_predict_step f32 B={BEAM_B} x {BEAM_SECONDS} s "
        f"({t_enc} frames, W {BEAM_W}, K {BEAM_K}, order-3 LM over "
        f"{N_PHONE} phones at {BEAM_LM_WEIGHT}): {spread_ms(beam_times)}; "
        f"greedy predict_step {spread_ms(greedy_times)}; beam / greedy "
        f"{beam_ms / greedy_ms:.1f}x; best beams "
        f"{float(lens.float().mean()):.1f} phones a row on average, "
        f"{same_as_greedy} of {BEAM_B} rows equal to greedy [{CARD}]")
    busy = trace(lambda: beam_step(state, wav, length), 1,
                 f"beam_lm: make_beam_predict_step B={BEAM_B} [{CARD}]",
                 "call", 8)
    plain = trace(lambda: trainer.predict_step(state, wav, length), 1,
                  f"beam_lm: greedy predict_step B={BEAM_B} [{CARD}]",
                  "call", 4)
    extra = busy["launches"] - plain["launches"]
    log(f"beam_lm: the beam adds {extra:.0f} kernels and copies a call, "
        f"{extra / t_enc:.1f} a frame, "
        f"{(busy['wall_ms'] - plain['wall_ms']) / t_enc * 1e3:.1f} us a frame "
        f"by the host clock [{CARD}]")
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
        f"ids in {chars_equal} (part (c) {lap()})")
    if set(range(rows)) - set(step_rows) - tied:
        raise AssertionError("make_beam_predict_step differs from the CPU "
                             "away from a near-tie")
    del wav, beam_out, greedy_out, checked
    torch.cuda.empty_cache()

    # (d) cli.eval_am --lm on both devices
    common = ["--data_config", cli_data, "--model_config", model_yml,
              "--lm", lm_npz, "--max_batches", "2", "--log_level", "WARNING"]
    (card_json, _, err, t_card), n = counted(
        lambda: run_cli(eval_am.main, common + ["--device", "cuda"]))
    launches = add(launches, expect(n, 2, "eval_am --lm's 2 batches"))
    cpu_json, _, cpu_err, t_cpu = run_cli(eval_am.main,
                                          common + ["--device", "cpu"])
    if "no checkpoint found" in err + cpu_err:
        raise AssertionError("eval_am --lm did not restore the checkpoint")
    if card_json != cpu_json:
        raise AssertionError(f"eval_am --lm: card {card_json} vs CPU "
                             f"{cpu_json}")
    if card_json["phone_D"] >= card_json["phone_N"]:
        raise AssertionError(f"eval_am --lm decoded nothing: {card_json}")
    log(f"beam_lm: cli.eval_am --lm {os.path.basename(lm_npz)}, 2 batches: "
        f"the same JSON on the card ({t_card:.2f} s) and the CPU "
        f"({t_cpu:.2f} s): {json.dumps(card_json)} ({lap()})")

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
    phones, chars, beams, encodes, wall = served["out"]
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
        f"127.0.0.1 ({encodes} encodes, the beam on the host) in "
        f"{wall * 1e3:.3f} ms, {len(phones)} phones, {len(text)} chars, "
        f"against the in-process beam ASREngine on the CPU: {report} "
        f"({lap()}) [{CARD}]")
    del trainers, trainer, model, state, engine, ops
    torch.cuda.empty_cache()

    # (f) cli.train_asr with batches from worker processes
    with open(cli_data) as f:
        data = yaml.safe_load(f)
    rates = {}
    for procs in (2, 0):
        d = dict(data, running_config=dict(
            data["running_config"], log_interval_steps=3,
            save_interval_steps=1000, eval_interval_steps=1000,
            outdir=os.path.join(cli_dir, f"procs{procs}")))
        d_yml = os.path.join(cli_dir, f"data_procs{procs}.yml")
        with open(d_yml, "w") as f:
            yaml.safe_dump(d, f)
        (_, _, _, took), n = counted(lambda: run_cli(train_asr.main, [
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
        rates[procs] = (logged[0]["steps_per_s"], logged[0]["train_loss"],
                        took)
    log("beam_lm: cli.train_asr bf16, 3 steps of B=8: " + "; ".join(
        f"--data_procs {p}: {r[0]:.3f} steps/s over steps 1-3, train_loss "
        f"{r[1]:.3f}, {r[2]:.2f} s with start-up" for p, r in rates.items())
        + f" (the workers hide the card from themselves and check that "
        f"CUDA stayed uninitialised after every batch; {lap()}) [{CARD}]")
    log(f"beam_lm: K1 and K1b launched {launches}; phase "
        f"{laps[-1] - laps[0]:.2f} s")
    return launches


# ---------------------------------------------------------------------------
# LEAF and add_wav_info, export through torch.export, rnnt_loss
# ---------------------------------------------------------------------------

OPTION_B, OPTION_SECONDS = 128, 7.0          # predict_step, as phase_serve
OPTION_TRAIN_B = 32                          # x TRAIN_SECONDS (8 s)
OPTION_TRAIN_STEPS = 3                       # a warm step and 2 timed
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


def predict_times(model, wav, length, reps: int) -> list:
    """A checked warm ``predict_step``, then ``reps`` waited for (s)."""
    from tensorflowasr_tpu_torch.serve.engines import predict_step

    t_enc = -(-(-(-wav.shape[1] // 160)) // 4)
    out = predict_step(model, wav, length)
    torch.cuda.synchronize()
    check_outputs(out, wav.shape[0], t_enc)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = predict_step(model, wav, length)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    check_outputs(out, wav.shape[0], t_enc)
    return times


def module_shares(model, wav, length, modules: dict) -> dict:
    """CUDA-event ms of each module in ``modules`` (name -> submodule)
    inside one ``predict_step``, beside the step's own ms."""
    from tensorflowasr_tpu_torch.serve.engines import predict_step

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    spans, hooks = {}, []

    def enter(name):
        def hook(mod, args):
            spans[name] = [event()]
        return hook

    def leave(name):
        def hook(mod, args, out):
            spans[name].append(event())
        return hook

    for name, m in modules.items():
        hooks.append(m.register_forward_pre_hook(enter(name)))
        hooks.append(m.register_forward_hook(leave(name)))
    try:
        start = event()
        predict_step(model, wav, length)
        end = event()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    out = {name: round(a.elapsed_time(b), 4) for name, (a, b) in
           spans.items()}
    out["predict_step"] = round(start.elapsed_time(end), 4)
    return out


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


def option_part(option: dict, what: str, plain, reps: int) -> tuple:
    """(a) / (b): ``predict_step`` f32 at B = 128 x 7 s, median of
    ``reps``, in turns with the plain ConformerCTC(S) ``plain``; the
    modules' share of one step; 3 train steps at B = 32 x 8 s; the card
    against the CPU; with LEAF a trace of one predict and one train step.
    Returns K1's and K1b's launches in the predict and train calls (one
    each a call with ``add_wav_info``, none with LEAF)."""
    from tensorflowasr_tpu_torch.serve.engines import predict_step
    from tensorflowasr_tpu_torch.utils.profiling import trace

    dev = torch.device("cuda")
    trainer = option_trainer(option, "cuda")
    model, cfg = trainer.state.model.eval(), trainer.model_cfg
    if (cfg.dmodel, cfg.num_blocks) != (144, 13) or any(
            getattr(cfg, k) != v for k, v in option.items()):
        raise AssertionError(f"not the full-width {what} config: {cfg}")
    wav, length = batch_inputs(OPTION_B, OPTION_SECONDS, dev)
    torch.cuda.reset_peak_memory_stats()
    plain_times = predict_times(plain, wav, length, reps)
    times, n_pred = counted(lambda: predict_times(model, wav, length, reps))
    plain_times += predict_times(plain, wav, length, reps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step, base = statistics.median(times), statistics.median(plain_times)
    log(f"leaf_wav_export: {what} predict_step f32 B={OPTION_B} x "
        f"{OPTION_SECONDS} s: median {step * 1e3:.3f} ms (min "
        f"{min(times) * 1e3:.3f}) against the plain ConformerCTC(S)'s "
        f"{base * 1e3:.3f} ms (min {min(plain_times) * 1e3:.3f}; {reps} "
        f"calls before and {reps} after), {step / base:.2f}x; per-stream "
        f"RTF {step / (OPTION_B * OPTION_SECONDS):.3e}; peak memory "
        f"{peak:.2f} GiB [{CARD}]")
    enc = model.encoder
    modules = ({"wav_layer": enc.wav_layer} if enc.wav_layer is not None
               else {"leaf": enc.mel_layer.leaf,
                     "PCEN": enc.mel_layer.leaf.pcen})
    shares = module_shares(model, wav, length, modules)
    log(f"leaf_wav_export: {what} CUDA-event ms in one predict_step: "
        f"{json.dumps(shares)}; "
        + ", ".join(f"{name} {shares[name] / shares['predict_step']:.1%}"
                    for name in modules) + f" of the step [{CARD}]")
    leaf = enc.wav_layer is None
    if leaf:
        trace(lambda: predict_step(model, wav, length), 1,
              f"leaf_wav_export: leaf predict_step f32 B={OPTION_B} x "
              f"{OPTION_SECONDS} s [{CARD}]", "call", 6)
    del wav, length

    numpy_batch = train_batch(OPTION_TRAIN_B, TRAIN_SECONDS, TRAIN_PHONES,
                              TRAIN_CHARS)
    batch = trainer._prepare_batch(numpy_batch)
    torch.cuda.reset_peak_memory_stats()
    (med, low, losses), n_train = counted(lambda: timed_steps(
        trainer.train_step, trainer.state, batch, OPTION_TRAIN_STEPS - 1))
    audio_s = OPTION_TRAIN_B * TRAIN_SECONDS
    log(f"leaf_wav_export: {what} train_step f32 B={OPTION_TRAIN_B} x "
        f"{TRAIN_SECONDS} s, dropout {cfg.dropout}: median {med:.3f} ms "
        f"(min {low:.3f}; {OPTION_TRAIN_STEPS - 1} steps after a warm one, "
        f"each waited for), {audio_s / med * 1e3:.1f} audio s/s, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"train_loss {' -> '.join(f'{v:.4f}' for v in losses)} [{CARD}]")
    if leaf:
        trace(lambda: trainer.train_step(trainer.state, batch), 1,
              f"leaf_wav_export: leaf train_step f32 B={OPTION_TRAIN_B} x "
              f"{TRAIN_SECONDS} s [{CARD}]", "step", 6)
    del trainer, model, batch
    torch.cuda.empty_cache()
    option_card_vs_cpu(option, what)
    return add(n_pred, n_train), reps + 1 + OPTION_TRAIN_STEPS


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
    t0 = time.perf_counter()
    exporter.export_offline_asr(model, out_dir)          # B=1 x 7 s, U 64
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    graphs = exporter.load_exported(out_dir)
    t_load = time.perf_counter() - t0
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
        f"ConformerCTC(S) checkpoint on the card in {t_export:.2f} s, "
        f"load_exported {t_load:.2f} s; the encoder graph holds "
        f"{nodes['encoder']}; loaded vs eager at B=1 x 7 s: max|err| "
        f"encoder {errs[0]:.3e}, ctc_model {errs[1]:.3e}, translator "
        f"{errs[2]:.3e}; K1 and K1b launched {n_enc} by one encoder call")

    # chunk: picker and decoder threaded over EXPORT_CHUNKS chunks
    out_dir = os.path.join(chunk_dir, "export_chunk")
    t0 = time.perf_counter()
    exporter.export_chunk_streaming(cmodel, out_dir,
                                    decoder_step=EXPORT_DECODER_STEP)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    graphs = exporter.load_exported(out_dir)
    t_load = time.perf_counter() - t0
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
        f"ChunkConformer(S) checkpoint on the card in {t_export:.2f} s, "
        f"load_exported {t_load:.2f} s; the picker graph holds "
        f"{nodes['picker']}; {EXPORT_CHUNKS} chunks threaded through the "
        f"loaded picker ({len(pk_keys)} caches) and decoder ({len(dec_keys)}"
        f" caches) vs eager: max|err| picker {worst:.3e} (logits, hidden, "
        f"caches; n_final equal), decoder {dworst:.3e}; K1 and K1b launched "
        f"{n_pick} by {EXPORT_CHUNKS} picker calls")
    return launches, 1 + EXPORT_CHUNKS


def rnnt_part() -> None:
    """(d): ``rnnt_loss`` and its gradient on the card against the CPU, the
    card's time a call (forward and backward) and one trace of it."""
    from tensorflowasr_tpu_torch.ops.rnnt import rnnt_loss
    from tensorflowasr_tpu_torch.utils.profiling import trace

    b, t, u, v = RNNT_SHAPE
    rng = np.random.default_rng(80)
    logits = rng.standard_normal((b, t, u + 1, v)).astype(np.float32)
    labels = torch.from_numpy(rng.integers(1, v, (b, u)).astype(np.int64))
    t_lens = torch.tensor([200, 180, 150, 200, 120, 199, 60, 1])
    u_lens = torch.tensor([40, 35, 20, 40, 30, 39, 10, 0])
    result, times = {}, []
    for device in ("cuda", "cpu"):
        for _ in range(4 if device == "cuda" else 1):
            x = torch.from_numpy(logits).to(device).requires_grad_()
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = rnnt_loss(x, labels.to(device), t_lens.to(device),
                             u_lens.to(device))
            loss.sum().backward()
            if device == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        result[device] = (loss.detach().cpu(), x.grad.cpu())
    loss_err = within(result["cuda"][0], result["cpu"][0], rtol=1e-4,
                      atol=0)
    scale = float(result["cpu"][1].abs().max())
    grad_err = within(result["cuda"][1], result["cpu"][1], rtol=0,
                      atol=1e-4 * scale)
    card = times[1:4]
    x = torch.from_numpy(logits).to("cuda").requires_grad_()
    args = [a.to("cuda") for a in (labels, t_lens, u_lens)]
    trace(lambda: rnnt_loss(x, *args).sum().backward(), 1,
          f"leaf_wav_export: rnnt_loss forward + backward [{CARD}]", "call",
          4)
    log(f"leaf_wav_export: rnnt_loss [B, T, U+1, V] = [{b}, {t}, {u + 1}, "
        f"{v}] card vs CPU: loss max|err| {loss_err:.3e} (losses "
        f"{float(result['cpu'][0].min()):.2f}-"
        f"{float(result['cpu'][0].max()):.2f}, within 1e-4 relative), "
        f"gradient max|err| {grad_err:.3e} (within 1e-4 of its largest "
        f"entry {scale:.3e}); forward + backward on the card median "
        f"{statistics.median(card) * 1e3:.3f} ms (min {min(card) * 1e3:.3f};"
        f" {t + u} anti-diagonals) [{CARD}]")


def phase_leaf_wav_export(cli_dir: str, chunk_dir: str,
                          reps: int = 5) -> tuple:
    """(a) ``add_wav_info: true`` and (b) ``mel_layer_type: leaf`` on the
    full-width ConformerCTC(S); (c) the offline and chunk export round trip
    on the card; (d) ``rnnt_loss``. K1 and K1b are counted exactly: once a
    predict, train and exported encoder or picker call with add_wav_info
    and in the exported graphs, never on the LEAF branch. Returns the
    launches of (a) and (c), and those of the exported graphs alone."""
    from tensorflowasr_tpu_torch.models.conformer import (
        ConformerConfig,
        build_model,
    )

    t_phase = time.perf_counter()
    plain = build_model(ConformerConfig(), N_PHONE, N_CHAR, device="cuda",
                        seed=0)
    n, calls = option_part({"add_wav_info": True}, "add_wav_info", plain,
                           reps)
    launches = expect(n, calls, f"{calls} add_wav_info predict and train "
                                f"calls")
    n, leaf_calls = option_part({"mel_layer_type": "leaf"}, "leaf", plain,
                                reps)
    if n != (0, 0):
        raise AssertionError(f"the LEAF branch launched K1 and K1b {n}")
    del plain
    torch.cuda.empty_cache()
    exported, calls = export_part(cli_dir, chunk_dir)
    expect(exported, calls, "the exported graphs' encoder and picker calls")
    rnnt_part()
    log(f"leaf_wav_export: K1 and K1b launched {add(launches, exported)} "
        f"({launches} with add_wav_info, {exported} in the loaded graphs, "
        f"(0, 0) in the LEAF branch's {leaf_calls} predict and train "
        f"calls); phase {time.perf_counter() - t_phase:.2f} s")
    return add(launches, exported), exported


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
    ``torchrun --nproc_per_node 2`` (gloo, cuda:0) on phase 7's kind of
    corpus, then a one-process ``eval_am`` restoring its checkpoint; (d) one
    process at world size 1 on the default backend (NCCL) taking a step.
    Returns K1's and K1b's launches: the ranks' (each counts its own and
    sends them back), the one-process runs' and eval_am's."""
    from tensorflowasr_tpu_torch.cli import eval_am
    from tensorflowasr_tpu_torch.parallel import step_check
    from tensorflowasr_tpu_torch.serve.bench_chunk import (
        calibrate,
        shipped_chunk_config,
    )
    from tensorflowasr_tpu_torch.train.bench_chunk_batch import (
        CALIBRATION_ROWS,
        bench_wav,
    )
    from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer

    t_phase = time.perf_counter()
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
    chunk = ChunkTrainer(shipped_chunk_config(), N_PHONE, N_CHAR,
                         device="cuda", compute_dtype="float32")
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
    times = {"ctc": (statistics.median(
        max(r["step_s"][i] for r in ranks)
        for i in range(1, PARALLEL_STEPS)), one["step_s"][-1])}
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
    times["chunk"] = (statistics.median(
        max(r["step_s"][i] for r in cranks)
        for i in range(1, PARALLEL_STEPS)), cone["step_s"][-1])

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
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "tensorflowasr_tpu_torch.cli.train_asr", "--data_config", data_yml,
         "--model_config", model_yml, "--device", "cuda:0",
         "--dist_backend", "gloo", "--total_steps", "6", "--data_workers",
         "2"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=root), cwd=cli_dir)
    t_cli = time.perf_counter() - t0
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
        f"ranks on cuda:0, bf16, global B={CLI_B}) 6 steps in {t_cli:.2f} s "
        f"(train_loss {logged[0]['train_loss']:.3f} -> "
        f"{logged[-1]['train_loss']:.3f}, {logged[-1]['examples_per_s']:.1f} "
        f"utterances/s), checkpoints {ckpts}; one-process eval_am restored "
        f"step 6: {json.dumps(result)}")
    for name, (two, alone) in times.items():
        log(f"parallel: {name} f32 step at B={PARALLEL_B} x {TRAIN_SECONDS} s"
            f": 2 ranks {two * 1e3:.3f} ms, one process {alone * 1e3:.3f} ms "
            f"on {CARD}; the two ranks share one card, so this is not a "
            f"scaling figure")
    log(f"parallel: K1 and K1b launched {launches} (ranks' and one-process "
        f"train steps, eval_am); phase {time.perf_counter() - t_phase:.2f} s")
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

    t_phase = time.perf_counter()

    def run():
        quick = headtohead.quick(work, "cuda")
        t0 = time.perf_counter()
        cold = headtohead.evaluate(
            untrained_config(quick["data_yml"], quick["model_yml"],
                             os.path.join(work, "untrained")),
            quick["model_yml"], "cuda")
        return quick, cold, time.perf_counter() - t0

    (quick, cold, t_cold), launches = counted(run)
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
    log(f"headtohead_quick: {CARD}; corpus + prepare "
        f"{quick['corpus_s']:.2f} s, train_asr {steps} steps at B={batch} "
        f"{quick['train_s']:.2f} s ({steps / quick['train_s']:.3f} steps/s "
        f"with start-up; {logged[-1]['steps_per_s']:.3f} over the last "
        f"100), train_loss {logged[0]['train_loss']:.3f} -> "
        f"{logged[-1]['train_loss']:.3f}, eval_am {quick['eval_s']:.2f} s, "
        f"parameters on {devices}")
    log(f"headtohead_quick: phone CER {result['phone_cer']:.4f} (JAX "
        f"{JAX_QUICK_PHONE_CER}, bound {QUICK_PHONE_CER_MAX:.4f}), char CER "
        f"{result['char_cer']:.4f} (JAX {JAX_QUICK_CHAR_CER}, bound "
        f"{QUICK_CHAR_CER_MAX:.4f}): {json.dumps(result)}")
    log(f"headtohead_quick: untrained checkpoint phone CER "
        f"{cold['phone_cer']:.4f}, char CER {cold['char_cer']:.4f} "
        f"(eval_am {t_cold:.2f} s): {json.dumps(cold)}")
    if not (result["phone_cer"] <= QUICK_PHONE_CER_MAX
            and result["char_cer"] <= QUICK_CHAR_CER_MAX):
        raise AssertionError("headtohead_quick: the trained model misses "
                             "the bounds")
    if cold["phone_cer"] <= QUICK_PHONE_CER_MAX \
            or cold["char_cer"] <= QUICK_CHAR_CER_MAX:
        raise AssertionError("headtohead_quick: the bounds do not reject "
                             "the untrained checkpoint")
    log(f"headtohead_quick: K1 and K1b launched {launches}; phase "
        f"{time.perf_counter() - t_phase:.2f} s")
    return launches


def main() -> int:
    name = phase_device()
    phase_build()
    k1 = phase_kernel()
    rel_attention = phase_rel_attention()
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
        k1_chunk = phase_chunk_kernel()
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
        block, block_predict = phase_block_stream()
        torch.cuda.empty_cache()
        leaf_wav, exported = phase_leaf_wav_export(cli_dir, chunk_dir)
        torch.cuda.empty_cache()
        parallel_dir = os.path.join(work, "parallel")
        os.makedirs(parallel_dir)
        parallel = phase_parallel(parallel_dir)
        torch.cuda.empty_cache()
        quick_dir = os.path.join(work, "headtohead")
        os.makedirs(quick_dir)
        quick = phase_headtohead_quick(quick_dir)
    phases = {"predict_step calls": batched, "session's requests": requested,
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
        # through the tasr:: ops of programs saved by torch.export and
        # loaded back: one exported encoder call and the picker's chunks
        "exported_graph_launches": exported[0],
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
        # the block-streaming fold; launches are its predict_step calls
        "block_stream_shape": dict(k1["log_mel"]["block_stream"],
                                   launches=block_predict[1]),
        # B=128 x 7 s with a given (trainable) matrix: K1 + dense_mel_kernel
        "given_matrix": k1["log_mel"]["given_matrix"],
        "valid_shapes": {key: dict(k1_chunk["log_mel"][key],
                                   launches=chunk[key][1])
                         for key in k1_chunk["log_mel"]},
        "exported_graph_launches": exported[1],
    }
    log(json.dumps({"kernels": [entry, log_mel, rel_attention]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
