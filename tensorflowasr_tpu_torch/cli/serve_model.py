"""The model server: the socket front that the C++ serving host talks to.

    python -m tensorflowasr_tpu_torch.cli.serve_model --data_config D.yml \\
        --model_config configs/conformerS.yml [--socket PATH | --port 8502] \\
        [--chunk_data_config D.yml \\
         --chunk_model_config configs/chunk_conformerS.yml \\
         --stream_slots 16 --stream_wait_ms 8] \\
        [--vad_data_config configs/vad_data.yml \\
         --vad_model_config configs/vad_model.yml] \\
        [--beam_width W | --lm LM.npz|LM.arpa [--lm_weight 0.3]] \
        [--device cuda|cpu] [--compute_dtype float32|bfloat16]

Counterpart of ``tensorflowasr_tpu/cli/serve_model.py``. Restores the newest
``CTCTrainer`` checkpoint under the data config's ``running_config.outdir``
(a warning on stderr and a seeded random init when there is none), serves
the tensor ops of ``serve/model_server.py`` (vad / encode / ctc_logits /
translate / info) and, with the chunk configs, the multi-stream chunk ops
(stream_info/open/feed/result/close) of a ``ChunkTrainer`` checkpoint over a
slot pool, on a unix socket or a TCP port of 127.0.0.1, until interrupted.
With both VAD configs the ``vad`` op is a ``VADEngine`` over the newest VAD
checkpoint under the VAD data config's outdir (a warning and a seeded random
init when there is none); without them it is the energy gate.
Every op is warmed on the main thread before the server starts; then it
prints ``model server ready on <endpoint>`` and runs the offline ops on the
main thread. ``fused_decoder`` comes from the chunk model config.
``--beam_width`` > 0 makes the ``ASREngine`` decode with the CTC prefix beam
search, and ``--lm`` (an ``.npz`` from ``cli.train_lm`` or an ARPA text file
over the phone vocabulary; it implies ``--beam_width 8``) fuses that LM on
the serving device; ``build_ops`` warms the engine's phone decode with the
ops.
As in the JAX package, no op of the table decodes (a client decodes from
``ctc_logits``), so the served ops answer the same with and without them.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tensorflowasr_tpu_torch.cli.common import (
    build_featurizers,
    config_parser,
    load_config,
)

logger = logging.getLogger(__name__)


def build_chunk_stream_ops(chunk_data_config: str, chunk_model_config: str,
                           n_slots: int = 8, max_wait_ms: float = 8.0,
                           compute_dtype: str = "float32",
                           device: str = "cuda"):
    """Restore the newest ChunkConformer checkpoint and build the
    multi-stream op table. Returns (ops, BatchingStreamFront); the ops run
    on the connection threads (``ModelServer.inline_ops``). Warms the pool's
    step on the calling thread with ``advance`` all False, which leaves the
    slots' state as it was."""
    from tensorflowasr_tpu_torch.serve.chunk_session import packed_step
    from tensorflowasr_tpu_torch.serve.multi_session import (
        BatchingStreamFront,
        MultiStreamChunkServer,
        build_stream_ops,
    )
    from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    ccfg = UserConfig(chunk_data_config, chunk_model_config)
    phone_f, char_f = build_featurizers(ccfg)[:2]
    trainer = ChunkTrainer(ccfg, phone_f.num_classes, char_f.num_classes,
                           device=device, compute_dtype=compute_dtype)
    trainer.init_state()
    if not trainer.restore():
        print(f"warning: no chunk ASR checkpoint under {trainer.outdir}; "
              f"streaming with random init", file=sys.stderr)
    model = trainer.state.model.eval()
    server = MultiStreamChunkServer(model, n_slots=n_slots,
                                    phone_featurizer=phone_f,
                                    text_featurizer=char_f, device=device)
    logger.info("warming the %d-slot stream tick...", n_slots)
    dev = server.device
    idle = torch.zeros((n_slots,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        packed_step(model, torch.zeros((n_slots, model.cfg.chunk_samples),
                                       device=dev), server.caches, idle, idle)
    front = BatchingStreamFront(server, max_wait_ms=max_wait_ms)
    return build_stream_ops(front), front


def build_vad_engine(vad_data_config: str, vad_model_config: str,
                     device: str = "cuda"):
    """A ``VADEngine`` over the newest checkpoint under the VAD data
    config's ``running_config.outdir`` (``cli/common.py::restore_or_warn``:
    a warning on stderr and the seeded init when there is none)."""
    from tensorflowasr_tpu_torch.cli.common import (
        build_vad_model,
        restore_or_warn,
    )
    from tensorflowasr_tpu_torch.serve.engines import VADEngine
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    vcfg = UserConfig(vad_data_config, vad_model_config)
    model, state = build_vad_model(vcfg, device)
    restore_or_warn(state, vcfg.section("running_config")["outdir"], "VAD")
    return VADEngine(model, device=device)


def parser() -> argparse.ArgumentParser:
    p = config_parser(__doc__)
    p.add_argument("--socket", default=None,
                   help="unix socket path (default: TCP)")
    p.add_argument("--port", type=int, default=8502)
    p.add_argument("--vad_data_config", default=None,
                   help="with --vad_model_config: answer the vad op with "
                        "the VAD model restored from this config's outdir")
    p.add_argument("--vad_model_config", default=None)
    p.add_argument("--chunk_data_config", default=None,
                   help="with --chunk_model_config: also serve multi-stream "
                        "chunk ASR (stream_open/feed/result/close ops)")
    p.add_argument("--chunk_model_config", default=None)
    p.add_argument("--stream_slots", type=int, default=8,
                   help="concurrent chunk-stream slot pool size")
    p.add_argument("--stream_wait_ms", type=float, default=8.0,
                   help="dynamic-batching coalescing window")
    p.add_argument("--beam_width", type=int, default=0,
                   help=">0: the engine decodes with the CTC prefix beam "
                        "search instead of greedy")
    p.add_argument("--lm", default=None,
                   help="phone n-gram LM for shallow fusion: .npz "
                        "(cli/train_lm) or .arpa (KenLM text); implies "
                        "--beam_width 8 if unset")
    p.add_argument("--lm_weight", type=float, default=0.3)
    return p


def build_ops(args) -> Tuple[Dict, set, Optional[object]]:
    """Everything ``main`` serves, restored and warmed on the calling
    thread: returns (ops, the ops to run on connection threads, the chunk
    streams' BatchingStreamFront or None)."""
    from tensorflowasr_tpu_torch.serve.engines import ASREngine
    from tensorflowasr_tpu_torch.serve.model_server import build_asr_ops
    from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer

    config = load_config(args)
    phone_f, char_f = build_featurizers(config)[:2]
    trainer = CTCTrainer(config, phone_f.num_classes, char_f.num_classes,
                         blank_id=phone_f.blank, device=args.device,
                         compute_dtype=args.compute_dtype)
    trainer.init_state()
    if not trainer.restore():
        print(f"warning: no ASR checkpoint under {trainer.outdir}; serving "
              f"random init", file=sys.stderr)
    ngram, beam_width = None, args.beam_width
    if args.lm:
        from tensorflowasr_tpu_torch.utils.ngram_lm import NGramLM, lm_pack

        host_lm = (NGramLM.from_arpa(args.lm, phone_f.token_to_index,
                                     phone_f.num_classes)
                   if args.lm.endswith(".arpa") else NGramLM.load(args.lm))
        ngram = lm_pack(host_lm, trainer.device)
        beam_width = beam_width or 8
    asr_engine = ASREngine(trainer.state.model.eval(),
                           sample_rate=trainer.sample_rate,
                           text_featurizer=char_f, phone_featurizer=phone_f,
                           beam_width=beam_width, ngram_lm=ngram,
                           lm_weight=args.lm_weight)
    vad_engine = None
    if args.vad_data_config and args.vad_model_config:
        vad_engine = build_vad_engine(args.vad_data_config,
                                      args.vad_model_config, args.device)
    ops = build_asr_ops(asr_engine, vad_engine)

    logger.info("warming up ops...")
    enc = ops["encode"](np.zeros((1, asr_engine.chunk_samples), np.float32))
    ops["translate"](np.zeros((1, 8), np.int32), enc)
    logger.info("encode %s, ctc_logits %s", enc.shape,
                ops["ctc_logits"](enc).shape)
    asr_engine.decode_phones([enc])
    vad_frame = vad_engine.frame_input if vad_engine is not None else 80
    ops["vad"](np.zeros((1, 10, vad_frame), np.float32))

    inline_ops, front = set(), None
    if args.chunk_data_config and args.chunk_model_config:
        stream_ops, front = build_chunk_stream_ops(
            args.chunk_data_config, args.chunk_model_config,
            n_slots=args.stream_slots, max_wait_ms=args.stream_wait_ms,
            compute_dtype=args.compute_dtype, device=args.device)
        ops.update(stream_ops)
        inline_ops = set(stream_ops)
    logger.info("warmup done")
    return ops, inline_ops, front


def main(argv=None) -> int:
    from tensorflowasr_tpu_torch.serve.model_server import ModelServer

    args = parser().parse_args(argv)
    ops, inline_ops, front = build_ops(args)
    server = ModelServer(ops, unix_path=args.socket,
                         tcp_port=None if args.socket else args.port,
                         inline_exec=False, inline_ops=inline_ops)
    server.start()
    endpoint = args.socket or f"127.0.0.1:{server.tcp_port}"
    print(f"model server ready on {endpoint}", flush=True)
    try:
        server.run_worker_loop()
    except KeyboardInterrupt:
        server.stop()
    finally:
        if front is not None:
            front.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
