"""Chunk-streaming decode of one wav: offline, then streamed through
``ChunkStreamSession``, both printed, with the per-chunk time and the RTF.

    python -m tensorflowasr_tpu_torch.cli.test_chunk_asr \\
        --data_config D.yml --model_config configs/chunk_conformerS.yml \\
        --wav utt.wav [--weights W.npz] [--export_native DIR] \\
        [--device cuda|cpu] [--compute_dtype float32|bfloat16]

Without ``--weights`` the model is the trainer's (``ChunkTrainer`` from the
configs) restored from the newest checkpoint under
``running_config.outdir``/checkpoints, which ``cli.train_asr`` writes; with
none there it decodes a seeded random init and says so on stderr.
``--weights`` takes precedence: a ``.npz`` of the flattened flax variables
of a trained JAX ``ChunkConformer`` (keys ``params/encoder/block_0/...`` or
the scanned ``params/encoder/block/...``, and ``batch_stats/...``), loaded
through ``models/convert.py``. The two decodes agree: streaming from a cold
start equals the offline path. ``--export_native DIR`` also writes the
model's artifact for the standalone C++ chunk engine (``cpp/serving``
``asr_chunk``; ``export/native_export.py``) with copies of the two
vocabularies. ``--export_savedmodel`` (the TF SavedModel pair) is not ported
and raises.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from tensorflowasr_tpu_torch.cli.common import (
    build_featurizers,
    config_parser,
    load_config,
)
from tensorflowasr_tpu_torch.models.chunk_conformer import ChunkConformer
from tensorflowasr_tpu_torch.models.convert import load_npz, num_classes
from tensorflowasr_tpu_torch.serve.chunk_session import ChunkStreamSession
from tensorflowasr_tpu_torch.train.chunk_trainer import (
    ChunkTrainer,
    make_chunk_predict_step,
)
from tensorflowasr_tpu_torch.utils.audio import read_wav
from tensorflowasr_tpu_torch.utils.device import resolve_device


def main(argv=None) -> int:
    parser = config_parser(__doc__)
    parser.add_argument("--wav", required=True, help="wav file to decode")
    parser.add_argument("--weights", default=None, metavar="NPZ",
                        help="flattened flax variables to decode with")
    parser.add_argument("--export_native", default=None, metavar="DIR",
                        help="also write the raw-tensor artifact for the "
                             "standalone C++ chunk-streaming engine "
                             "(cpp/serving asr_chunk) to DIR")
    parser.add_argument("--export_savedmodel", default=None, metavar="DIR",
                        help="not ported (needs TF)")
    args = parser.parse_args(argv)
    if args.export_savedmodel:
        raise NotImplementedError(
            "--export_savedmodel (the TF SavedModel pair through jax2tf) is "
            "not ported")
    config = load_config(args)
    device = resolve_device(args.device)
    phone_f, char_f = build_featurizers(config)[:2]
    want = (phone_f.num_classes, char_f.num_classes)

    trainer = ChunkTrainer(config, *want, device=device,
                           compute_dtype=args.compute_dtype)
    cfg = trainer.model_cfg
    if args.weights:
        state = load_npz(args.weights, cfg)
        if num_classes(state) != want:
            raise ValueError(f"--weights has (phone, char) classes "
                             f"{num_classes(state)}, the vocabularies {want}")
        model = ChunkConformer(cfg, *want)
        model.load_state_dict(state)
        model = model.to(device).eval()
    else:
        trainer.init_state()
        if not trainer.restore():
            print("warning: no checkpoint found; decoding with random init",
                  file=sys.stderr)
        model = trainer.state.model.eval()

    if args.export_native:
        from tensorflowasr_tpu_torch.export.native_export import (
            export_native_chunk,
        )

        export_native_chunk(
            model, args.export_native,
            phone_vocab=config.section("inp_config")["vocabulary"],
            char_vocab=config.section("tar_config")["vocabulary"])
        print(f"native chunk artifact written to {args.export_native}")

    wav, _ = read_wav(args.wav, target_sr=cfg.sample_rate)
    cs = cfg.chunk_samples
    n_chunks = max(1, -(-len(wav) // cs))
    padded = np.zeros((n_chunks * cs,), np.float32)
    padded[:len(wav)] = wav
    audio_s = len(wav) / cfg.sample_rate

    # offline
    step = make_chunk_predict_step(model, None, trainer.txt_ctc_length)
    wav_t = torch.from_numpy(padded[None]).to(device)
    len_t = torch.tensor([n_chunks * cfg.sub_length], dtype=torch.int32,
                         device=device)
    step(wav_t, len_t)                                     # warm-up
    t0 = time.perf_counter()
    char_ids, char_lens, ph_ids, ph_lens = (
        x.cpu().numpy() for x in step(wav_t, len_t))
    offline_s = time.perf_counter() - t0
    print("offline phones:", " ".join(phone_f.iextract(
        ph_ids[0, :ph_lens[0]].tolist())))
    print("offline chars :", "".join(char_f.iextract(
        char_ids[0, :char_lens[0]].tolist())))

    # streaming
    session = ChunkStreamSession(model, phone_featurizer=phone_f,
                                 text_featurizer=char_f, device=device)
    session.feed(padded[:cs])                              # warm-up
    session.reset()
    chunk_ms = []
    for i in range(n_chunks):
        t0 = time.perf_counter()
        session.feed(padded[i * cs:(i + 1) * cs])
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    out = session.flush()
    stream_s = sum(chunk_ms) / 1e3
    audio_s = max(audio_s, 1e-9)
    print("stream  phones:", " ".join(out["phones"]))
    print("stream  chars :", out["text"])
    print(f"audio {audio_s:.2f}s offline {offline_s * 1e3:.1f}ms (RTF "
          f"{offline_s / audio_s:.4f}); stream {stream_s * 1e3:.1f}ms RTF "
          f"{stream_s / audio_s:.4f}, per {cs * 1e3 / cfg.sample_rate:.0f} "
          f"ms chunk mean {np.mean(chunk_ms):.2f}ms max "
          f"{np.max(chunk_ms):.2f}ms on {device}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
