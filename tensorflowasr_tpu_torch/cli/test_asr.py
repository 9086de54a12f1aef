"""Single-wav offline decode with per-stage timing.

    python -m tensorflowasr_tpu_torch.cli.test_asr --data_config D.yml \\
        --model_config M.yml --wav utt.wav [--weights W.npz] \\
        [--export_native DIR] [--device cuda|cpu] \\
        [--compute_dtype float32|bfloat16]

Without ``--weights`` the model is the trainer's (``CTCTrainer`` from the
configs) restored from the newest checkpoint under
``running_config.outdir``/checkpoints, which ``cli.train_asr`` writes; with
none there it decodes a seeded random init and says so on stderr.
``--weights`` takes precedence: a ``.npz`` of the flattened flax variables
of a trained JAX ``ConformerCTC`` (keys ``params/encoder/.../kernel`` and
``batch_stats/...``, the names ``native_export._flatten`` writes), loaded
through ``models/convert.py``. ``--export_native DIR`` also writes the
model's artifact for the standalone C++ engine (``cpp/serving``
``asr_offline``; ``export/native_export.py``) with copies of the two
vocabularies. ``--export_savedmodel`` (TF SavedModels) is not ported and
raises.

With ``speech_config.streaming: true`` the model is the block-streaming
ConformerCTC. The wav is padded only to hop x reduction factor, as in the
JAX CLI, so its length must be a whole number of ``chunk_samples`` (7680 at
16 kHz and ``streaming_bucket`` 0.5): any other length raises ValueError in
the encoder, as it does in the JAX package.

``model_config.name: EBranchformerCTC`` decodes the trainer's checkpoint of
that model; it has no JAX counterpart, so ``--weights`` and
``--export_native`` raise ValueError for it.
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
    model_name,
)
from tensorflowasr_tpu_torch.models.conformer import (
    ConformerConfig,
    ConformerCTC,
)
from tensorflowasr_tpu_torch.models.convert import load_npz, num_classes
from tensorflowasr_tpu_torch.models.ebranchformer import NAME as EBRANCHFORMER
from tensorflowasr_tpu_torch.serve.engines import predict_step
from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer
from tensorflowasr_tpu_torch.utils.audio import SpeechFeaturizer
from tensorflowasr_tpu_torch.utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    parser = config_parser(__doc__)
    parser.add_argument("--wav", required=True, help="wav file to decode")
    parser.add_argument("--weights", default=None, metavar="NPZ",
                        help="flattened flax variables to decode with")
    parser.add_argument("--export_native", default=None, metavar="DIR",
                        help="also write the raw-tensor artifact for the "
                             "standalone C++ engine (cpp/serving "
                             "asr_offline) to DIR")
    parser.add_argument("--export_savedmodel", default=None, metavar="DIR",
                        help="not ported (needs TF)")
    parser.add_argument("--export_durations", default="2,4,6,8",
                        help="duration buckets (s) for the SavedModel "
                             "encoder signatures (read only with "
                             "--export_savedmodel)")
    args = parser.parse_args(argv)
    if args.export_savedmodel:
        raise NotImplementedError(
            "--export_savedmodel (TF SavedModels through jax2tf) is not "
            "ported")
    config = load_config(args)
    if model_name(config) == EBRANCHFORMER and (args.weights
                                                or args.export_native):
        raise ValueError(f"--weights and --export_native hold a JAX "
                         f"ConformerCTC's layout, which {EBRANCHFORMER} "
                         f"does not have")
    device = resolve_device(args.device)
    phone_f, char_f = build_featurizers(config)[:2]

    sf = SpeechFeaturizer(config["speech_config"] or {})
    wav = sf.load_wav(args.wav)
    dur = len(wav) / sf.sample_rate
    padded = sf.pad_signal(wav)
    peak = np.abs(padded).max()
    if peak > 0:
        padded = padded / peak
    # floor, as the training dataloader's input_length
    in_len = max(1, len(wav) // (sf.hop_size * sf.reduction_factor))

    want = (phone_f.num_classes, char_f.num_classes)
    if args.weights:
        cfg = ConformerConfig.from_user_config(config, args.compute_dtype)
        state = load_npz(args.weights, cfg)
        if num_classes(state) != want:
            raise ValueError(f"--weights has (phone, char) classes "
                             f"{num_classes(state)}, the vocabularies {want}")
        model = ConformerCTC(cfg, *want)
        model.load_state_dict(state)
        model = model.to(device).eval()
    else:
        trainer = CTCTrainer(config, *want, blank_id=phone_f.blank,
                             device=device, compute_dtype=args.compute_dtype)
        trainer.init_state()
        if not trainer.restore():
            print("warning: no checkpoint found; decoding with random init",
                  file=sys.stderr)
        model = trainer.state.model.eval()

    if args.export_native:
        from tensorflowasr_tpu_torch.export.native_export import (
            export_native,
        )

        export_native(model, args.export_native,
                      phone_vocab=config.section("inp_config")["vocabulary"],
                      char_vocab=config.section("tar_config")["vocabulary"])
        print(f"native artifact written to {args.export_native}")

    wav_t = torch.from_numpy(np.asarray(padded, np.float32)[None]).to(device)
    len_t = torch.tensor([in_len], dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    predict_step(model, wav_t, len_t)
    _sync(device)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    phone_ids, phone_lens, char_ids = predict_step(model, wav_t, len_t)
    _sync(device)
    decode_s = time.perf_counter() - t0

    n = int(phone_lens[0])
    phones = phone_f.iextract(phone_ids[0, :n].cpu().tolist())
    chars = []
    for v in char_ids[0].cpu().tolist():
        if v == 0 or v == char_f.endid():
            break
        chars.append(char_f.iextract(v))
    print("phones:", " ".join(phones))
    print("chars :", "".join(chars))
    print(f"audio {dur:.2f}s decode {decode_s * 1000:.1f}ms "
          f"RTF {decode_s / dur:.4f} on {device} (first call "
          f"{first_s:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
