"""Prepare AISHELL-1 for training: lists + vocabularies + phone map.

Counterpart of ``examples/aishell1/prepare.py``: one command from an
extracted AISHELL-1 directory (or the synthetic corpus of
``recipes/synthetic_mandarin.py``) to everything ``cli.train_asr`` /
``cli.eval_am`` need, with the same lists, vocabularies, phone map and
``am_data.yml`` as the JAX recipe for the same arguments:

  python -m tensorflowasr_tpu_torch.recipes.aishell1_prepare \\
      --data_dir /path/to/aishell1 --out_dir ./aishell1_work

Expects the standard layout:
  <data_dir>/transcript/aishell_transcript_v0.8.txt   (UTTID<SP>hanzi)
  <data_dir>/wav/{train,dev,test}/S*/<UTTID>.wav

Writes to --out_dir:
  train.list / dev.list / test.list   path<TAB>transcript
  pinyin2phone.map, phones.txt        via cli/make_pinyin_map (full rule
                                      table, superset of the reference's
                                      226-phone inventory)
  chars.txt                           corpus characters + <S>/</S>
  am_data.yml                         the data config over these files

Hanzi -> pinyin at train time needs pypinyin (or pass --lexicon here to
pre-convert transcripts to toned pinyin, in which case the lists carry
pinyin and am_data.yml sets transcripts_are_pinyin: true, or
--train_time_lexicon to keep hanzi and convert through a lexicon TSV).
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

from tensorflowasr_tpu_torch.cli.make_pinyin_map import main as make_pinyin_map
from tensorflowasr_tpu_torch.utils.text import PinyinConverter, only_chinese


def read_transcripts(path: str) -> dict:
    """UTTID -> hanzi text (spaces inside the text are dropped; AISHELL
    transcripts separate words with spaces)."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                out[parts[0]] = "".join(parts[1:])
    return out


def find_wavs(wav_root: str, split: str) -> dict:
    """UTTID -> wav path for one split subtree."""
    out = {}
    root = os.path.join(wav_root, split)
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.lower().endswith(".wav"):
                out[fn[:-4]] = os.path.join(dirpath, fn)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--transcript", default=None,
                   help="override transcript path (default: "
                        "<data_dir>/transcript/aishell_transcript_v0.8.txt)")
    p.add_argument("--lexicon", default=None,
                   help="char<TAB>pinyin TSV: pre-convert transcripts to "
                        "toned pinyin (no pypinyin needed at train time; "
                        "the translate target becomes pinyin tokens)")
    p.add_argument("--train_time_lexicon", default=None,
                   help="char<TAB>pinyin TSV consulted AT TRAIN TIME "
                        "(speech_config.pinyin_lexicon): transcripts stay "
                        "hanzi, the translate target stays characters — "
                        "the real AISHELL task without pypinyin")
    p.add_argument("--min_char_count", type=int, default=1)
    p.add_argument("--bucket_seconds", default=None,
                   help="comma list of duration-bucket caps (s), e.g. "
                        "'2,4,6,8'; match the corpus' duration "
                        "distribution — every batch pads to its bucket "
                        "cap, so a too-coarse grid wastes loader and "
                        "frontend work. Default: loader default (4,8,12,16)")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    tr_path = args.transcript or os.path.join(
        args.data_dir, "transcript", "aishell_transcript_v0.8.txt")
    transcripts = read_transcripts(tr_path)
    print(f"{len(transcripts)} transcripts from {tr_path}")

    pin = PinyinConverter(lexicon_path=args.lexicon) if args.lexicon \
        else None

    char_counts: collections.Counter = collections.Counter()
    for split in ("train", "dev", "test"):
        wavs = find_wavs(os.path.join(args.data_dir, "wav"), split)
        lines, missing = [], 0
        for utt, wp in sorted(wavs.items()):
            txt = transcripts.get(utt)
            if txt is None:
                missing += 1
                continue
            txt = only_chinese(txt)
            if not txt:
                missing += 1
                continue
            if pin is not None:
                # pre-converted lists: the translate target ("char") vocab
                # is the pinyin tokens (transcripts_are_pinyin convention)
                txt = " ".join(pin.convert(txt))
            if split == "train":
                char_counts.update(txt.split() if pin is not None
                                   else txt)
            lines.append(f"{wp}\t{txt}")
        out = os.path.join(args.out_dir, f"{split}.list")
        with open(out, "w", encoding="utf-8") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        print(f"{split}: {len(lines)} utts -> {out} "
              f"({missing} without transcript, skipped)")

    # phone inventory: full rule table (superset of the reference's
    # corpus-trimmed 226); deterministic, so AMs are comparable across runs
    make_pinyin_map(["--map_out",
                     os.path.join(args.out_dir, "pinyin2phone.map"),
                     "--phone_out", os.path.join(args.out_dir,
                                                 "phones.txt")])

    chars = [c for c, n in sorted(char_counts.items())
             if n >= args.min_char_count]
    chars_out = os.path.join(args.out_dir, "chars.txt")
    with open(chars_out, "w", encoding="utf-8") as f:
        f.write("\n".join(["<S>", "</S>"] + chars) + "\n")
    print(f"{len(chars) + 2} char tokens -> {chars_out}")

    cfg_out = os.path.join(args.out_dir, "am_data.yml")
    write_data_config(cfg_out, args.out_dir,
                      transcripts_are_pinyin=pin is not None,
                      pinyin_lexicon=args.train_time_lexicon,
                      bucket_seconds=args.bucket_seconds)
    print(f"data config -> {cfg_out}")
    print("train: python -m tensorflowasr_tpu_torch.cli.train_asr "
          f"--data_config {cfg_out} --model_config configs/conformerS.yml")
    return 0


def write_data_config(path: str, out_dir: str,
                      transcripts_are_pinyin: bool,
                      pinyin_lexicon: str = None,
                      bucket_seconds: str = None) -> None:
    """am_data.yml with absolute paths into out_dir; hyperparameters mirror
    the reference's aishell-1 50-epoch ConformerCTC(S) setup
    (asr/configs/am_data.yml + README.md:168-172)."""
    a = os.path.abspath
    lex_line = (f"\n  pinyin_lexicon: {a(pinyin_lexicon)}"
                if pinyin_lexicon else "")
    if bucket_seconds:
        caps = [float(s) for s in bucket_seconds.split(",")]
        lex_line += f"\n  bucket_seconds: {caps}"
    yml = f"""# generated by tensorflowasr_tpu_torch/recipes/aishell1_prepare.py
speech_config:
  mel_layer_type: Melspectrogram
  mel_layer_trainable: false
  add_wav_info: false
  sample_rate: 16000
  frame_ms: 25
  stride_ms: 10
  num_feature_bins: 80
  reduction_factor: 4
  train_list: {a(os.path.join(out_dir, 'train.list'))}
  eval_list: {a(os.path.join(out_dir, 'dev.list'))}
  wav_max_duration: 16
  only_chinese: {'false' if transcripts_are_pinyin else 'true'}
  streaming: false
  streaming_bucket: 0.5
  pinyin_map: {a(os.path.join(out_dir, 'pinyin2phone.map'))}
  transcripts_are_pinyin: {'true' if transcripts_are_pinyin else 'false'}{lex_line}

inp_config:
  vocabulary: {a(os.path.join(out_dir, 'phones.txt'))}
  blank_at_zero: false
  beam_width: 1

tar_config:
  vocabulary: {a(os.path.join(out_dir, 'chars.txt'))}
  blank_at_zero: false
  beam_width: 1

augments_config:
  spec_aug:
    active: true
    window: 10
    ratio: 0.5

optimizer_config:
  lr: 0.0001
  warmup_steps: 10000
  beta1: 0.9
  beta2: 0.98
  epsilon: 0.000001

running_config:
  batch_size: 128
  num_epochs: 50             # reference README.md:168-172 aishell-1 setup
  outdir: {a(os.path.join(out_dir, 'ctc_offline-logs'))}
  log_interval_steps: 300
  eval_interval_steps: 500
  save_interval_steps: 500
"""
    with open(path, "w", encoding="utf-8") as f:
        f.write(yml)


if __name__ == "__main__":
    sys.exit(main())
