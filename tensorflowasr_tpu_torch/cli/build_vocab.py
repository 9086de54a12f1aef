"""Build phone/char vocabulary files from transcript lists.

    python -m tensorflowasr_tpu_torch.cli.build_vocab --lists L.list \\
        --phone_out phones.txt --char_out chars.txt [--pinyin_map P.map] \\
        [--transcripts_are_pinyin] [--only_chinese] [--min_count N]

A copy of ``tensorflowasr_tpu/cli/build_vocab.py``: it writes the same files
byte for byte.

The reference ships fixed dictionaries (asr/configs/dict/); this tool
derives them from YOUR corpus instead: scans ``path<TAB>text`` lists,
converts text to pinyin phones (pypinyin / lexicon / passthrough), and
writes one-token-per-line vocab files compatible with TextFeaturizer.
"""

from __future__ import annotations

import argparse
import collections
import sys

from tensorflowasr_tpu_torch.utils.text import (
    PinyinConverter,
    load_pinyin2phone,
    only_chinese,
    tokens_to_phones,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lists", nargs="+", required=True,
                   help="transcript list files (path<TAB>text per line)")
    p.add_argument("--phone_out", required=True)
    p.add_argument("--char_out", required=True)
    p.add_argument("--pinyin_map", default=None,
                   help="pinyin2phone map to split toned pinyin")
    p.add_argument("--transcripts_are_pinyin", action="store_true")
    p.add_argument("--pinyin_lexicon", default=None)
    p.add_argument("--only_chinese", action="store_true")
    p.add_argument("--min_count", type=int, default=1)
    args = p.parse_args(argv)

    p2p = load_pinyin2phone(args.pinyin_map) if args.pinyin_map else {}
    pin = None
    if not args.transcripts_are_pinyin:
        pin = PinyinConverter(lexicon_path=args.pinyin_lexicon)
        if not pin.available:
            print("no hanzi->pinyin backend; pass "
                  "--transcripts_are_pinyin or --pinyin_lexicon",
                  file=sys.stderr)
            return 2

    phones = collections.Counter()
    chars = collections.Counter()
    n_lines = 0
    for path in args.lists:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or "\t" not in line:
                    continue
                _, txt = line.split("\t", 1)
                if args.only_chinese and not args.transcripts_are_pinyin:
                    txt = only_chinese(txt)
                if args.transcripts_are_pinyin:
                    pins = txt.split()
                    chars.update(pins)
                else:
                    pins = pin.convert(txt)
                    chars.update(list(txt))
                if p2p:
                    phones.update(tokens_to_phones(pins, p2p))
                else:
                    phones.update(pins)
                n_lines += 1

    def write(path, counter, specials=()):
        toks = []
        for t, c in sorted(counter.items()):
            if c < args.min_count:
                continue
            if t == " ":
                toks.append("[SPACE]")      # loader maps it back to " "
            elif not t.strip() or t.startswith("#"):
                # unrepresentable in the one-token-per-line format
                # (TextFeaturizer treats '#' lines as comments)
                print(f"warning: dropping unrepresentable token {t!r}",
                      file=sys.stderr)
            else:
                toks.append(t)
        with open(path, "w", encoding="utf-8") as f:
            for s in specials:
                f.write(s + "\n")
            for t in toks:
                f.write(t + "\n")
        return len(specials) + len(toks)

    np = write(args.phone_out, phones)
    nc = write(args.char_out, chars, specials=("<S>", "</S>"))
    print(f"{n_lines} lines -> {np} phones ({args.phone_out}), "
          f"{nc} chars ({args.char_out})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
