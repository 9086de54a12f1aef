"""Generate a pinyin2phone map + phone vocabulary from rules.

A copy of ``tensorflowasr_tpu/cli/make_pinyin_map.py``: it writes the same
files byte for byte.

The reference ships these as fixed dictionaries
(asr/configs/dict/pinyin2phone.map, 1545 entries -> phone.txt, 226
tokens, consumed at asr/dataloaders/chunk_dataloader.py:65-97); this tool
derives equivalent files from the initial/final split rules in
``utils/phones.py`` so any corpus can be prepared without shipping data:

  python -m tensorflowasr_tpu_torch.cli.make_pinyin_map \\
      --map_out pinyin2phone.map --phone_out phone.txt

Default emits the full standard syllable table x tones 1-5 (a strict
superset of the reference map). ``--lists`` restricts the map/vocab to
syllables observed in transcript lists (``path<TAB>pinyin`` with
``--transcripts_are_pinyin``, else hanzi via pypinyin/lexicon), matching
the reference's corpus-trimmed inventory. The phone vocab mirrors the
reference phone.txt layout: <S> </S> [SPACE] [UNK], A-Z letters
(optional), then initials + toned finals.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Set

from tensorflowasr_tpu_torch.utils.phones import (
    build_pinyin2phone,
    phone_inventory,
    split_pinyin,
)
from tensorflowasr_tpu_torch.utils.text import PinyinConverter, only_chinese

SPECIALS = ["<S>", "</S>", "[SPACE]", "[UNK]"]
LETTERS = list("QWERTYUIOPASDFGHJKLZXCVBNM")


def collect_syllables(lists: List[str], transcripts_are_pinyin: bool,
                      lexicon: Optional[str], use_only_chinese: bool
                      ) -> Set[str]:
    """Toned syllables (TONE3) observed in transcript lists."""
    pin = None
    if not transcripts_are_pinyin:
        pin = PinyinConverter(lexicon_path=lexicon)
        if not pin.available:
            raise RuntimeError("hanzi transcripts need pypinyin or "
                               "--pinyin_lexicon")
    seen: Set[str] = set()
    for path in lists:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                txt = line.split("\t", 1)[1] if "\t" in line else line
                if use_only_chinese:
                    txt = only_chinese(txt)
                toks = txt.split() if transcripts_are_pinyin \
                    else pin.convert(txt)
                seen.update(toks)
    return seen


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--map_out", required=True,
                   help="pinyin2phone.map output (pinyin<TAB>ph1 ph2)")
    p.add_argument("--phone_out", required=True,
                   help="phone vocabulary output (one token per line)")
    p.add_argument("--lists", nargs="*", default=None,
                   help="optional transcript lists to restrict the "
                        "inventory to observed syllables")
    p.add_argument("--transcripts_are_pinyin", action="store_true")
    p.add_argument("--pinyin_lexicon", default=None)
    p.add_argument("--only_chinese", action="store_true")
    p.add_argument("--no_letters", action="store_true",
                   help="omit the A-Z rows the reference phone.txt carries")
    args = p.parse_args(argv)

    if args.lists:
        observed = collect_syllables(args.lists,
                                     args.transcripts_are_pinyin,
                                     args.pinyin_lexicon, args.only_chinese)
        mapping: Dict[str, List[str]] = {}
        skipped = []
        for syl in sorted(observed):
            try:
                mapping[syl if syl[-1].isdigit() else syl + "5"] = \
                    split_pinyin(syl)
            except ValueError:
                skipped.append(syl)
        if skipped:
            print(f"skipped {len(skipped)} non-pinyin tokens: "
                  f"{skipped[:10]}...", file=sys.stderr)
    else:
        mapping = build_pinyin2phone()

    with open(args.map_out, "w", encoding="utf-8") as f:
        for k in sorted(mapping):
            f.write(f"{k}\t{' '.join(mapping[k])}\n")

    vocab = SPECIALS + ([] if args.no_letters else LETTERS) \
        + phone_inventory(mapping)
    with open(args.phone_out, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    print(f"wrote {len(mapping)} map entries -> {args.map_out}; "
          f"{len(vocab)} phone tokens -> {args.phone_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
