"""Text featurization: vocab files -> integer id sequences.

Counterpart of ``tensorflowasr_tpu.utils.text.TextFeaturizer``:

- one token per line; ``[SPACE]`` maps to a literal space; ``#`` comments and
  blank lines skipped;
- ``blank_at_zero=True``  -> blank id 0, real tokens start at 1;
- ``blank_at_zero=False`` -> blank appended after the last token
  (blank == num_classes - 1), which is what the shipped configs use;
- ``<S>`` / ``</S>`` sentence markers via :meth:`startid` / :meth:`endid`;
- pad id is 0.

Also the text side of the training dataloader: the pinyin -> phone map
(``pinyin<TAB>ph1 ph2 ...`` lines) and an optional hanzi -> pinyin front
(pypinyin if installed, else a lexicon TSV).
"""

from __future__ import annotations

import codecs
from typing import Dict, Iterable, List, Optional, Sequence

from tensorflowasr_tpu_torch.utils.config import preprocess_paths


class TextFeaturizer:
    def __init__(self, config: dict):
        """``config`` needs keys: vocabulary (path), blank_at_zero (bool)."""
        self.config = dict(config)
        vocab_path = preprocess_paths(self.config["vocabulary"])
        blank_at_zero = bool(self.config.get("blank_at_zero", False))

        self.token_to_index: Dict[str, int] = {}
        self.index_to_token: Dict[int, str] = {}
        self.vocab_array: List[str] = []

        index = 0
        if blank_at_zero:
            self.blank = 0
            index = 1
        with codecs.open(vocab_path, "r", "utf-8") as fin:
            for line in fin:
                line = line.strip()
                if line.startswith("#") or not line:
                    continue
                if line == "[SPACE]":
                    line = " "
                self.token_to_index[line] = index
                self.index_to_token[index] = line
                self.vocab_array.append(line)
                index += 1
        self.num_classes = index
        if not blank_at_zero:
            self.blank = index
            self.num_classes += 1

        self.pad = 0

    def startid(self) -> int:
        return self.token_to_index["<S>"]

    def endid(self) -> int:
        return self.token_to_index["</S>"]

    def extract(self, tokens: Iterable[str]) -> List[int]:
        return [self.token_to_index[t] for t in tokens]

    def iextract(self, ids) -> List[str]:
        if isinstance(ids, (list, tuple)):
            return [self.index_to_token[int(i)] for i in ids]
        return self.index_to_token[int(ids)]

    def has(self, token: str) -> bool:
        return token in self.token_to_index


def load_pinyin2phone(path: str) -> Dict[str, List[str]]:
    """Parse a ``pinyin<TAB>ph1 ph2 ...`` map file (e.g. ``long5\tl ong5``);
    used to split toned pinyin into phone units."""
    mapping: Dict[str, List[str]] = {}
    with codecs.open(preprocess_paths(path), "r", "utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            key, phones = line.split("\t", 1)
            mapping[key] = phones.split()
    return mapping


class PinyinConverter:
    """hanzi text -> pinyin token list.

    Uses pypinyin when available; otherwise a lexicon TSV of
    ``char<TAB>pinyin`` entries can be supplied. Transcripts that are
    already space-separated pinyin pass through unchanged via
    :meth:`from_pinyin_text`.
    """

    PHRASE_OVERRIDES = {
        "调大": ["tiao2", "da4"], "调小": ["tiao2", "xiao3"],
        "调亮": ["tiao2", "liang4"], "调暗": ["tiao2", "an4"],
        "肖": ["xiao1"], "英雄传": ["ying1", "xiong2", "zhuan4"],
        "新传": ["xin1", "zhuan4"], "外传": ["wai4", "zhuan4"],
        "正传": ["zheng4", "zhuan4"], "水浒传": ["shui3", "hu3", "zhuan4"],
    }

    def __init__(self, lexicon_path: Optional[str] = None, tone: bool = True):
        self.tone = tone
        self._pypinyin = None
        try:  # optional dependency
            import pypinyin  # type: ignore

            self._pypinyin = pypinyin
        except ImportError:
            self._pypinyin = None
        self.lexicon: Dict[str, str] = {}
        if lexicon_path:
            with codecs.open(preprocess_paths(lexicon_path), "r", "utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    parts = line.split("\t")
                    if len(parts) >= 2:
                        self.lexicon[parts[0]] = parts[1]

    @property
    def available(self) -> bool:
        return self._pypinyin is not None or bool(self.lexicon)

    def convert(self, text: str) -> List[str]:
        if self._pypinyin is not None:
            style = (self._pypinyin.Style.TONE3 if self.tone
                     else self._pypinyin.Style.NORMAL)
            pins = self._pypinyin.pinyin(text, style=style,
                                         neutral_tone_with_five=True)
            return [p[0] for p in pins]
        if self.lexicon:
            out = []
            for ch in text:
                if ch in self.lexicon:
                    out.append(self.lexicon[ch])
                else:
                    out.append(ch)
            return out
        raise RuntimeError(
            "No hanzi->pinyin backend: install pypinyin or pass lexicon_path, "
            "or provide transcripts as space-separated pinyin."
        )

    @staticmethod
    def from_pinyin_text(text: str) -> List[str]:
        return text.split()


def tokens_to_phones(pinyins: Sequence[str],
                     pinyin2phone: Dict[str, List[str]],
                     vocab: Optional[TextFeaturizer] = None) -> List[str]:
    """Expand toned pinyin into phone units via the map.

    Falls back to the pinyin itself when it is already a vocab token, else
    to its characters; a toneless pinyin tries its neutral tone (``5``).
    """
    phones: List[str] = []
    for pin in pinyins:
        if pin in pinyin2phone:
            phones.extend(pinyin2phone[pin])
        elif not pin[-1:].isdigit() and (pin + "5") in pinyin2phone:
            phones.extend(pinyin2phone[pin + "5"])
        elif vocab is not None and vocab.has(pin):
            phones.append(pin)
        else:
            phones.extend(list(pin))
    return phones


def only_chinese(text: str) -> str:
    """Keep only CJK unified ideographs."""
    return "".join(ch for ch in text if "一" <= ch <= "鿿")
