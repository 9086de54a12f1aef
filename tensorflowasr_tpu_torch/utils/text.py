"""Text featurization: vocab files -> integer id sequences.

Counterpart of ``tensorflowasr_tpu.utils.text.TextFeaturizer``:

- one token per line; ``[SPACE]`` maps to a literal space; ``#`` comments and
  blank lines skipped;
- ``blank_at_zero=True``  -> blank id 0, real tokens start at 1;
- ``blank_at_zero=False`` -> blank appended after the last token
  (blank == num_classes - 1), which is what the shipped configs use;
- the ``</S>`` sentence marker via :meth:`endid`;
- pad id is 0.
"""

from __future__ import annotations

import codecs
from typing import Dict, Iterable, List

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

    def endid(self) -> int:
        return self.token_to_index["</S>"]

    def extract(self, tokens: Iterable[str]) -> List[int]:
        return [self.token_to_index[t] for t in tokens]

    def iextract(self, ids) -> List[str]:
        if isinstance(ids, (list, tuple)):
            return [self.index_to_token[int(i)] for i in ids]
        return self.index_to_token[int(ids)]
