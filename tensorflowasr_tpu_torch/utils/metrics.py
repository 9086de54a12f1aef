"""Error-rate metrics: Levenshtein with substitution/deletion/insertion counts.

Counterpart of ``tensorflowasr_tpu/utils/metrics.py`` (pure Python / numpy):
``levenshtein(ref, hyp)`` (alias ``wer``) returns (n_sub, n_del, n_ins)
operation counts against the reference sequence; CER = (S+D+I)/len(ref);
SER counts exact mismatches.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def levenshtein(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int]:
    """Edit distance with op counts: returns (substitutions, deletions,
    insertions) transforming ``hyp`` into ``ref``."""
    n, m = len(ref), len(hyp)
    if n == 0:
        return (0, 0, m)
    if m == 0:
        return (0, n, 0)
    # dp[i][j] = (cost, subs, dels, ins) of aligning ref[:i] to hyp[:j]
    cost = np.zeros((n + 1, m + 1), dtype=np.int32)
    cost[:, 0] = np.arange(n + 1)
    cost[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = cost[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dele = cost[i - 1, j] + 1
            ins = cost[i, j - 1] + 1
            cost[i, j] = min(sub, dele, ins)
    # backtrack for op counts
    i, j = n, m
    subs = dels = inss = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and cost[i, j] == cost[i - 1, j - 1] and \
                ref[i - 1] == hyp[j - 1]:
            i, j = i - 1, j - 1
        elif i > 0 and j > 0 and cost[i, j] == cost[i - 1, j - 1] + 1:
            subs += 1
            i, j = i - 1, j - 1
        elif i > 0 and cost[i, j] == cost[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            inss += 1
            j -= 1
    return subs, dels, inss


def wer(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int]:
    """:func:`levenshtein` under the name the JAX package also exports:
    (substitutions, deletions, insertions); over word sequences it gives
    the word error counts."""
    return levenshtein(ref, hyp)


def cer(ref: Sequence, hyp: Sequence) -> float:
    s, d, i = levenshtein(ref, hyp)
    return (s + d + i) / max(len(ref), 1)


class ErrorRateAccumulator:
    """Streaming CER/SER accumulator with S/I/D breakdown."""

    def __init__(self, name: str = "cer"):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.n_sub = 0
        self.n_del = 0
        self.n_ins = 0
        self.n_ref = 0
        self.n_sent = 0
        self.n_sent_err = 0

    def update(self, ref: Sequence, hyp: Sequence) -> None:
        s, d, i = levenshtein(ref, hyp)
        self.n_sub += s
        self.n_del += d
        self.n_ins += i
        self.n_ref += len(ref)
        self.n_sent += 1
        self.n_sent_err += int(list(ref) != list(hyp))

    def update_batch(self, refs, hyps) -> None:
        for r, h in zip(refs, hyps):
            self.update(r, h)

    @property
    def cer(self) -> float:
        return (self.n_sub + self.n_del + self.n_ins) / max(self.n_ref, 1)

    @property
    def ser(self) -> float:
        return self.n_sent_err / max(self.n_sent, 1)

    def result(self) -> dict:
        return {
            f"{self.name}": self.cer,
            "ser": self.ser,
            "S": self.n_sub,
            "D": self.n_del,
            "I": self.n_ins,
            "N": self.n_ref,
        }
