"""Backoff n-gram LM (order 2-4) scored on the device for shallow fusion.

Counterpart of ``tensorflowasr_tpu/utils/ngram_lm.py``, with its own copy of
the host half: the hashing, ``NGramLM`` (scoring, perplexity, ``.npz`` and
ARPA files) and the builders, so that the tables, the ``.npz`` files and the
ARPA text are the JAX package's element for element and byte for byte, and
an LM written by either package loads in the other.

The LM is an interpolated Kneser-Ney backoff model reduced to flat tensors:

- ``uni_logp``  [V]   dense unigram log probs;
- one open-addressing hash table (two independent uint32 key lanes +
  float32 value) holding BOTH the seen n-gram log probs ("p" entries,
  orders 2..n) AND the context backoff weights ("b" entries, orders
  1..n-1), exactly the two record kinds of an ARPA file;
- lookup = double-hash probing with a STATIC probe count fixed at build
  time, so the whole backoff chain
      score(w|c) = p(w|c)              if c,w seen
                 = bow(c) + score(w|c') otherwise
  unrolls into a handful of gathers on the device, with no host round trip.

The device half (``lm_pack``, ``table_lookup``, ``score_candidates``) holds
the uint32 hash lanes in int64 tensors and masks them with ``& 0xFFFFFFFF``
after every multiply-add: the product of two values below 2^32 wraps int64,
and its low 32 bits survive the wrap (``torch.uint32`` has no complete CUDA
arithmetic).

Sentence starts use a BOS sentinel token id == vocab_size (the reference
KenLM uses <s> the same way), which is valid in contexts but never
predicted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

_LN10 = float(np.log(10.0))  # ARPA stores log10; we store natural log

_P1 = 2654435761          # Knuth multiplicative; same spirit as ops/beam.py
_P2 = 40503
_M32 = 0xFFFFFFFF
_MAX_PROBES = 16


def _salt(kind: str, order: int) -> Tuple[int, int]:
    base = 0x9E3779B9 if kind == "p" else 0x85EBCA6B
    return (base + order * 101) & _M32, (base ^ (order * 40503)) & _M32


def _hash_tuple(kind: str, tokens: Sequence[int]) -> Tuple[int, int]:
    """Python-int rolling hash of (kind, order, tokens) — two 32-bit lanes.
    MUST stay in lockstep with ``_hash_torch``."""
    h1, h2 = _salt(kind, len(tokens))
    for t in tokens:
        h1 = (h1 * _P1 + int(t) + 1) & _M32
        h2 = (h2 * _P2 + int(t) + 3) & _M32
    return h1, h2


@dataclasses.dataclass
class NGramLM:
    """Backoff LM in flat-tensor form (numpy side)."""

    order: int
    vocab_size: int
    uni_logp: np.ndarray          # [V] float32
    key1: np.ndarray              # [cap] uint32 (0,0) = empty
    key2: np.ndarray              # [cap] uint32
    val: np.ndarray               # [cap] float32
    n_probe: int                  # static probe count for lookups
    # raw ("p"/"b", token-tuple) -> natural-log value entries. The hash
    # table above cannot be ENUMERATED (keys are hashes), so ARPA export
    # and exact save/load round-trip keep the explicit entries too.
    raw: Optional[Dict[Tuple[str, Tuple[int, ...]], float]] = None

    # -- construction -------------------------------------------------------
    @property
    def bos(self) -> int:
        return self.vocab_size

    def _lookup(self, kind: str, tokens: Sequence[int]):
        h1, h2 = _hash_tuple(kind, tokens)
        mask = len(self.key1) - 1
        step = h2 | 1
        for i in range(self.n_probe):
            s = (h1 + i * step) & _M32 & mask
            if self.key1[s] == h1 and self.key2[s] == h2:
                return float(self.val[s])
            if self.key1[s] == 0 and self.key2[s] == 0:
                return None
        return None

    # -- scoring (numpy; golden reference for the device path) -------------
    def score(self, context: Sequence[int], token: int) -> float:
        """log p(token | context). ``context`` may be any length; only the
        last order-1 tokens matter; shorter contexts are BOS-padded."""
        n = self.order
        ctx = ([self.bos] * (n - 1) + [int(t) for t in context])[-(n - 1):] \
            if n > 1 else []
        s = float(self.uni_logp[token])
        for o in range(2, n + 1):
            c = ctx[-(o - 1):]
            p = self._lookup("p", c + [int(token)])
            if p is not None:
                s = p
            else:
                bow = self._lookup("b", c)
                s = (bow or 0.0) + s
        return s

    def perplexity(self, id_sequences: Iterable[Sequence[int]]) -> float:
        total, count = 0.0, 0
        for seq in id_sequences:
            ctx: List[int] = []
            for tok in seq:
                total += self.score(ctx, int(tok))
                ctx.append(int(tok))
                count += 1
        return float(np.exp(-total / max(count, 1)))

    # -- io -----------------------------------------------------------------
    def save(self, path: str) -> None:
        arrays = dict(order=self.order, vocab_size=self.vocab_size,
                      uni_logp=self.uni_logp, key1=self.key1,
                      key2=self.key2, val=self.val, n_probe=self.n_probe)
        if self.raw is not None:
            # explicit entries, grouped by (kind, tuple length): tokens
            # [N, L] int32 + values [N] f32 — enables to_arpa after load
            groups: Dict[Tuple[str, int], List] = {}
            for (kind, toks), v in self.raw.items():
                groups.setdefault((kind, len(toks)), []).append(
                    (list(toks), v))
            for (kind, length), items in groups.items():
                toks = np.asarray([t for t, _ in items], np.int32)
                # float64: ARPA re-export after load stays byte-identical
                vals = np.asarray([v for _, v in items], np.float64)
                arrays[f"raw_{kind}{length}_toks"] = toks
                arrays[f"raw_{kind}{length}_vals"] = vals
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "NGramLM":
        z = np.load(path)
        raw = None
        for name in z.files:
            if not name.startswith("raw_") or not name.endswith("_toks"):
                continue
            if raw is None:
                raw = {}
            kind = name[4]                       # "p" or "b"
            toks = z[name]
            vals = z[name[:-5] + "_vals"]
            for t, v in zip(toks, vals):
                raw[(kind, tuple(int(x) for x in t))] = float(v)
        return cls(order=int(z["order"]), vocab_size=int(z["vocab_size"]),
                   uni_logp=z["uni_logp"], key1=z["key1"], key2=z["key2"],
                   val=z["val"], n_probe=int(z["n_probe"]), raw=raw)

    # -- ARPA interop (the KenLM text format the reference's scorer.cpp
    # consumes; externals/ctc_decoders.zip) --------------------------------
    def to_arpa(self, path: str, id_to_token: Sequence[str]) -> None:
        """Write standard ARPA text (log10). Requires ``raw`` entries
        (present when built by train_ngram_lm / from_arpa, and preserved
        by save/load)."""
        if self.raw is None:
            raise ValueError("to_arpa needs the raw n-gram entries; this "
                             "LM was built without them")

        def tok(i: int) -> str:
            if i == self.bos:
                return "<s>"
            t = id_to_token[i]
            # ARPA is whitespace-delimited; the space token round-trips
            # through its vocab-file spelling (utils/text.py [SPACE])
            return "[SPACE]" if t == " " else t

        # group p-entries per order; attach backoff to the matching
        # context entry of the lower order
        per_order: Dict[int, List[Tuple[Tuple[int, ...], float]]] = {}
        for (kind, toks), v in self.raw.items():
            if kind == "p":
                per_order.setdefault(len(toks), []).append((toks, v))
        lines = ["\\data\\"]
        counts = {1: self.vocab_size + 1}        # + <s>
        for o in range(2, self.order + 1):
            counts[o] = len(per_order.get(o, []))
        for o in range(1, self.order + 1):
            lines.append(f"ngram {o}={counts[o]}")
        lines.append("")
        # unigrams: every vocab token (+ <s> with the KenLM convention of
        # -99) with its backoff weight where one exists
        lines.append("\\1-grams:")
        for i in list(range(self.vocab_size)) + [self.bos]:
            lp = -99.0 if i == self.bos else float(self.uni_logp[i]) / _LN10
            bow = self.raw.get(("b", (i,)))
            tail = f"\t{bow / _LN10:.6f}" if bow is not None else ""
            lines.append(f"{lp:.6f}\t{tok(i)}{tail}")
        for o in range(2, self.order + 1):
            lines.append("")
            lines.append(f"\\{o}-grams:")
            for toks, v in sorted(per_order.get(o, [])):
                bow = self.raw.get(("b", toks)) if o < self.order else None
                tail = f"\t{bow / _LN10:.6f}" if bow is not None else ""
                words = " ".join(tok(t) for t in toks)
                lines.append(f"{v / _LN10:.6f}\t{words}{tail}")
        lines += ["", "\\end\\", ""]
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(lines))

    @classmethod
    def from_arpa(cls, path: str, token_to_id: Dict[str, int],
                  vocab_size: int) -> "NGramLM":
        """Load a (KenLM-produced) ARPA text file into the flat-tensor form.

        ``token_to_id`` maps ARPA tokens to our ids (e.g. the phone
        featurizer's map); "<s>" maps to the BOS sentinel (== vocab_size);
        entries containing "</s>"/"<unk>"/unknown tokens are skipped (the
        decoder never predicts them)."""
        order = 0
        section = 0                               # current n-gram order
        uni_logp = np.full((vocab_size,), -20.0, np.float32)
        entries: Dict[Tuple[str, Tuple[int, ...]], float] = {}

        def to_id(w: str) -> Optional[int]:
            if w == "<s>":
                return vocab_size
            if w == "[SPACE]":          # vocab-file spelling of " "
                w = " "
            i = token_to_id.get(w)
            return i if i is not None and 0 <= i < vocab_size else None

        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line == "\\end\\":
                    continue
                if line == "\\data\\":
                    continue
                if line.startswith("ngram "):
                    order = max(order, int(line.split("=")[0].split()[1]))
                    continue
                if line.endswith("-grams:"):
                    section = int(line[1:].split("-")[0])
                    continue
                if section == 0:
                    continue
                parts = line.split()
                if len(parts) < section + 1:
                    continue              # malformed/blank-token line
                lp = float(parts[0]) * _LN10
                has_bow = len(parts) == section + 2
                words = parts[1:1 + section]
                bow = float(parts[-1]) * _LN10 if has_bow else None
                ids = [to_id(w) for w in words]
                if any(i is None for i in ids):
                    continue
                toks = tuple(ids)
                if section == 1:
                    if toks[0] < vocab_size:
                        uni_logp[toks[0]] = lp
                else:
                    entries[("p", toks)] = lp
                if bow is not None:
                    entries[("b", toks)] = bow
        if not 2 <= order <= 4:
            raise ValueError(f"ARPA order must be 2..4, got {order}")
        key1, key2, val, n_probe = _build_table(entries)
        return cls(order=order, vocab_size=vocab_size, uni_logp=uni_logp,
                   key1=key1, key2=key2, val=val, n_probe=n_probe,
                   raw=entries)


def _build_table(entries: Dict[Tuple[str, Tuple[int, ...]], float]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Open-addressing insert with double hashing; grows until every key
    lands within _MAX_PROBES probes."""
    hashed = {}
    for (kind, toks), v in entries.items():
        h = _hash_tuple(kind, toks)
        if h == (0, 0):              # reserved empty marker (p ~ 2^-64)
            h = (1, 1)
        if h not in hashed:          # 64-bit collision: keep first
            hashed[h] = v
    cap = 64
    while cap < 2 * max(len(hashed), 1):
        cap *= 2
    while True:
        key1 = np.zeros((cap,), np.uint32)
        key2 = np.zeros((cap,), np.uint32)
        val = np.zeros((cap,), np.float32)
        mask = cap - 1
        worst = 0
        ok = True
        for (h1, h2), v in hashed.items():
            step = h2 | 1
            for i in range(_MAX_PROBES):
                s = (h1 + i * step) & _M32 & mask
                if key1[s] == 0 and key2[s] == 0:
                    key1[s], key2[s], val[s] = h1, h2, v
                    worst = max(worst, i + 1)
                    break
            else:
                ok = False
                break
        if ok:
            return key1, key2, val, worst
        cap *= 2


def train_ngram_lm(id_sequences: Iterable[Sequence[int]], vocab_size: int,
                   order: int = 3, discount: float = 0.75) -> NGramLM:
    """Interpolated Kneser-Ney from integer token sequences.

    Highest order uses raw counts; lower orders use continuation counts
    (number of distinct left extensions); unigram is add-one smoothed so
    every token has mass. Stored in ARPA backoff form: seen-ngram logp
    ("p") + context backoff weights ("b")."""
    if not 2 <= order <= 4:
        raise ValueError(f"order must be 2..4, got {order}")
    bos = vocab_size
    # raw counts per order (tuples of ids)
    raw: List[Dict[Tuple[int, ...], int]] = [dict() for _ in range(order + 1)]
    for seq in id_sequences:
        toks = [bos] * (order - 1) + [int(t) for t in seq]
        for i in range(order - 1, len(toks)):
            for o in range(1, order + 1):
                if i - o + 1 < 0:
                    continue
                g = tuple(toks[i - o + 1:i + 1])
                raw[o][g] = raw[o].get(g, 0) + 1

    # adjusted counts: highest order raw; lower orders continuation
    adj: List[Dict[Tuple[int, ...], int]] = [dict() for _ in range(order + 1)]
    adj[order] = raw[order]
    for o in range(order - 1, 0, -1):
        cont: Dict[Tuple[int, ...], set] = {}
        for g in raw[o + 1]:
            cont.setdefault(g[1:], set()).add(g[0])
        adj[o] = {g: len(s) for g, s in cont.items()}
        # grams only ever seen sentence-initially have no left extension
        # in raw[o+1] except from BOS; fall back to raw counts for those
        for g, c in raw[o].items():
            adj[o].setdefault(g, c)

    # unigram: add-one over adjusted counts
    uni = np.ones((vocab_size,), np.float64)
    for (w,), c in adj[1].items():
        if 0 <= w < vocab_size:
            uni[w] += c
    uni_logp = np.log(uni / uni.sum()).astype(np.float32)

    def p_lower(tokens: Tuple[int, ...], memo: Dict) -> float:
        """interpolated prob of tokens[-1] given tokens[:-1] at len order."""
        o = len(tokens)
        if o == 1:
            w = tokens[0]
            return float(np.exp(uni_logp[w])) if 0 <= w < vocab_size else 1e-12
        if tokens in memo:
            return memo[tokens]
        c = tokens[:-1]
        ctx_total = ctx_totals[o].get(c)
        if ctx_total:
            cnt = adj[o].get(tokens, 0)
            n1p = ctx_distinct[o].get(c, 0)
            lam = discount * n1p / ctx_total
            p = max(cnt - discount, 0.0) / ctx_total + \
                lam * p_lower(tokens[1:], memo)
        else:
            p = p_lower(tokens[1:], memo)
        memo[tokens] = p
        return p

    # denominators: per-context totals and distinct-continuation counts
    ctx_totals: List[Dict[Tuple[int, ...], int]] = \
        [dict() for _ in range(order + 1)]
    ctx_distinct: List[Dict[Tuple[int, ...], int]] = \
        [dict() for _ in range(order + 1)]
    for o in range(2, order + 1):
        for g, c in adj[o].items():
            ctx = g[:-1]
            ctx_totals[o][ctx] = ctx_totals[o].get(ctx, 0) + c
            ctx_distinct[o][ctx] = ctx_distinct[o].get(ctx, 0) + 1

    entries: Dict[Tuple[str, Tuple[int, ...]], float] = {}
    memo: Dict = {}
    for o in range(2, order + 1):
        for g in adj[o]:
            entries[("p", g)] = float(np.log(max(p_lower(g, memo), 1e-12)))
    for o in range(2, order + 1):
        for c, total in ctx_totals[o].items():
            lam = discount * ctx_distinct[o][c] / total
            entries[("b", c)] = float(np.log(max(lam, 1e-12)))

    key1, key2, val, n_probe = _build_table(entries)
    return NGramLM(order=order, vocab_size=vocab_size, uni_logp=uni_logp,
                   key1=key1, key2=key2, val=val, n_probe=n_probe,
                   raw=entries)


def ngram_lm_from_weighted_sequences(
        weighted_sequences: Iterable[Tuple[Sequence[int], float]],
        vocab_size: int, order: int = 3,
        discount: float = 0.75) -> NGramLM:
    """Backoff LM from WEIGHTED token sequences (absolute discounting with
    interpolation on weighted counts at every order — continuation counts
    are not well-defined for fractional weights).

    This is the char-normalization path for word-level LMs
    (``char_lm_from_word_arpa``): each word n-gram contributes its char
    expansion weighted by its probability."""
    if not 2 <= order <= 4:
        raise ValueError(f"order must be 2..4, got {order}")
    bos = vocab_size
    cnt: List[Dict[Tuple[int, ...], float]] = [dict()
                                               for _ in range(order + 1)]
    for seq, w in weighted_sequences:
        toks = [bos] * (order - 1) + [int(t) for t in seq]
        for i in range(order - 1, len(toks)):
            for o in range(1, order + 1):
                if i - o + 1 < 0:
                    continue
                g = tuple(toks[i - o + 1:i + 1])
                cnt[o][g] = cnt[o].get(g, 0.0) + w

    uni = np.full((vocab_size,), 1e-6, np.float64)   # floor: every token
    for (t,), c in cnt[1].items():
        if 0 <= t < vocab_size:
            uni[t] += c
    uni_logp = np.log(uni / uni.sum()).astype(np.float32)

    ctx_totals: List[Dict[Tuple[int, ...], float]] = \
        [dict() for _ in range(order + 1)]
    ctx_distinct: List[Dict[Tuple[int, ...], int]] = \
        [dict() for _ in range(order + 1)]
    for o in range(2, order + 1):
        for g, c in cnt[o].items():
            ctx = g[:-1]
            ctx_totals[o][ctx] = ctx_totals[o].get(ctx, 0.0) + c
            ctx_distinct[o][ctx] = ctx_distinct[o].get(ctx, 0) + 1

    def p_interp(tokens: Tuple[int, ...], memo: Dict) -> float:
        o = len(tokens)
        if o == 1:
            t = tokens[0]
            return float(np.exp(uni_logp[t])) if 0 <= t < vocab_size \
                else 1e-12
        if tokens in memo:
            return memo[tokens]
        c = tokens[:-1]
        total = ctx_totals[o].get(c, 0.0)
        if total > 0:
            # discount scaled to the context's count magnitude so tiny
            # fractional weights are not discounted to zero; the SAME
            # per-context lambda is stored as its backoff weight below
            d = discount * total / (total + ctx_distinct[o][c])
            lam = (d * ctx_distinct[o][c]) / total
            p = max(cnt[o].get(tokens, 0.0) - d, 0.0) / total + \
                lam * p_interp(tokens[1:], memo)
        else:
            p = p_interp(tokens[1:], memo)
        memo[tokens] = p
        return p

    entries: Dict[Tuple[str, Tuple[int, ...]], float] = {}
    memo: Dict = {}
    for o in range(2, order + 1):
        for g in cnt[o]:
            entries[("p", g)] = float(np.log(max(p_interp(g, memo), 1e-12)))
    for o in range(2, order + 1):
        for c, total in ctx_totals[o].items():
            d = discount * total / (total + ctx_distinct[o][c])
            lam = d * ctx_distinct[o][c] / total
            entries[("b", c)] = float(np.log(min(max(lam, 1e-12), 1.0)))
    key1, key2, val, n_probe = _build_table(entries)
    return NGramLM(order=order, vocab_size=vocab_size, uni_logp=uni_logp,
                   key1=key1, key2=key2, val=val, n_probe=n_probe,
                   raw=entries)


def unit_lm_from_word_arpa(path: str, word_to_units, vocab_size: int,
                           order: int = 3) -> NGramLM:
    """Unit-normalized WORD LM: expand each n-gram of a word-level
    (KenLM) ARPA into its decode-unit id sequence via ``word_to_units``
    (word str -> List[int] or None if uncovered), weighted by the
    n-gram's probability, and fit a unit-level backoff LM on the
    weighted counts.

    This is the flat-tensor answer to the reference scorer's word trie
    (externals/ctc_decoders.zip path_trie.cpp scoring completed words
    over a char CTC): multi-unit lexical structure shapes the unit
    transition scores, and the result fuses through the exact same
    ``score_candidates`` machinery as any unit LM. For our phone beam
    the words are pinyin syllables (units = phones); for a char decode
    they are multi-char words (units = chars)."""
    highest: Dict[int, List[Tuple[List[str], float]]] = {}
    section = 0
    max_order = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line.startswith("ngram "):
                max_order = max(max_order,
                                int(line.split("=")[0].split()[1]))
                continue
            if line.endswith("-grams:"):
                section = int(line[1:].split("-")[0])
                continue
            if section == 0 or not line or line.startswith("\\"):
                continue
            parts = line.split()
            words = parts[1:1 + section]
            if any(w in ("<s>", "</s>", "<unk>") for w in words):
                continue
            highest.setdefault(section, []).append(
                (words, 10.0 ** float(parts[0])))
    use = highest.get(max_order) or highest.get(max(highest))
    if not use:
        raise ValueError(f"no usable n-grams in {path}")

    weighted = []
    for words, w in use:
        units: List[int] = []
        ok = True
        for word in words:
            u = word_to_units(word)
            if u is None:
                ok = False
                break
            units.extend(int(i) for i in u)
        if ok and units:
            weighted.append((units, w))
    if not weighted:
        raise ValueError("no ARPA word covered by the unit vocabulary")
    return ngram_lm_from_weighted_sequences(weighted, vocab_size,
                                            order=order)


def char_lm_from_word_arpa(path: str, char_to_id: Dict[str, int],
                           vocab_size: int, order: int = 3) -> NGramLM:
    """``unit_lm_from_word_arpa`` for char units (word = char string)."""

    def to_units(word: str) -> Optional[List[int]]:
        out = []
        for ch in word:
            i = char_to_id.get(ch)
            if i is None or not 0 <= i < vocab_size:
                return None
            out.append(i)
        return out

    return unit_lm_from_word_arpa(path, to_units, vocab_size, order=order)


def estimate_bigram_lm(id_sequences: Iterable[Sequence[int]],
                       vocab_size: int, add_k: float = 0.5) -> np.ndarray:
    """DENSE [V, V] add-k token bigram ``log p(cur | prev)`` (row 0 doubles
    as sentence start) — the lightweight fusion table consumed directly by
    ``ops.beam.ctc_beam_search_decode(lm_logp=...)``. For anything beyond
    a bigram use ``train_ngram_lm`` (hash-table backoff form)."""
    counts = np.full((vocab_size, vocab_size), add_k, np.float64)
    for seq in id_sequences:
        prev = 0
        for tok in seq:
            counts[prev, int(tok)] += 1.0
            prev = int(tok)
    probs = counts / counts.sum(axis=1, keepdims=True)
    return np.log(probs).astype(np.float32)


# ---------------------------------------------------------------------------
# Scoring on the device (torch)
# ---------------------------------------------------------------------------

def _hash_extend(h1: torch.Tensor, h2: torch.Tensor, col: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extend a rolling hash (int64 lanes holding uint32 values) by one
    (broadcast) token column, wrapping each lane to 32 bits."""
    c = col.to(torch.int64) & _M32
    return ((h1 * _P1 + c + 1) & _M32, (h2 * _P2 + c + 3) & _M32)


def _hash_torch(kind: str, tuple_len: int, token_cols: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rolling hash over a list of [...]-shaped integer tensors (one per
    position), salted for a (kind, tuple_len) key; ``token_cols`` may be a
    PREFIX of the full tuple (extend with ``_hash_extend``). Lockstep with
    ``_hash_tuple``."""
    s1, s2 = _salt(kind, tuple_len)
    col = token_cols[0]
    h1 = torch.full(col.shape, s1, dtype=torch.int64, device=col.device)
    h2 = torch.full(col.shape, s2, dtype=torch.int64, device=col.device)
    for col in token_cols:
        h1, h2 = _hash_extend(h1, h2, col)
    return h1, h2


@dataclasses.dataclass(frozen=True)
class DeviceNGramLM:
    """The LM's tensors on one device; ``order``, ``n_probe`` and ``bos``
    are plain ints, so the probe loop and the backoff chain unroll in
    Python. The key lanes hold uint32 values in int64."""

    uni_logp: torch.Tensor        # [V] f32
    key1: torch.Tensor            # [cap] int64
    key2: torch.Tensor            # [cap] int64
    val: torch.Tensor             # [cap] f32
    order: int = 3
    n_probe: int = _MAX_PROBES
    bos: int = 0


def lm_pack(lm: NGramLM, device: Union[str, torch.device]) -> DeviceNGramLM:
    """The LM's tables on ``device``."""
    def put(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)

    return DeviceNGramLM(
        uni_logp=put(lm.uni_logp, torch.float32),
        key1=put(lm.key1.astype(np.int64), torch.int64),
        key2=put(lm.key2.astype(np.int64), torch.int64),
        val=put(lm.val, torch.float32),
        order=int(lm.order), n_probe=int(lm.n_probe), bos=int(lm.bos))


def table_lookup(lm: DeviceNGramLM, h1: torch.Tensor, h2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found bool[...], value f32[...]): the static ``n_probe`` double-hash
    probe sequence, all gathers."""
    mask = lm.key1.shape[0] - 1
    step = h2 | 1
    found = torch.zeros(h1.shape, dtype=torch.bool, device=h1.device)
    value = torch.zeros(h1.shape, dtype=torch.float32, device=h1.device)
    for i in range(int(lm.n_probe)):
        # (h1 + i * step) stays below 2^37, and masking with cap - 1 (a
        # power of two below 2^32) equals masking the uint32 wrap
        slot = (h1 + i * step) & mask
        hit = (lm.key1[slot] == h1) & (lm.key2[slot] == h2) & ~found
        value = torch.where(hit, lm.val[slot], value)
        found = found | hit
    return found, value


def score_candidates(lm: DeviceNGramLM, ctx: torch.Tensor,
                     cand: torch.Tensor) -> torch.Tensor:
    """Backoff-chain scores, fully vectorized.

    Args:
      lm: ``lm_pack`` output.
      ctx:  [..., n-1] int most-recent context (ctx[..., -1] = last
            token), BOS-padded (token id == vocab_size) at sentence start.
      cand: [..., K] int candidate next tokens.

    Returns: [..., K] float32 log p(cand | ctx).
    """
    uni = lm.uni_logp
    safe_cand = cand.to(torch.int64).clamp(0, uni.shape[0] - 1)
    s = uni[safe_cand]
    c = ctx.shape[-1]
    for o in range(2, int(lm.order) + 1):
        ctx_cols = [ctx[..., j] for j in range(c - (o - 1), c)]
        # "p" entry: hash the o-1 context prefix once (salted for length
        # o), then extend per candidate token
        h1, h2 = _hash_torch("p", o, ctx_cols)
        h1p, h2p = _hash_extend(h1[..., None], h2[..., None], safe_cand)
        found_p, p = table_lookup(lm, h1p, h2p)
        hb1, hb2 = _hash_torch("b", o - 1, ctx_cols)
        found_b, bow = table_lookup(lm, hb1, hb2)
        bow = torch.where(found_b, bow, 0.0)
        s = torch.where(found_p, p, bow[..., None] + s)
    return s
