"""The numbers that decide ``correct``.

Served tokens are judged by the widest gap by which a served token's
reference logit lies below the reference's best at its position:

- a frame-level id (a stream's phone a frame, its char a picked frame):
  that frame's gap;
- a greedy CTC phone sequence (merged repeats, blanks dropped), whose
  frames are not served: the smallest widest gap over every CTC alignment
  of the frames that collapses to the served sequence (infinite when none
  does, e.g. a sequence longer than its frames allow);

Training is judged by its losses, the first gradient and the parameters'
change, each by the worst leaf: |norm(program) - norm(reference)| over the
larger of the reference leaf's norm and the median leaf's, leaving out the
leaves whose reference gradient is under a thousandth of the median leaf's
(nought but rounding, as a key bias under softmax).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np

INF = float("inf")


def frame_gap(logits: np.ndarray, ids: np.ndarray) -> float:
    """logits [T, V], ids [T] -> max over frames of best - logit[id]."""
    if len(ids) != len(logits):
        return INF
    if len(ids) == 0:
        return 0.0
    ids = np.asarray(ids, np.int64)
    if ids.min() < 0 or ids.max() >= logits.shape[1]:
        return INF
    got = logits[np.arange(len(ids)), ids]
    return float((logits.max(axis=1) - got).max())


def ctc_gap(logits: np.ndarray, seq: Iterable[int], blank: int) -> float:
    """logits [T, V] of the valid frames, seq the served phone sequence."""
    seq = [int(s) for s in seq]
    t_len, v = logits.shape
    if any(s < 0 or s >= v or s == blank for s in seq):
        return INF
    if t_len == 0:
        return INF if seq else 0.0
    ext = [blank]
    for s in seq:
        ext += [s, blank]
    n = len(ext)
    cost = logits.max(axis=1)[:, None] - logits[:, ext]       # [T, S]
    ext = np.asarray(ext)
    skip = np.zeros(n, bool)
    skip[2:] = (ext[2:] != blank) & (ext[2:] != ext[:-2])
    dp = np.full(n, INF)
    dp[0] = cost[0, 0]
    if n > 1:
        dp[1] = cost[0, 1]
    for t in range(1, t_len):
        best = dp.copy()
        best[1:] = np.minimum(best[1:], dp[:-1])
        best[2:] = np.where(skip[2:], np.minimum(best[2:], dp[:-2]), best[2:])
        dp = np.maximum(best, cost[t])
    end = dp[-1] if n == 1 else min(dp[-1], dp[-2])
    return float(end)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Iterable[str]) -> Dict[str, float]:
    """Each leaf's |norm(prog) - norm(ref)| over max(norm(ref), median
    norm(ref)), over the leaves ``keep`` (dicts of leaf norms)."""
    keep = list(keep)
    med = float(np.median([ref[k] for k in keep]))
    out = {}
    for k in keep:
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        out[k] = g if math.isfinite(g) else INF
    return out


def rel_norm_gap(prog: Dict[str, float], ref: Dict[str, float],
                 keep: Iterable[str]) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(prog, ref, keep).values())


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep: Iterable[str]) -> str:
    gaps = leaf_gaps(prog, ref, keep)
    return max(gaps, key=gaps.get)


def moving_leaves(ref_grad_norms: Dict[str, float]) -> list:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = float(np.median(list(ref_grad_norms.values())))
    return [k for k, v in ref_grad_norms.items() if v >= 1e-3 * med]


def sample(done: list, size, n: int, seed: int) -> list:
    """The judged items: the largest of ``done`` by ``size`` and a draw
    from the seed of up to n - 1 others."""
    if not done:
        return []
    from benchlib import traffic
    longest = max(done, key=size)
    rest = [k for k in done if k != longest]
    n = min(len(rest), n - 1)
    rng = traffic.rng_for(seed, 9)
    return [longest] + sorted(rng.choice(rest, n, replace=False).tolist()
                              if n > 0 else [])


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}}, in the order of ``limits``; a number
    that is missing or not finite fails."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name, INF)
        out[name] = {"value": v if math.isfinite(v) else None,
                     "limit": float(limit)}
    return out


def passed(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())
