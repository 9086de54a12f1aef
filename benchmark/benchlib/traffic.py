"""The one generator of every traffic mix: durations, batches, labels,
signals and stream lanes, all drawn from a mix's parameters and the run's
seed.

Every seed gets the same SET of sizes (durations are stratified quantiles
of the mix's distribution, so the amount of work is the same) in another
order, with other signals and labels. Signals are gated tones: 50 ms
segments of two random tones at one of three loudness levels, frames that a
random-weight model tells apart (a frozen copy of the port's
``serve/bench_chunk.py::tones``; the seed's draws are made on the host and
the samples computed in one pass, on the card for the batches).
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, Sequence

import numpy as np

SR = 16000
TONE_SEGMENT = 800                      # 50 ms at 16 kHz
TONE_LEVELS = (0.001, 0.05, 1.0)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for (seed, stream...); any seed up to 2**64."""
    return np.random.default_rng([int(seed) % (2 ** 64), *stream])


# ---------------------------------------------------------------------------
# durations
# ---------------------------------------------------------------------------

class Durations:
    """A log-normal duration law (median, sigma) clipped to [min, max]."""

    def __init__(self, spec: dict):
        if spec.get("dist", "lognormal") != "lognormal":
            raise ValueError(f"unknown duration law {spec.get('dist')!r}")
        self.median = float(spec["median"])
        self.sigma = float(spec["sigma"])
        self.lo = float(spec["min"])
        self.hi = float(spec["max"])
        self._n = NormalDist()

    def cdf(self, x: float) -> float:
        """The clipped law's distribution function (mass at the clips)."""
        if x < self.lo:
            return 0.0
        if x >= self.hi:
            return 1.0
        return self._n.cdf(math.log(x / self.median) / self.sigma)

    def quantile(self, q: float) -> float:
        q = min(max(q, 1e-12), 1.0 - 1e-12)
        x = self.median * math.exp(self.sigma * self._n.inv_cdf(q))
        return min(max(x, self.lo), self.hi)

    def stratified(self, n: int, lo_q: float = 0.0, hi_q: float = 1.0
                   ) -> np.ndarray:
        """n durations at the mid-quantiles of [lo_q, hi_q]: the same set for
        every seed."""
        qs = lo_q + (np.arange(n) + 0.5) / n * (hi_q - lo_q)
        return np.array([self.quantile(float(q)) for q in qs])

    def mean(self, n: int = 4096) -> float:
        return float(self.stratified(n).mean())


def largest_remainder(shares: Sequence[float], total: int) -> List[int]:
    """Whole counts summing to ``total`` in proportion to ``shares``."""
    raw = [s * total for s in shares]
    counts = [int(math.floor(r)) for r in raw]
    order = sorted(range(len(raw)), key=lambda i: -(raw[i] - counts[i]))
    for i in order[:total - sum(counts)]:
        counts[i] += 1
    return counts


def bucket_plan(law: Durations, buckets_s: Sequence[float], n_batches: int
                ) -> List[dict]:
    """The batches' buckets and the quantile range each draws from: each
    bucket holds the utterances no longer than it and longer than the one
    below, as the port's ``AMDataLoader`` groups them, and gets its share of
    ``n_batches`` by largest remainder."""
    edges = [law.lo] + [min(float(b), law.hi) for b in buckets_s]
    cdfs = [0.0] + [law.cdf(e) for e in edges[1:-1]] + [1.0]
    shares = [cdfs[i + 1] - cdfs[i] for i in range(len(buckets_s))]
    counts = largest_remainder(shares, n_batches)
    return [{"seconds": float(b), "batches": c, "q": (cdfs[i], cdfs[i + 1]),
             "share": shares[i]}
            for i, (b, c) in enumerate(zip(buckets_s, counts))]


# ---------------------------------------------------------------------------
# signals and labels
# ---------------------------------------------------------------------------

def tone_params(n_samples: int, rng: np.random.Generator) -> tuple:
    """The draws of a gated tone of ``n_samples``: two frequencies and a
    loudness level for each 50 ms segment."""
    n_seg = -(-n_samples // TONE_SEGMENT)
    f = rng.uniform(100, 6000, (n_seg, 2))
    level = rng.choice(np.asarray(TONE_LEVELS), n_seg)
    return f, level


def render(params: list, lengths, width: int, device="cpu"):
    """Rows of gated tones from their draws (``tone_params``), computed in
    one pass on ``device``: f32 [rows, width], in [-0.6, 0.6], zero past
    each row's length."""
    import torch
    n_seg = max(-(-width // TONE_SEGMENT), *(len(lv) for _, lv in params))
    f = np.zeros((len(params), n_seg, 2))
    level = np.zeros((len(params), n_seg))
    for i, (fi, li) in enumerate(params):
        f[i, :len(li)], level[i, :len(li)] = fi, li
    t = torch.arange(n_seg * TONE_SEGMENT, dtype=torch.float64,
                     device=device).view(n_seg, TONE_SEGMENT) / SR
    f = torch.from_numpy(f).to(device)[..., None]
    w = 2 * torch.pi * t
    wav = ((torch.sin(w * f[:, :, 0]) + torch.sin(w * f[:, :, 1]))
           * torch.from_numpy(level).to(device)[..., None])
    wav = (0.3 * wav.reshape(len(params), -1)[:, :width]).to(torch.float32)
    keep = torch.arange(width, device=device)[None] < torch.as_tensor(
        np.asarray(lengths), device=device)[:, None]
    return torch.where(keep, wav, 0.0)


def tones(n_samples: int, rng: np.random.Generator) -> np.ndarray:
    """Gated tones of ``n_samples`` f32 samples in [-0.6, 0.6]."""
    return render([tone_params(n_samples, rng)], [n_samples],
                  n_samples).numpy()[0]


def to_int16(wav):
    """The loader's int16 wire format of f32 samples (a tensor)."""
    import torch
    return torch.clamp(torch.round(wav * 32768.0), -32768, 32767).to(
        torch.int16)


def label_lengths(seconds: float, mix: dict) -> tuple:
    """(phones, chars without the end token) of an utterance."""
    chars = max(1, int(round(seconds * float(mix["chars_per_s"]))))
    return chars * int(mix["phones_per_char"]), chars


# ---------------------------------------------------------------------------
# batch mixes (train, decode)
# ---------------------------------------------------------------------------

def batches(mix: dict, model: dict, seed: int, device="cpu"
            ) -> List[Dict[str, np.ndarray]]:
    """The mix's distinct padded batches in the seed's order: numpy dicts
    as the port's ``AMDataLoader`` packs them (int16 wav padded to the
    bucket, ``input_length`` = samples // (hop x reduction), phones and
    chars + the end token padded to the bucket's capacities), plus
    ``seconds`` [B] (unpadded audio) and ``bucket_s``. The seed's draws
    are made on the host; the tones are rendered on ``device``."""
    law = Durations(mix["duration_s"])
    b = int(mix["batch_size"])
    plan = bucket_plan(law, mix["buckets_s"], int(mix["distinct_batches"]))
    rng = rng_for(seed, 1)
    quantum = int(model["hop"]) * int(model["reduction_factor"])
    n_phone, n_char = int(model["num_phone_classes"]), int(
        model["num_char_classes"])
    end_id = int(model["char_end_id"])
    out = []
    for bucket in plan:
        n = bucket["batches"] * b
        if n == 0:
            continue
        durs = law.stratified(n, *bucket["q"])
        durs = durs[rng.permutation(n)]
        sec = bucket["seconds"]
        wav_cap = -(-int(sec * SR) // quantum) * quantum
        phone_cap = max(int(sec * mix["phones_per_s_cap"]) + 5, 8)
        char_cap = max(int(sec * mix["chars_per_s_cap"]) + 5, 8)
        for k in range(bucket["batches"]):
            d = durs[k * b:(k + 1) * b]
            params = []
            phones = np.zeros((b, phone_cap), np.int32)
            chars = np.zeros((b, char_cap), np.int32)
            lens = np.zeros((4, b), np.int32)
            for i, s in enumerate(d):
                n_s = min(int(round(s * SR)), wav_cap)
                params.append(tone_params(n_s, rng))
                n_ph, n_ch = label_lengths(s, mix)
                phones[i, :n_ph] = rng.integers(1, n_phone - 1, n_ph)
                chars[i, :n_ch] = rng.integers(end_id + 1, n_char - 1, n_ch)
                chars[i, n_ch] = end_id
                lens[:, i] = (n_s // quantum, n_ph, n_ch + 1, n_s)
            wav = to_int16(render(params, lens[3], wav_cap, device)).cpu(
            ).numpy()
            out.append({"wav": wav, "input_length": lens[0],
                        "phones": phones, "phone_length": lens[1],
                        "chars": chars, "char_length": lens[2],
                        "seconds": lens[3] / SR, "bucket_s": sec})
    order = rng.permutation(len(out))
    return [out[i] for i in order]


def warm_order(batch_list: List[dict], first: int) -> List[dict]:
    """The batches reordered so that the first ones cover every bucket the
    mix uses (one each, smallest first) and at least ``first`` batches lead:
    set-up runs these, so every shape is warm before the window."""
    seen, lead, rest = set(), [], []
    for bt in batch_list:
        if bt["bucket_s"] not in seen:
            seen.add(bt["bucket_s"])
            lead.append(bt)
        else:
            rest.append(bt)
    lead.sort(key=lambda bt: bt["bucket_s"])
    while len(lead) < first and rest:
        lead.append(rest.pop(0))
    return lead + rest


# ---------------------------------------------------------------------------
# single files (requests) and stream lanes
# ---------------------------------------------------------------------------

def files(mix: dict, seed: int) -> List[np.ndarray]:
    """The mix's distinct f32 files in the seed's order."""
    law = Durations(mix["duration_s"])
    n = int(mix["distinct_files"])
    rng = rng_for(seed, 2)
    durs = law.stratified(n)[rng.permutation(n)]
    return [tones(int(round(s * SR)), rng) for s in durs]


def lanes(mix: dict, seed: int, n_lanes: int, chunk_samples: int,
          horizon_s: float) -> dict:
    """Open-loop stream lanes. Each lane starts at a phase spread over the
    first chunk (stratified, in the seed's order) and plays utterances from
    a pool of distinct ones (durations from the mix's law, rounded up to
    whole chunks, as a client sends fixed-size packets and pads the last),
    each after a gap drawn from ``gap_s``. Returns {"pool": [f32 wav],
    "lanes": [[(start_s, utterance), ...]], "phase_s": [...]} covering
    ``horizon_s`` seconds."""
    law = Durations(mix["duration_s"])
    n_pool = int(mix["distinct_utterances"])
    rng = rng_for(seed, 3)
    chunk_s = chunk_samples / SR
    durs = law.stratified(n_pool)[rng.permutation(n_pool)]
    n_chunks = np.ceil(durs / chunk_s - 1e-9).astype(int)
    pool = [tones(int(c) * chunk_samples, rng) for c in n_chunks]
    gap_lo, gap_hi = (float(g) for g in mix["gap_s"])
    phase = (rng.permutation(n_lanes) + 0.5) / n_lanes * chunk_s
    plan, k = [], 0
    for lane in range(n_lanes):
        t, items = float(phase[lane]), []
        while t < horizon_s:
            u, k = k % n_pool, k + 1
            items.append((t, u))
            t += len(pool[u]) / SR
            t += gap_lo + (gap_hi - gap_lo) * float(rng.random())
        plan.append(items)
    return {"pool": pool, "lanes": plan, "phase_s": phase.tolist()}
