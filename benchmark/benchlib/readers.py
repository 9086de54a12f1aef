"""What the per-layer readers share. A run offers ``spans`` (the harness's
host-clock spans and counts), ``trace`` (``tracing.summarize`` of the traced
seconds, or None), ``t0`` / ``trace_from`` / ``trace_to`` (the window's
start and its traced part) and ``peaks`` (the card's row of ``peaks.json``).
Span metrics read the untraced part of the window, device metrics the
traced part. Each returns None where it finds nothing to read."""

from __future__ import annotations

import statistics


def untraced(run):
    return run.t0, run.trace_from


def median_ms(run, span: str, per: str = None):
    """Median of a span's durations in ms, each divided by the count
    ``per`` recorded at the span's start (e.g. dispatches in a tick)."""
    lo, hi = untraced(run)
    spans = run.spans.between(span, lo, hi)
    if not spans:
        return None
    if per is None:
        return 1e3 * statistics.median(e - s for s, e in spans)
    counts = dict(run.spans.between(per, lo, hi, counts=True))
    vals = [(e - s) / counts[s] for s, e in spans if counts.get(s)]
    return 1e3 * statistics.median(vals) if vals else None


def count_sum(run, name: str, lo: float, hi: float) -> float:
    return sum(v for _, v in run.spans.between(name, lo, hi, counts=True))


def ratio(run, num: str, den: str):
    lo, hi = untraced(run)
    d = count_sum(run, den, lo, hi)
    return count_sum(run, num, lo, hi) / d if d else None


def launches_per(run, unit: str, counted: bool = False):
    """Device operations in the trace per unit (a span, or the sum of a
    count) begun in the traced part."""
    if run.trace is None:
        return None
    lo, hi = run.trace_from, run.trace_to
    n = count_sum(run, unit, lo, hi) if counted else len(
        run.spans.between(unit, lo, hi))
    return run.trace["launches"] / n if n else None


def mfu(run, flops: str = "flops"):
    """Model FLOPs of the units begun in the untraced part over its wall
    time, as a share of the card's bf16 peak."""
    if not run.peaks:
        return None
    lo, hi = untraced(run)
    f = count_sum(run, flops, lo, hi)
    return 100.0 * f / (hi - lo) / run.peaks["bf16_flops"] if f else None


def roofline(run, op: str = "tasr::log_mel_spectrogram",
             bound: str = "log_mel"):
    """The op's roofline time over the device time the trace attributes to
    it: each unit's operations (count ``<bound>_flop``) at the card's f32
    peak or its bytes (``<bound>_bytes``) at its memory peak, whichever
    bounds, summed over the units begun in the traced part."""
    if run.trace is None or not run.peaks:
        return None
    dev_s = run.trace["op_device_s"].get(op, 0.0)
    lo, hi = run.trace_from, run.trace_to
    flop = run.spans.between(bound + "_flop", lo, hi, counts=True)
    moved = run.spans.between(bound + "_bytes", lo, hi, counts=True)
    need = sum(max(f / run.peaks["f32_flops"],
                   b / run.peaks["hbm_bytes_per_s"])
               for (_, f), (_, b) in zip(flop, moved))
    return 100.0 * need / dev_s if dev_s > 0 and need > 0 else None


def idle(run):
    if run.trace is None:
        return None
    window = run.trace_to - run.trace_from
    return 100.0 * (1.0 - run.trace["busy_s"] / window) if window > 0 \
        else None
