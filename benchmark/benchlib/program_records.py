"""What the per-layer readers take from the port's own recorder
(``tensorflowasr_tpu_torch.utils.telemetry``): its spans and counters, kept
on the same host clock as the harness's spans and read over the window's
untraced part, and the device time a trace puts under its ``tasr::`` stage
ranges. A program without the recorder, or without a record of the name,
gives None, and the metric is left out of the line."""

from __future__ import annotations

import numpy as np

from benchlib import readers


def records(name: str, lo: float, hi: float):
    """[n, 2] of the name's records begun in ``[lo, hi)`` (a span's start
    and end, a counter's time and value), or None."""
    try:
        from tensorflowasr_tpu_torch.utils import telemetry
    except ImportError:
        return None
    between = getattr(telemetry, "between", None)
    if between is None:
        return None
    rec = np.asarray(between(name, lo, hi), dtype=np.float64)
    return rec if rec.ndim == 2 and len(rec) else None


def median_ms(run, name: str):
    """Median duration of a span, ms."""
    rec = records(name, *readers.untraced(run))
    if rec is None:
        return None
    return 1e3 * float(np.median(rec[:, 1] - rec[:, 0]))


def mean_value(run, name: str):
    """Mean value of a counter's records."""
    rec = records(name, *readers.untraced(run))
    return None if rec is None else float(np.mean(rec[:, 1]))


def within(run, unit: str, names, how: str):
    """Over each harness span ``unit`` begun in the untraced part: the
    records of ``names`` begun inside it, their summed durations in ms
    (``how="ms"``, the median over the units) or their number
    (``how="count"``, the mean over the units)."""
    lo, hi = readers.untraced(run)
    units = run.spans.between(unit, lo, hi)
    found = [r for r in (records(n, lo, np.inf) for n in names)
             if r is not None]
    if not units or not found:
        return None
    rec = np.concatenate(found)
    rec = rec[np.argsort(rec[:, 0])]
    per = []
    for s, e in units:
        i, j = np.searchsorted(rec[:, 0], [s, e])
        inside = rec[i:j]
        per.append(len(inside) if how == "count"
                   else 1e3 * float((inside[:, 1] - inside[:, 0]).sum()))
    return float(np.mean(per)) if how == "count" else float(np.median(per))


def device_ms(run, ops, unit: str):
    """Device time the trace puts under the ``tasr::`` ranges ``ops``, ms
    a harness span ``unit`` begun in the traced part."""
    if run.trace is None:
        return None
    dev = run.trace.get("op_device_s", {})
    found = [dev[op] for op in ops if op in dev]
    n = len(run.spans.between(unit, run.trace_from, run.trace_to))
    return 1e3 * sum(found) / n if found and n else None
