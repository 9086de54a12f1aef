"""One run of one cell: read the manifest and the cell's files, check the
card, set up the runner named by the traffic mix, measure the window, read
the per-layer metrics of a traced run, judge the outputs against the plain
reference, and print the result as the last line of standard output.

Everything a cell needs is found by name:

- ``BENCHMARK.json`` -> the cell, its configuration and its traffic mix;
- ``configs/<file>`` (the configuration's ``file``) -> sizes, dtype,
  weight law, calibration and the limits of the comparison per runner;
- ``traffic/<traffic>.json`` -> the mix's parameters and its ``runner``;
- ``runners/<runner>.py`` -> the loop that drives the program's entry;
- ``layer_metrics/<metric>.py`` -> one per-layer metric's reader.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

from benchlib import judge, tracing

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tensorflowasr_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell_files(workload: str, manifest: dict = None) -> SimpleNamespace:
    """The cell's entry, its configuration file's contents, its traffic mix,
    and the end-to-end and per-layer metrics that it reports."""
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])
    mix = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")

    def reported(metric):
        return workload in metric.get("workloads", [workload])

    return SimpleNamespace(
        cell=cell, config=config, traffic=mix,
        end_to_end=[m for m in manifest["end_to_end"] if reported(m)],
        per_layer=[m for m in manifest["per_layer"] if reported(m)])


def card_line() -> tuple:
    """(name, power limit) as nvidia-smi reads them, or the torch name."""
    import torch
    name = torch.cuda.get_device_name()
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        line = f"{name}, power limit not read"
    return name, line


def peaks_for(kind: str):
    table = load_json(BENCH / "benchlib" / "peaks.json")
    for key, peaks in table.items():
        if key in kind:
            return peaks
    return None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(files, seed: int, seconds: float, trace: bool, device,
             overrides: dict = None, fault: str = None, t_start=None):
    """Set up, measure and judge one run; returns the result dict (without
    printing). ``overrides`` replaces traffic keys (tests, the knee sweep
    of ``calibrate.py``);
    ``fault`` plants a fault under the timed path (tests only)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    mix = dict(files.traffic, **(overrides or {}))
    runner_mod = load_module(BENCH / "runners" / f"{mix['runner']}.py",
                             f"bench_runner_{mix['runner']}")
    spans = tracing.Spans()
    limits = dict(files.config["limits"][mix["runner"]],
                  **mix.get("limits", {}))
    ctx = SimpleNamespace(config=files.config, traffic=mix, seed=seed,
                          device=device, spans=spans, fault=fault,
                          seconds=seconds, limits=limits)
    drv = runner_mod.Runner(ctx)
    t_setup = time.perf_counter()
    drv.setup()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    print(f"setup: {setup_s:.3f} s, of which the runner's "
          f"{time.perf_counter() - t_setup:.3f} s "
          + " ".join(f"{k} {v:.3f}" for k, v in getattr(drv, "phases", {})
                     .items()), file=sys.stderr, flush=True)
    # what set-up left is not scanned by the collector in the window
    gc.collect()
    gc.freeze()
    clock = tracing.WindowClock(seconds, trace, device)
    rec = drv.window(clock)
    t = time.perf_counter()
    clock.stop_trace()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    rec["memory_peak_bytes"] = peak
    summary = None
    if clock.prof is not None:
        t_stop = time.perf_counter()
        summary = tracing.summarize(clock.prof)
        t_end = time.perf_counter()
        print(f"trace: {clock.trace_to - clock.trace_from:.3f} s traced, "
              f"{summary['launches']} device operations; stop "
              f"{t_stop - t:.1f} s, reduction {t_end - t_stop:.1f} s",
              file=sys.stderr, flush=True)
    numbers, failed = drv.judge(rec)
    checks = judge.verdict(numbers, limits)
    out = {"setup_s": setup_s, "rec": rec, "checks": checks,
           "correct": judge.passed(checks), "attempted": rec["attempted"],
           "failed": failed, "peak": peak, "summary": summary,
           "clock": clock, "spans": spans, "runner": drv}
    out["end_to_end"] = drv.end_to_end(rec)
    return out


def per_layer(files, res, kind: str) -> dict:
    """Each reported per-layer metric's reader over the run; a reader that
    finds nothing returns None and the metric is left out."""
    clock = res["clock"]
    run = SimpleNamespace(
        spans=res["spans"], rec=res["rec"], trace=res["summary"],
        t0=clock.t0, trace_from=clock.trace_from or clock.t_end,
        trace_to=clock.trace_to or clock.t_end, peaks=peaks_for(kind),
        config=files.config, traffic=files.traffic)
    out = {}
    for m in files.per_layer:
        reader = load_module(BENCH / "layer_metrics" / f"{m['name']}.py",
                             "bench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(run)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def assemble(files, res, trace: bool, kind: str, chips: int) -> dict:
    """The result line: the cell's end-to-end metrics (or, traced, its
    per-layer ones), the device, and the numbers compared with their
    limits under the last key."""
    if trace:
        metrics = per_layer(files, res, kind)
    else:
        metrics = {m["name"]: {"value": float(res["end_to_end"][m["name"]]),
                               "unit": m["unit"]}
                   for m in files.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": res["setup_s"], "unit": "s"}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(res["peak"])}
    result = {"correct": bool(res["correct"]),
              "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics,
              "device": device}
    if trace:
        s = res["summary"]
        device["busy_s"] = s["busy_s"]
        device["window_s"] = res["clock"].trace_to - res["clock"].trace_from
        result["breakdown"] = {"device_ops": s["device_ops"],
                               "idle_gaps": s["idle_gaps"]}
    result["checks"] = res["checks"]
    return result


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    files = cell_files(args.workload)
    import torch
    chips = int(files.cell["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"this cell needs {chips} CUDA card(s); found {found}; no "
              "result", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, line = card_line()
    print(f"card: {line}; host cores {sorted(os.sched_getaffinity(0))}, "
          f"{torch.get_num_threads()} torch thread(s)", file=sys.stderr,
          flush=True)
    res = run_cell(files, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda"), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}; no result", file=sys.stderr)
        return 4
    result = assemble(files, res, bool(args.trace), kind, chips)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
