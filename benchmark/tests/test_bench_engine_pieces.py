"""`engine.pieces_per_encode`: the mean of the program's counter
`engine.pieces` over the window's untraced part, None where the program
records none (as a program without batched encodes); and on a small
requests run through the harness, one encode a request carrying all of its
pieces."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tiny
from benchlib import core, tracing

from tensorflowasr_tpu_torch.utils import telemetry

NAME = "engine.pieces_per_encode"


def reader(name=NAME):
    return core.load_module(core.BENCH / "layer_metrics" / f"{name}.py",
                            "bench_metric_" + name.replace(".", "_"))


def request(spans, pieces):
    with spans("request"):
        with telemetry.span("engine.encode", shared=True):
            telemetry.count("engine.pieces", pieces, shared=True)
        with telemetry.span("engine.decode", shared=True):
            pass


@pytest.fixture()
def run():
    """Requests of 3, 5 and 10 pieces in the untraced part, one of 30 in
    the traced part."""
    telemetry.reset()
    spans = tracing.Spans()
    t0 = time.perf_counter()
    for n in (3, 5, 10):
        request(spans, n)
    trace_from = time.perf_counter()
    request(spans, 30)
    yield SimpleNamespace(spans=spans, rec={}, t0=t0, trace_from=trace_from,
                          trace_to=time.perf_counter(), peaks=None,
                          config={}, traffic={}, trace=None)
    telemetry.reset()


def test_reads_the_counters_mean_over_the_untraced_part(run):
    assert reader().read(run) == pytest.approx(6.0)
    assert reader("engine.encodes_per_request").read(run) == 1.0


def test_without_records_gives_none(run, monkeypatch):
    telemetry.reset()
    assert reader().read(run) is None
    monkeypatch.delattr(telemetry, "between")
    assert reader().read(run) is None


def test_a_request_is_one_encode_of_all_its_pieces():
    files = tiny.small(core.cell_files("conformer_s.requests"))
    telemetry.reset()
    torch.manual_seed(0)
    res = core.run_cell(files, 2 ** 31 + 7, 1.0, False, torch.device("cpu"))
    assert res["correct"], res["checks"]
    res["summary"] = {"busy_s": 0.5, "launches": 10, "op_device_s": {},
                      "device_ops": [["k", 0.5]],
                      "idle_gaps": [["request", 0.1]]}
    clock = res["clock"]
    clock.trace_from = clock.trace_to = clock.t_end
    metrics = core.per_layer(files, res, "cpu")
    assert metrics["engine.encodes_per_request"]["value"] == 1.0
    pieces = telemetry.between("engine.pieces", clock.t0, clock.t_end)
    assert len(pieces) and np.all(pieces[:, 1] >= 1)
    assert metrics[NAME] == {"value": float(np.mean(pieces[:, 1])),
                             "unit": "pieces"}
    telemetry.reset()
