"""`ebf.attention_kernel_share`: the mean of the program's counter
`ebranchformer.attention_kernel` over the window's untraced part, None
where the program records none (as a program without the kernel); and on
a small E-Branchformer decode run through the harness on the CPU, where
the program takes its plain composition, 0 with one record a block a
batch."""

import time
from types import SimpleNamespace

import pytest
import torch

import tiny  # noqa: F401  (the harness on the path)
from benchlib import core, tracing
from test_bench_ebranchformer import small_files

from tensorflowasr_tpu_torch.utils import telemetry

NAME = "ebf.attention_kernel_share"
COUNTER = "ebranchformer.attention_kernel"


def reader():
    return core.load_module(core.BENCH / "layer_metrics" / f"{NAME}.py",
                            "bench_metric_" + NAME.replace(".", "_"))


@pytest.fixture()
def run():
    """Calls on the kernel, the kernel and the plain path in the untraced
    part; one plain call in the traced part."""
    telemetry.reset()
    t0 = time.perf_counter()
    for value in (1.0, 1.0, 0.0):
        telemetry.count(COUNTER, value, shared=True)
    trace_from = time.perf_counter()
    telemetry.count(COUNTER, 0.0, shared=True)
    yield SimpleNamespace(spans=tracing.Spans(), rec={}, t0=t0,
                          trace_from=trace_from,
                          trace_to=time.perf_counter(), peaks=None,
                          config={}, traffic={}, trace=None)
    telemetry.reset()


def test_reads_the_counters_mean_over_the_untraced_part(run):
    assert reader().read(run) == pytest.approx(2 / 3)


def test_without_records_gives_none(run, monkeypatch):
    telemetry.reset()
    assert reader().read(run) is None
    monkeypatch.delattr(telemetry, "between")
    assert reader().read(run) is None


def test_a_cpu_run_takes_the_plain_path_in_every_block():
    files = small_files()
    telemetry.reset()
    torch.manual_seed(0)
    res = core.run_cell(files, 2 ** 31 + 13, 1.0, False, torch.device("cpu"))
    assert res["correct"], res["checks"]
    res["summary"] = {"busy_s": 0.5, "launches": 10, "op_device_s": {},
                      "device_ops": [["k", 0.5]],
                      "idle_gaps": [["predict", 0.1]]}
    clock = res["clock"]
    clock.trace_from = clock.trace_to = clock.t_end
    metrics = core.per_layer(files, res, "cpu")
    assert metrics[NAME] == {"value": 0.0, "unit": "share"}
    # from the window's start on: the last batch, begun before the
    # window's end, records its later blocks after it
    rec = telemetry.between(COUNTER, clock.t0, time.perf_counter())
    blocks = files.config["model_config"]["num_blocks"]
    assert len(rec) == blocks * res["attempted"]
    telemetry.reset()
