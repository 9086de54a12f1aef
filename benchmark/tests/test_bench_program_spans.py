"""The readers of the port's own recorder (``benchlib/program_records.py``
and the per-layer metrics that use it) on a synthetic run: the program's
spans and counters made through ``tensorflowasr_tpu_torch.utils.telemetry``
inside the harness's spans, a trace reduction with device time under the
``tasr::conformer.*`` ranges. Each reader gets a number, and None where the
records are missing (as from a program without the recorder)."""

import time
from types import SimpleNamespace

import pytest

import tiny  # noqa: F401  (puts the benchmark on the path)
from benchlib import core, tracing

from tensorflowasr_tpu_torch.utils import telemetry

STREAMS = ("pool.dispatches_per_tick", "pool.stage_ms", "pool.enqueue_ms",
           "pool.fetch_ms", "pool.unpack_ms")
TRAIN = ("step.forward_ms", "step.loss_ms", "step.backward_ms",
         "step.optimizer_ms")
DECODE = ("predict.stack_ms", "predict.stack_device_ms", "predict.heads_ms",
          "predict.heads_device_ms")
REQUESTS = ("engine.encode_ms", "engine.encodes_per_request",
            "engine.decode_ms")
NEW = STREAMS + TRAIN + DECODE + REQUESTS
DEVICE = {"tasr::conformer.stack": 0.004, "tasr::conformer.ctc_head": 0.001,
          "tasr::conformer.translator": 0.002,
          "tasr::log_mel_spectrogram": 0.0005}


def reader(name):
    return core.load_module(core.BENCH / "layer_metrics" / f"{name}.py",
                            "bench_metric_" + name.replace(".", "_"))


def pause():
    time.sleep(0.0005)


def unit(spans):
    """One unit of each cell: a tick of 3 dispatches, a train step, a
    decoded batch, a request of 3 pieces."""
    with spans("tick"):
        for _ in range(3):
            for phase in ("stage", "enqueue", "fetch", "unpack"):
                with telemetry.span(f"pool.{phase}"):
                    pause()
        telemetry.count("pool.dispatches", 3)
    with spans("step"):
        for phase in ("forward", "loss", "backward", "optimizer"):
            with telemetry.span(f"step.{phase}"):
                pause()
    with spans("predict"):
        for stage in ("stack", "ctc_head", "translator"):
            with telemetry.span(f"conformer.{stage}", leaf=True,
                                shared=True):
                pause()
    with spans("request"):
        for _ in range(3):
            with telemetry.span("engine.encode", shared=True):
                pause()
        with telemetry.span("engine.decode", shared=True):
            pause()


@pytest.fixture()
def run():
    """Two units in the untraced part, one with a single dispatch, then two
    in the traced part."""
    telemetry.reset()
    spans = tracing.Spans()
    t0 = time.perf_counter()
    unit(spans)
    with telemetry.span("pool.stage"):
        pause()
    telemetry.count("pool.dispatches", 1)
    unit(spans)
    trace_from = time.perf_counter()
    unit(spans)
    unit(spans)
    yield SimpleNamespace(
        spans=spans, rec={}, t0=t0, trace_from=trace_from,
        trace_to=time.perf_counter(), peaks=None, config={}, traffic={},
        trace={"busy_s": 0.01, "launches": 100, "op_device_s": dict(DEVICE),
               "device_ops": [], "idle_gaps": []})
    telemetry.reset()


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_a_number(run, name):
    value = reader(name).read(run)
    assert isinstance(value, float) and value > 0, value


def test_the_counts_and_device_times(run):
    assert reader("pool.dispatches_per_tick").read(run) == \
        pytest.approx((3 + 1 + 3) / 3)
    assert reader("engine.encodes_per_request").read(run) == 3.0
    # two batches begun in the traced part
    assert reader("predict.stack_device_ms").read(run) == pytest.approx(2.0)
    assert reader("predict.heads_device_ms").read(run) == pytest.approx(1.5)
    heads = reader("predict.heads_ms").read(run)
    stack = reader("predict.stack_ms").read(run)
    assert heads >= 2 * 0.5 and stack >= 0.5


def test_span_medians_are_of_the_untraced_part(run):
    lo, hi = run.t0, run.trace_from
    got = telemetry.between("pool.stage", lo, hi)
    assert len(got) == 7
    assert reader("pool.stage_ms").read(run) == pytest.approx(
        1e3 * float(sorted(e - s for s, e in got)[3]))


@pytest.mark.parametrize("name", NEW)
def test_reader_without_records_gives_none(run, name, monkeypatch):
    telemetry.reset()
    run.trace["op_device_s"] = {"tasr::log_mel_spectrogram": 0.0005}
    assert reader(name).read(run) is None
    # a program whose telemetry module has no recorder
    monkeypatch.delattr(telemetry, "between")
    assert reader(name).read(run) is None
    run.trace = None
    assert reader(name).read(run) is None
