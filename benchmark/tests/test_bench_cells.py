"""Whole runs of every cell at a size the CPU holds, through the harness
(set-up, window, judge) with the look for a card skipped: a sound run is
correct, and each fault the cell can have, planted under the timed path,
makes it come out not correct. A training fault acts from the window on,
so the steps of set-up that the reference follows stay sound and the step
after the window has to show it. One chip a cell, so no exchange between
chips to leave out."""

import json

import pytest

import tiny
from benchlib import core

CELLS = ("conformer_s.train", "conformer_s.decode", "conformer_s.requests",
         "chunk_conformer_s.streams")
FAULTS = [("conformer_s.train", "no_update"),
          ("conformer_s.train", "half_batch"),
          ("conformer_s.decode", "alter_token"),
          ("conformer_s.requests", "alter_token"),
          ("chunk_conformer_s.streams", "alter_token")]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = tiny.run(cell, seconds=2.0 if "streams" in cell else 1.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(cell, fault):
    res = tiny.run(cell, seconds=2.0 if "streams" in cell else 1.0,
                   fault=fault)
    assert not res["correct"], res["checks"]
    if "train" in cell:
        checks = res["checks"]
        assert checks["grad_gap"]["value"] <= checks["grad_gap"]["limit"]
        assert checks["update_gap"]["value"] <= checks["update_gap"]["limit"]
        assert any(c["value"] > c["limit"] for k, c in checks.items()
                   if k.startswith("last_"))


def test_result_line_keys():
    files = tiny.small(core.cell_files("conformer_s.decode"))
    import torch
    res = core.run_cell(files, 5, 1.0, False, torch.device("cpu"))
    line = core.assemble(files, res, False, "cpu", 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"decode_audio_s_per_s", "setup_s"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(line))


def test_traced_line_keys():
    files = tiny.small(core.cell_files("conformer_s.decode"))
    import torch
    res = core.run_cell(files, 5, 1.0, False, torch.device("cpu"))
    res["summary"] = {"busy_s": 0.5, "launches": 10, "op_device_s": {},
                      "device_ops": [["k", 0.5]],
                      "idle_gaps": [["predict", 0.1]]}
    res["clock"].trace_from = res["clock"].t0 + 0.5
    res["clock"].trace_to = res["clock"].t_end
    line = core.assemble(files, res, True, "cpu", 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert "decode.launches_per_batch" in line["metrics"]
    assert "mfu.decode" not in line["metrics"]     # no peaks for a CPU


def test_train_line_reports_the_peak_and_the_rate_per_layer():
    files = tiny.small(core.cell_files("conformer_s.train"))
    import torch
    res = core.run_cell(files, 5, 1.0, False, torch.device("cpu"))
    line = core.assemble(files, res, False, "cpu", 1)
    assert set(line["metrics"]) == {"train_memory_peak_gb", "setup_s"}
    assert line["metrics"]["train_memory_peak_gb"]["value"] == \
        line["device"]["memory_peak_bytes"] / 1e9
    res["summary"] = {"busy_s": 0.5, "launches": 10, "op_device_s": {},
                      "device_ops": [["k", 0.5]],
                      "idle_gaps": [["step", 0.1]]}
    res["clock"].trace_from = res["clock"].t_end
    res["clock"].trace_to = res["clock"].t_end
    traced = core.assemble(files, res, True, "cpu", 1)["metrics"]
    rate = res["rec"]["audio_s"] / res["rec"]["wall_s"]
    assert traced["train.audio_s_per_s"]["value"] == pytest.approx(rate,
                                                                   rel=0.5)


def test_without_a_card_there_is_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = core.main(["--workload", "conformer_s.decode", "--seed", "1",
                    "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
