"""Cells at a size a CPU test holds: the shipped configuration files with
small widths and depths, and small traffic, run through the harness on the
CPU (the port sends its kernels' work to their plain versions there)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from benchlib import core  # noqa: E402

SMALL_STACK = dict(dmodel=16, head_size=8, num_heads=2, kernel_size=4,
                   win_front=6)


def small(files):
    """The cell's files with small sizes (f32 compute, so that the program
    and the reference agree to rounding)."""
    files = copy.deepcopy(files)
    c = files.config
    c["dtype"] = "float32"
    c["num_phone_classes"], c["num_char_classes"] = 11, 17
    mc = c["model_config"]
    if "ChunkConformerFront" in mc:
        mc["ChunkConformerFront"]["dmodel"] = 16
        for key in ("ChunkConformerEncoder", "ChunkCTCPicker",
                    "ChunkCTCDecoder", "ContextHelper"):
            mc[key].update(SMALL_STACK, num_blocks=1)
    else:
        mc.update(dmodel=16, num_blocks=1, head_size=8, num_heads=2,
                  kernel_size=4, ctcdecoder_kernel_size=4,
                  translator_num_blocks=1, translator_kernel_size=4)
        c["running_config"]["log_interval_steps"] = 2
    t = files.traffic
    law = {"dist": "lognormal", "median": 0.8, "sigma": 0.35, "min": 0.3,
           "max": 2.0}
    t["duration_s"] = law
    if t["runner"] in ("train", "decode"):
        t.update(batch_size=4, distinct_batches=4, buckets_s=[1, 2],
                 judged_batches=2)
    elif t["runner"] == "requests":
        t.update(distinct_files=3, judged_requests=2)
    elif t["runner"] == "streams":
        t.update(slots=4, lanes=3, distinct_utterances=4, judged_streams=2,
                 duration_s=dict(law, min=0.3, max=1.0), gap_s=[0.0, 0.1])
    return files


def run(workload: str, seconds: float = 1.0, seed: int = 2 ** 31 + 7,
        fault: str = None):
    torch.manual_seed(0)
    files = small(core.cell_files(workload))
    return core.run_cell(files, seed, seconds, False, torch.device("cpu"),
                         fault=fault)
