"""The readings the limits of ``correct`` are set from, for one cell, in
one process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--seconds 10] [--control 3] [--lanes N] [--out limits.jsonl]

For each seed: a run of the program at the cell's size with a short window,
judged as a benchmark run judges it (the lower reading), then for the first
``--control`` seeds the control, the plain reference computed a precision
below the configuration's (every product in fp8 where it states bf16, in
bf16 where it states f32) in the program's place (the upper reading), and
for a training cell the planted fault of half the batch left out and the
f32 reference with dropout masks from another stream. One JSON line a
seed. ``--lanes`` runs a streams cell at that many lanes in place of its
mix's (the knee sweep, with ``--control 0``).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

import torch  # noqa: E402

from benchlib import core  # noqa: E402
from reference import blocks  # noqa: E402

CONTROL = {"bfloat16": blocks.Prec("fp8", "fp8"),
           "float32": blocks.Prec("bf16", "bf16")}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--lanes", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    files = core.cell_files(args.workload)
    prec = CONTROL[files.config["dtype"]]
    dev = torch.device("cuda")
    print(f"card: {core.card_line()[1]}", flush=True)
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = core.run_cell(files, seed, args.seconds, False, dev,
                            {"lanes": args.lanes} if args.lanes else None)
        line = {"workload": args.workload, "seed": seed,
                "program": {k: v["value"] for k, v in res["checks"].items()},
                "correct": res["correct"], "setup_s": res["setup_s"],
                "end_to_end": res["end_to_end"]}
        drv = res["runner"]
        if i < args.control:
            line["control"] = drv.control(prec)
            if files.traffic["runner"] == "train":
                rows = files.traffic["batch_size"] // 2
                line["half_batch"] = drv.control(blocks.F32, rows=rows)
                line["other_masks"] = drv.control(
                    blocks.F32, generator_seed=seed + 1)
                line["bf16_twin"] = drv.control(blocks.Prec("bf16", "f32"))
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
        del res, drv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
