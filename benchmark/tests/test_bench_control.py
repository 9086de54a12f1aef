"""On the card, at the cell's own size: the control (the plain reference a
precision below the configuration's, fp8 products for bf16, in the
program's place) fails at least one of the cell's limits on three seeds,
while the program's own run passes. Skips without a card."""

import pytest
import torch

import tiny  # noqa: F401
from benchlib import core
from reference import blocks

CELLS = ("conformer_s.train", "chunk_conformer_s.streams",
         "conformer_s.decode", "conformer_s.requests")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size")
    files = core.cell_files(cell)
    limits = files.config["limits"][files.traffic["runner"]]
    for seed in (101, 2 ** 31 + 5, 3 ** 19):
        res = core.run_cell(files, seed, 12.0, False, torch.device("cuda"))
        assert res["correct"], res["checks"]
        got = res["runner"].control(blocks.Prec("fp8", "fp8"))
        assert any(got[k] > limits[k] for k in limits), got
