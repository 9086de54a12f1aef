"""Model FLOPs of the E-Branchformer predict steps at each batch's padded
shape (`benchlib/ebranchformer_flops.py`) over the window's wall time,
share of the bf16 peak."""

from benchlib import readers


def read(run):
    return readers.mfu(run)
