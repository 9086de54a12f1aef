"""Model FLOPs of the train steps (3 x forward at each batch's padded shape)
over the window's wall time, share of the bf16 peak.
"""

from benchlib import readers


def read(run):
    return readers.mfu(run)
