"""Share of the traced seconds of E-Branchformer batch decoding with no
operation on the device."""

from benchlib import readers


def read(run):
    return readers.idle(run)
