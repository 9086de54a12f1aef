"""Kernels, copies and sets on the device a decoded E-Branchformer
batch."""

from benchlib import readers


def read(run):
    return readers.launches_per(run, "predict")
