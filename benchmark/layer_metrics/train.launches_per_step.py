"""Kernels, copies and sets on the device a train step."""

from benchlib import readers


def read(run):
    return readers.launches_per(run, "step")
