"""Kernels, copies and sets on the device a pool dispatch."""

from benchlib import readers


def read(run):
    return readers.launches_per(run, "dispatches", counted=True)
