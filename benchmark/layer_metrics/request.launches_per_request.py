"""Kernels, copies and sets on the device a file request."""

from benchlib import readers


def read(run):
    return readers.launches_per(run, "request")
