"""Median host time of the fit loop's `_prepare_batch` (the numpy batch to the
device), ms a step.
"""

from benchlib import readers


def read(run):
    return readers.median_ms(run, "prepare")
