"""Slots advanced a pool dispatch, mean (batch occupancy)."""

from benchlib import readers


def read(run):
    return readers.ratio(run, "slots", "dispatches")
