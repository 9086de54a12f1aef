"""Median host time of a pool dispatch (upload, step, fetch): each `tick()`
span over the dispatches it made, ms.
"""

from benchlib import readers


def read(run):
    return readers.median_ms(run, "tick", per="dispatches")
