"""Median host time of a pool dispatch's `pool.fetch` span: the fetch of
the packed ids, the host's wait on the device and the copy, ms.
"""

from benchlib import program_records


def read(run):
    return program_records.median_ms(run, "pool.fetch")
