"""Median host time of a pool dispatch's `pool.unpack` span: each advancing
slot's ids taken from the packed fetch, ms.
"""

from benchlib import program_records


def read(run):
    return program_records.median_ms(run, "pool.unpack")
