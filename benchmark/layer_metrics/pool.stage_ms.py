"""Median host time of a pool dispatch's `pool.stage` span: the advancing
slots' chunks and masks gathered and their three uploads, ms.
"""

from benchlib import program_records


def read(run):
    return program_records.median_ms(run, "pool.stage")
