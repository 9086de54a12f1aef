"""Median host time of a pool dispatch's `pool.enqueue` span: the step's
enqueue (`packed_step`), ms.
"""

from benchlib import program_records


def read(run):
    return program_records.median_ms(run, "pool.enqueue")
