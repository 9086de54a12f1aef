"""Median host time of the Conformer's `conformer.stack` stage (subsampling
and blocks), ms a decoded batch."""

from benchlib import program_records


def read(run):
    return program_records.median_ms(run, "conformer.stack")
