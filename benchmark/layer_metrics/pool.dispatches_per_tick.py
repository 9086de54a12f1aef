"""Dispatches a pool tick ran, mean over the ticks that dispatched (the
program's counter `pool.dispatches`): 1 keeps pace with real time, more is a
backlog the tick works off."""

from benchlib import program_records


def read(run):
    return program_records.mean_value(run, "pool.dispatches")
