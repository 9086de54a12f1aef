"""Median host time of the engine's `engine.decode` span (join the rows,
CTC head, greedy, translator, fetch), ms a request."""

from benchlib import program_records


def read(run):
    return program_records.median_ms(run, "engine.decode")
