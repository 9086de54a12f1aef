"""Median host time of the engine's `engine.encode` span, ms a 0.48 s piece
(a B = 1 encode and its fetch)."""

from benchlib import program_records


def read(run):
    return program_records.median_ms(run, "engine.encode")
