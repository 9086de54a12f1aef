"""Pieces a batched engine encode carries, mean over the encodes (the
program's counter `engine.pieces`, one record a batched encode, padding rows
left out): how wide the file engine's batching is where it engages."""

from benchlib import program_records


def read(run):
    return program_records.mean_value(run, "engine.pieces")
