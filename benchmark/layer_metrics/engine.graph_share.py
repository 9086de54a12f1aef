"""Share of the Conformer's stage calls (the engine's encodes through the
stack, its decodes through the CTC head and the translator) in the
requests cell that replayed a captured CUDA graph: the mean of the
program's counter `conformer.graph`, one record a stage call, 1 on a
replay and 0 on an eager body. None where the program records no such
counter (as a program without the graphs)."""

from benchlib import program_records


def read(run):
    return program_records.mean_value(run, "conformer.graph")
