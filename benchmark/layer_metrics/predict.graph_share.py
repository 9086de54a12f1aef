"""Share of the Conformer family's stage calls (the stack, the CTC head,
the translator) in the decode cells that replayed a captured CUDA graph:
the mean of the program's counter `conformer.graph`, one record a stage
call, 1 on a replay and 0 on an eager body. None where the program records
no such counter (as a program without the graphs)."""

from benchlib import program_records


def read(run):
    return program_records.mean_value(run, "conformer.graph")
