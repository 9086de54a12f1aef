"""Device time the trace puts under `tasr::conformer.stack` (subsampling
and blocks), ms a decoded batch begun in the traced part."""

from benchlib import program_records


def read(run):
    return program_records.device_ms(run, ("tasr::conformer.stack",),
                                     "predict")
