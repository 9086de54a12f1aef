"""Device time the trace puts under `tasr::ebranchformer.stack` (the conv
subsampling, the relative positions and the 17 E-Branchformer blocks),
ms a decoded batch begun in the traced part."""

from benchlib import program_records


def read(run):
    return program_records.device_ms(run, ("tasr::ebranchformer.stack",),
                                     "predict")
