"""Device time the trace puts under `tasr::conformer.ctc_head` and
`tasr::conformer.translator`, ms a decoded batch begun in the traced part."""

from benchlib import program_records


def read(run):
    return program_records.device_ms(
        run, ("tasr::conformer.ctc_head", "tasr::conformer.translator"),
        "predict")
