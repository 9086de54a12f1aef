"""Host time of the `conformer.ctc_head` and `conformer.translator` stages
begun inside a decoded batch's `predict` span, summed a batch, the median
over the batches, ms."""

from benchlib import program_records


def read(run):
    return program_records.within(
        run, "predict", ("conformer.ctc_head", "conformer.translator"), "ms")
