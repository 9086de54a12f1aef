"""`engine.encode` spans begun inside a file request's `request` span, mean
over the requests: the pieces a request encodes."""

from benchlib import program_records


def read(run):
    return program_records.within(run, "request", ("engine.encode",),
                                  "count")
