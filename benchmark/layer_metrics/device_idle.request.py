"""Share of the traced seconds of file requests with no operation on the
device.
"""

from benchlib import readers


def read(run):
    return readers.idle(run)
