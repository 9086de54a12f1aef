"""Unpadded audio seconds of the train steps begun in the window's untraced
part over its wall time: the host-bound training rate, audio-s/s.
"""

from benchlib import readers


def read(run):
    lo, hi = readers.untraced(run)
    audio = readers.count_sum(run, "audio_s", lo, hi)
    return audio / (hi - lo) if audio and hi > lo else None
