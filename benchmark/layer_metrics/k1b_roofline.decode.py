"""The log-mel's (K1b's) roofline time at each decoded batch's shape over the
device time under `tasr::log_mel_spectrogram`.
"""

from benchlib import readers


def read(run):
    return readers.roofline(run)
