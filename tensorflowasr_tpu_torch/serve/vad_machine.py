"""VAD gates for serving.

Counterpart of ``tensorflowasr_tpu/serve/vad_machine.py``. Only
:class:`SilenceDetector`, the energy (sound-pressure-level) gate, is ported:
``serve/model_server.py::build_asr_ops`` answers the ``vad`` op with it
until a VAD model is. The streaming state machine (``TaskContent``) and the
offline segmenter come with the VAD models.
"""

from __future__ import annotations

import numpy as np


class SilenceDetector:
    """Energy-based silence gate (vad/online_vad.py:4-27 in
    Z-yq/TensorflowASR)."""

    def __init__(self, threshold: float = 20.0, bits_per_sample: int = 16):
        self.threshold = threshold
        self.normal = 2.0 ** (bits_per_sample - 1)
        self.cur_spl = 0.0

    def sound_pressure_level(self, chunk: np.ndarray) -> float:
        energy = np.sum((chunk * self.normal) ** 2)
        value = np.sqrt(energy) / (len(chunk) + 1e-12)
        return float(20.0 * np.log(value + 1e-12))

    def is_silence(self, chunk: np.ndarray) -> bool:
        self.cur_spl = self.sound_pressure_level(chunk)
        return self.cur_spl < self.threshold
