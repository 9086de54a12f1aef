"""Offline (whole-file) ASR session.

Counterpart of ``tensorflowasr_tpu/serve/offline_session.py``: load a wav
at 16 kHz, cut it into ``chunk_samples`` pieces, run the block-streaming
ASR engine and decode. The VAD segmenter and the punctuation engine are not
ported yet: the session takes ``vad=None`` and ``punc=None`` only, and then
treats the whole wav as one segment, as the JAX session does without VAD.
"""

from __future__ import annotations

from typing import List

import numpy as np

from tensorflowasr_tpu_torch.serve.engines import ASREngine
from tensorflowasr_tpu_torch.utils.audio import read_wav

MIN_PIECE_SAMPLES = 400     # shorter trailing pieces are dropped


class OfflineASRSession:
    def __init__(self, asr: ASREngine, vad=None, punc=None,
                 sample_rate: int = 16000):
        if vad is not None or punc is not None:
            raise NotImplementedError(
                "the VAD and punctuation engines are not ported yet")
        self.asr = asr
        self.sample_rate = sample_rate

    def _decode_segment(self, seg_wav: np.ndarray) -> List[str]:
        chunk = self.asr.chunk_samples
        encs = [self.asr.extract_feature(seg_wav[s:s + chunk])
                for s in range(0, len(seg_wav), chunk)
                if len(seg_wav[s:s + chunk]) >= MIN_PIECE_SAMPLES]
        return self.asr.decode(encs)

    def transcribe_wav(self, wav: np.ndarray) -> List[dict]:
        """float32 waveform at ``sample_rate`` -> [{start_s, end_s, text}]."""
        text = "".join(self._decode_segment(wav))
        return [{"start_s": 0.0, "end_s": len(wav) / self.sample_rate,
                 "text": text}]

    def transcribe_file(self, path: str) -> List[dict]:
        wav, _ = read_wav(path, target_sr=self.sample_rate)
        return self.transcribe_wav(wav)
