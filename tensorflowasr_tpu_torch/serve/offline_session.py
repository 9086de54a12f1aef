"""Offline (whole-file) ASR session.

Counterpart of ``tensorflowasr_tpu/serve/offline_session.py``: load a wav at
16 kHz, segment it with the offline VAD at 8 kHz (every ``vad_downsample``-th
sample; the segments scale back by the same factor), then decode each
segment with the block-streaming ASR engine in ``chunk_samples`` pieces and
punctuate results of at least ``min_punc_chars`` chars. Without a VAD
engine the whole wav is one segment.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from tensorflowasr_tpu_torch.serve.engines import (
    ASREngine,
    PuncEngine,
    VADEngine,
)
from tensorflowasr_tpu_torch.serve.vad_machine import OfflineVADSegmenter
from tensorflowasr_tpu_torch.utils.audio import read_wav

MIN_PIECE_SAMPLES = 400     # shorter trailing pieces are dropped


class OfflineASRSession:
    def __init__(self, asr: ASREngine, vad: Optional[VADEngine] = None,
                 punc: Optional[PuncEngine] = None,
                 sample_rate: int = 16000, vad_sample_rate: int = 8000,
                 min_punc_chars: int = 5):
        self.asr = asr
        self.punc = punc
        self.sample_rate = sample_rate
        self.vad_downsample = max(1, sample_rate // vad_sample_rate)
        self.min_punc_chars = min_punc_chars
        self.segmenter = (OfflineVADSegmenter(
            vad.inference, sample_rate=vad_sample_rate,
            frame_input=vad.frame_input) if vad is not None else None)

    def _decode_segment(self, seg_wav: np.ndarray) -> List[str]:
        chunk = self.asr.chunk_samples
        encs = [self.asr.extract_feature(seg_wav[s:s + chunk])
                for s in range(0, len(seg_wav), chunk)
                if len(seg_wav[s:s + chunk]) >= MIN_PIECE_SAMPLES]
        result = self.asr.decode(encs)
        if self.punc is not None and len(result) >= self.min_punc_chars:
            result = self.punc.punc_recover(result)
        return result

    def transcribe_wav(self, wav: np.ndarray) -> List[dict]:
        """float32 waveform at ``sample_rate`` -> [{start_s, end_s, text}]
        for each segment."""
        if self.segmenter is not None:
            segs = [(s * self.vad_downsample, e * self.vad_downsample)
                    for s, e in self.segmenter.segment(
                        wav[::self.vad_downsample])]
        else:
            segs = [(0, len(wav))]
        return [{"start_s": s / self.sample_rate,
                 "end_s": e / self.sample_rate,
                 "text": "".join(self._decode_segment(wav[s:e]))}
                for s, e in segs]

    def transcribe_file(self, path: str) -> List[dict]:
        wav, _ = read_wav(path, target_sr=self.sample_rate)
        return self.transcribe_wav(wav)
