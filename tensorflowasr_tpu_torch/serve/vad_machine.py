"""VAD state machines for serving.

Counterpart of ``tensorflowasr_tpu/serve/vad_machine.py`` (numpy, copied
with every constant):

- :class:`SilenceDetector`   the energy / sound-pressure-level gate
  (vad/online_vad.py:4-27 in Z-yq/TensorflowASR); ``build_asr_ops``
  answers the ``vad`` op with it when no VAD model is served
- :class:`TaskContent`       the streaming session's state machine
  (Inference/PythonInference/stream_asr_session.py:275-461): a VAD call
  every 0.1 s on the trailing ``(vad_time + 2) * sr`` samples, downsampled
  by ``vad_downsample`` to the VAD's 8 kHz; sound starts on >=
  ``start_thread`` voiced of the last 10 frames once 20 are recorded; a
  staged silence countdown (<= 8, <= 5, <= ``end_thread``) ends it after
  ``wait_sil`` stages; ``send_flag`` rises when the accumulated chunk
  reaches ``chunk_max_duration``
- :class:`OfflineVADSegmenter` whole-file segmentation -> [start, end)
  sample intervals, gaps < ``merge_gap`` s merged, segments longer than
  ``max_segment`` s re-split at their midpoints (vad/offline_vad.py:139-178)
"""

from __future__ import annotations

from typing import Callable, List, Tuple

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


class TaskContent:
    """Streaming VAD state machine. ``vad_infer`` maps a [1, N, frame]
    float array to per-frame logits; the 8 kHz VAD sees 16 kHz input
    downsampled by 2 (stream_asr_session.py:327-336)."""

    def __init__(self, vad_infer: Callable[[np.ndarray], np.ndarray],
                 chunk_max_duration: float = 0.5, sample_rate: int = 16000,
                 wait_sil: int = 5, vad_time: int = 1,
                 start_thread: int = 5, end_thread: int = 2,
                 frame_input: int = 80, vad_downsample: int = 2):
        self.vad_infer = vad_infer
        self.sr = sample_rate
        self.chunk_max_duration = int(chunk_max_duration * sample_rate)
        self.wait_sil = wait_sil
        self.vad_time = vad_time
        self.start_thread = start_thread
        self.end_thread = end_thread
        self.frame_input = frame_input
        self.vad_downsample = vad_downsample
        self.init_params()

    def init_params(self):
        self.chunk = np.array([], np.float32)
        self.wav_length = 0.0
        self.live_result = {"start_time": 0.0, "end_time": 0.0,
                            "live_text": "", "decoded_result": []}
        self.vad_point = 0.0
        self.voice_data = np.zeros(int(0.3 * self.sr), np.float32)
        self.inter_break = 0
        self.start_event = 0
        self.end_event = 0
        self.send_flag = 0
        self.sil_record: List[int] = []
        self.sil_times = 0
        self.sound_record: List[int] = []
        self.chunk_point = 0
        self.sound_start = 0
        self.sound_end = 0
        self.enc_outputs: List[np.ndarray] = []

    # -- VAD ----------------------------------------------------------------
    def vad(self, wav: np.ndarray) -> List[int]:
        data = wav[::self.vad_downsample]
        n = (len(data) // self.frame_input) * self.frame_input
        data = data[-n:].reshape(1, -1, self.frame_input)
        logits = self.vad_infer(np.asarray(data, np.float32))
        out = np.where(logits >= 0.0, 1, 0).tolist()
        return out[-int(10 * self.vad_time):]

    # -- per-packet update --------------------------------------------------
    def parse(self, new_data: np.ndarray):
        """new_data: float32 waveform in [-1, 1] (caller converts pcm16)."""
        self.wav_length += len(new_data) / self.sr
        if self.sound_start:
            self.chunk = np.concatenate([self.chunk, new_data])
        self.voice_data = np.hstack((self.voice_data, new_data))
        self.voice_data = self.voice_data[-int((self.vad_time + 2)
                                               * self.sr):]

        if self.wav_length - self.vad_point >= 0.1 * self.vad_time:
            pred = self.vad(self.voice_data)
            if self.sound_start:
                self.sil_record += pred
            else:
                self.sound_record += pred
            self.vad_point = self.wav_length

        if self.sound_start:
            if len(self.sil_record) >= 20:
                recent = int(np.sum(self.sil_record[-10:]))
                if recent <= 8 and self.sil_times == 0:
                    self.sil_times = 1
                    self.inter_break = 1
                    self.live_result["end_time"] = self.wav_length
                elif recent <= 5 and self.sil_times == 1:
                    self.sil_times = 2
                elif recent <= self.end_thread and self.sil_times >= 2:
                    self.sil_times += 1
                else:
                    self.sil_times = 0
                self.sil_record = self.sil_record[-10:]
            if self.sil_times == self.wait_sil:
                self.sound_end = 1
                self.end_event = 1
                self.live_result["end_time"] = (
                    self.wav_length - self.wait_sil * 0.1 + 0.1)
                self.sil_record = []
                self.sound_start = 0
                self.sil_times = 0
                self.inter_break = 0
                self.send_flag = 1
            elif len(self.chunk) - self.chunk_point >= \
                    self.chunk_max_duration:
                self.send_flag = 1
                self.chunk_point = len(self.chunk)
            elif len(self.chunk) - self.chunk_point == 0:
                self.send_flag = 0
        else:
            if len(self.sound_record) == 20:
                if np.sum(self.sound_record[-10:]) >= self.start_thread:
                    self.sound_start = 1
                    self.start_event = 1
                    self.sound_record = []
                    self.chunk = self.voice_data[-int(self.sr * 0.2):]
                    self.live_result["start_time"] = self.wav_length - 0.2
                else:
                    self.sound_record = self.sound_record[-10:]

    def final_parse(self):
        if len(self.chunk) > 800 and self.sound_start:
            self.send_flag = 1
            self.sound_end = 1
            self.live_result["end_time"] = self.wav_length

    # -- chunk bookkeeping --------------------------------------------------
    def reset_chunk(self):
        self.chunk = np.array([], np.float32)
        self.chunk_point = 0

    def reset_chunk_end(self):
        self.reset_chunk()
        self.enc_outputs = []

    def chunk_length_check(self):
        if len(self.chunk) >= self.chunk_max_duration:
            self.reset_chunk()

    def reset_live_result(self):
        self.reset_chunk_end()
        self.live_result = {"start_time": 0.0, "end_time": 0.0,
                            "live_text": "", "decoded_result": []}
        self.end_event = 0
        self.sound_end = 0
        self.sound_start = 0
        self.send_flag = 0


class OfflineVADSegmenter:
    """Whole-file segmentation (vad/offline_vad.py:139-178): VAD frame
    probabilities -> voiced intervals; gaps < ``merge_gap`` s merged;
    segments > ``max_segment`` s resplit at their midpoints."""

    def __init__(self, vad_infer: Callable[[np.ndarray], np.ndarray],
                 sample_rate: int = 8000, frame_input: int = 80,
                 merge_gap: float = 0.1, max_segment: float = 15.0,
                 threshold: float = 0.0):
        self.vad_infer = vad_infer
        self.sr = sample_rate
        self.frame_input = frame_input
        self.merge_gap = merge_gap
        self.max_segment = max_segment
        self.threshold = threshold

    def segment(self, wav: np.ndarray) -> List[Tuple[int, int]]:
        n = (len(wav) // self.frame_input) * self.frame_input
        if n == 0:
            return []
        frames = wav[:n].reshape(1, -1, self.frame_input)
        logits = self.vad_infer(np.asarray(frames, np.float32))
        voiced = logits >= self.threshold
        edges = np.diff(voiced.astype(np.int8), prepend=0, append=0)
        starts = np.nonzero(edges == 1)[0] * self.frame_input
        ends = np.nonzero(edges == -1)[0] * self.frame_input
        segs = list(zip(starts.tolist(), ends.tolist()))
        return self.recover(segs)

    def recover(self, segs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
        if not segs:
            return []
        merged: List[List[int]] = [list(segs[0])]
        gap = int(self.merge_gap * self.sr)
        for s, e in segs[1:]:
            if s - merged[-1][1] < gap:
                merged[-1][1] = e
            else:
                merged.append([s, e])
        out: List[Tuple[int, int]] = []
        cap = int(self.max_segment * self.sr)
        stack = [tuple(m) for m in merged]
        while stack:
            s, e = stack.pop(0)
            if e - s > cap:
                mid = (s + e) // 2
                stack = [(s, mid), (mid, e)] + stack
            else:
                out.append((s, e))
        return out
