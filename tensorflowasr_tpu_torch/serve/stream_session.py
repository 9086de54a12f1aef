"""Streaming ASR session: the offline ConformerCTC under the VAD state
machine.

Counterpart of ``tensorflowasr_tpu/serve/stream_session.py`` (the reference
ASRSession, Inference/PythonInference/stream_asr_session.py:20-263 in
Z-yq/TensorflowASR). Feed 20 ms packets (pcm16 bytes or float32) through
``send``; ``TaskContent`` turns them into events:

- sentence begin   voice onset
- result change    a 0.5 s chunk encoded and cached (``enc_outputs``)
- inter break      a pause inside the utterance: decode the accumulated
                   prefix (punctuated from ``min_punc_chars`` chars)
- sentence end     the utterance ends: final decode + punctuation, reset

``final_send`` flushes the stream's end. Each encode pads the chunk to
``ASREngine.chunk_samples`` (one K1b 'same' launch at B = 1).
"""

from __future__ import annotations

import uuid
from typing import Optional

import numpy as np

from tensorflowasr_tpu_torch.serve.engines import (
    ASREngine,
    PuncEngine,
    VADEngine,
)
from tensorflowasr_tpu_torch.serve.vad_machine import TaskContent
from tensorflowasr_tpu_torch.utils.audio import read_pcm16


class StreamASRSession:
    def __init__(self, asr: ASREngine, vad: VADEngine,
                 punc: Optional[PuncEngine] = None,
                 session: str = "asr_1", sample_rate: int = 16000,
                 chunk_max_duration: float = 0.5, wait_sil: int = 5,
                 min_punc_chars: int = 5):
        self.session = session
        self.asr = asr
        self.punc = punc
        self.min_punc_chars = min_punc_chars
        self.sentence_id = 0
        self.task_content = TaskContent(
            vad.inference, chunk_max_duration=chunk_max_duration,
            sample_rate=sample_rate, wait_sil=wait_sil,
            frame_input=vad.frame_input,
            vad_downsample=max(1, sample_rate // 8000))

    def _resp(self, event_type: str, **kw) -> dict:
        return dict(session=self.session, event_type=event_type, **kw)

    def _decode_accumulated(self, flush_audio: bool = True):
        tc = self.task_content
        audio = np.asarray(tc.chunk, np.float32)
        enc_outputs = list(tc.enc_outputs)
        if len(audio) > 800:
            enc_output = self.asr.extract_feature(audio)
            result = self.asr.decode(enc_outputs + [enc_output])
            if (not flush_audio
                    and len(audio) >= tc.chunk_max_duration):
                tc.enc_outputs = enc_outputs + [enc_output]
        else:
            result = self.asr.decode(enc_outputs)
        if self.punc is not None and len(result) >= self.min_punc_chars:
            result = self.punc.punc_recover(result)
        return result

    def _sentence_end(self) -> dict:
        tc = self.task_content
        live = tc.live_result
        text = "".join(self._decode_accumulated(flush_audio=True))
        resp = self._resp(
            "sentence end", sentence_index=self.sentence_id,
            sentence_begin_time=int(live["start_time"] * 1000),
            sentence_end_time=int(live["end_time"] * 1000),
            best_text=text, task_id=str(uuid.uuid4()))
        self.sentence_id += 1
        tc.reset_live_result()
        return resp

    def send(self, audio_data) -> Optional[dict]:
        """audio_data: pcm16 bytes or a float32 waveform for one packet."""
        if isinstance(audio_data, (bytes, bytearray)):
            new_data = read_pcm16(bytes(audio_data))
        else:
            new_data = np.asarray(audio_data, np.float32)
        tc = self.task_content
        tc.parse(new_data)

        if tc.start_event:
            tc.start_event = 0
            return self._resp(
                "sentence begin", sentence_index=self.sentence_id,
                sentence_begin_time=int(tc.wav_length * 1000 - 200))

        if not tc.send_flag:
            return None

        if tc.sound_end and tc.send_flag:
            return self._sentence_end()

        if tc.inter_break and tc.sil_times == 1:
            tc.inter_break = 0
            live = tc.live_result
            text = "".join(self._decode_accumulated(flush_audio=False))
            tc.send_flag = 0
            tc.chunk_length_check()
            return self._resp(
                "inter break",
                sentence_begin_time=int(live["start_time"] * 1000),
                sentence_end_time=int(live["end_time"] * 1000),
                best_text=text, task_id=str(uuid.uuid4()))

        # result change: encode the chunk and cache it
        audio = np.asarray(tc.chunk, np.float32)
        tc.enc_outputs.append(self.asr.extract_feature(audio))
        tc.send_flag = 0
        live = tc.live_result
        tc.chunk_length_check()
        return self._resp(
            "result change",
            sentence_begin_time=int(live["start_time"] * 1000),
            best_text="")

    def final_send(self) -> Optional[dict]:
        """Flush at the stream's end."""
        tc = self.task_content
        tc.final_parse()
        if not tc.send_flag:
            return None
        return self._sentence_end()
