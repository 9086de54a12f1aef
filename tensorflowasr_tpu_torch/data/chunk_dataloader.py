"""ChunkConformer dataloader: the AM loader's batches plus the text-only
branch's extra labels.

Counterpart of ``tensorflowasr_tpu/data/chunk_dataloader.py``, with the same
batches for the same seed and corpus. The per-line pipeline is the AM
loader's, except that:

- char labels carry no ``</S>`` (the chunk model's char branch neither
  learns nor is scored on a stop token);
- every bucket's wav capacity is rounded up to whole chunks of the chunk
  model (``chunk_num`` mel frames), so the 'valid' chunk front sees whole
  chunks, and ``input_length`` counts encoder frames, chunks x
  ``sub_length``. This chunk is the model's; the AM loader's
  ``self.chunk`` is the streaming quantum of ``speech_config.streaming``;
- each item also samples an extra transcript for the ContextHelper's
  text-only branch.

The batch dict extends the AM loader's with extra_phones [B, Lcap],
extra_phone_length [B], extra_chars [B, Ucap], extra_char_length [B].
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from tensorflowasr_tpu_torch.data.am_dataloader import AMDataLoader, BucketSpec


class ChunkDataLoader(AMDataLoader):
    def __init__(self, config, phone_featurizer, text_featurizer,
                 chunk_num: int = 16, **kwargs):
        super().__init__(config, phone_featurizer, text_featurizer, **kwargs)
        self.append_char_endid = False
        self.chunk_samples = chunk_num * self.featurizer.hop_size
        self.sub_length = chunk_num // self.featurizer.reduction_factor
        for b in self.buckets:
            b.wav_cap += (-b.wav_cap) % self.chunk_samples

    def _input_length(self, n_samples: int) -> int:
        chunks = -(-n_samples // self.chunk_samples)
        return int(chunks * self.sub_length)

    def _extra_text(self, train: bool) -> Tuple[List[int], List[int]]:
        """An extra transcript's (phone ids, char ids) for the helper
        branch: the next line of the list whose tokens are all in the
        vocabularies."""
        for _ in range(50):
            with self._line_lock:
                line = self._next_line(train)
            try:
                _, txt = line.split("\t", 1)
            except ValueError:
                continue
            try:
                py = self.text_to_phones(txt)
            except Exception:        # the pinyin backend's errors vary
                continue
            if not self._check_valid(py, self.phone_featurizer):
                continue
            chars = (txt.split() if self.transcripts_are_pinyin
                     else list(txt))
            if not self._check_valid(chars, self.text_featurizer):
                continue
            return (self.phone_featurizer.extract(py),
                    self.text_featurizer.extract(chars))
        raise RuntimeError("could not sample a valid extra text line")

    def generate(self, train: bool = True,
                 bucket: Optional[BucketSpec] = None,
                 num_workers: int = 1) -> Dict[str, np.ndarray]:
        batch = super().generate(train, bucket, num_workers=num_workers)
        n = batch["wav"].shape[0]
        phone_cap, char_cap = batch["phones"].shape[1], batch["chars"].shape[1]
        ex_ph = np.zeros((n, phone_cap), np.int32)
        ex_ch = np.zeros((n, char_cap), np.int32)
        ex_ph_len = np.zeros((n,), np.int32)
        ex_ch_len = np.zeros((n,), np.int32)
        for i in range(n):
            # up to 20 draws for one that fits the bucket, else cut
            for _ in range(20):
                ph, ch = self._extra_text(train)
                if len(ph) <= phone_cap and len(ch) <= char_cap:
                    break
            ph, ch = ph[:phone_cap], ch[:char_cap]
            ex_ph[i, :len(ph)] = ph
            ex_ch[i, :len(ch)] = ch
            ex_ph_len[i] = len(ph)
            ex_ch_len[i] = len(ch)
        batch.update(extra_phones=ex_ph, extra_phone_length=ex_ph_len,
                     extra_chars=ex_ch, extra_char_length=ex_ch_len)
        return batch
