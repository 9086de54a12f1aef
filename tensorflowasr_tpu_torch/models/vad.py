"""CNN voice-activity-detection models (online causal / offline dilated).

Counterpart of ``tensorflowasr_tpu/models/vad.py``. Input is raw framed
waveform [B, n_frames, frame_input] (frame_input = 80 samples = 10 ms at
8 kHz); the output is (voice logits [B, n_frames, 1], the masked waveform
[B, n_frames, frame_input] = inputs * predicted mask). Submodule names are
the flax names, so ``models/convert.py`` maps the trees name by name.

Traps kept: ``OnlineVAD``'s convolutions are causal (2 zeros on the left);
``OfflineVAD``'s use kernel 5 at dilations 1, 2, 4, 8 with TF 'SAME'
padding, which at stride 1 is 2 * d zeros on each side; the ``fc`` and
``audio_voice_mask`` heads run in f32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowasr_tpu_torch.models.layers import Conv1D, Dense


class _VADHeads(nn.Module):
    """The two f32 heads both variants end with, over ``features``."""

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.features(x)
        return self.fc(h), x * self.audio_voice_mask(h)

    def infer(self, x: torch.Tensor) -> torch.Tensor:
        """Voice logits only: the exported inference head."""
        return self(x)[0]


class OnlineVAD(_VADHeads):
    """Causal variant, streamable frame by frame: Dense -> Dense -> causal
    Conv1D(k=3) -> Dense -> causal Conv1D(k=3) -> Dense -> heads."""

    def __init__(self, dmodel: int = 32, frame_input: int = 80,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dmodel, self.frame_input = dmodel, frame_input
        self.embed = Dense(frame_input, dmodel, dtype)
        self.dense1 = Dense(dmodel, dmodel, dtype)
        self.cnn1 = Conv1D(dmodel, 2 * dmodel, 3, (2, 0), dtype=dtype)
        self.dense2 = Dense(2 * dmodel, dmodel, dtype)
        self.cnn2 = Conv1D(dmodel, 2 * dmodel, 3, (2, 0), dtype=dtype)
        self.dense3 = Dense(2 * dmodel, dmodel, dtype)
        self.fc = Dense(dmodel, 1)
        self.audio_voice_mask = Dense(dmodel, frame_input)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, frame_input] -> the heads' input [B, N, dmodel]."""
        h = self.embed(x)
        h = F.relu(self.dense1(h))
        h = F.relu(self.cnn1(h))
        h = F.relu(self.dense2(h))
        h = F.relu(self.cnn2(h))
        return F.relu(self.dense3(h))


class OfflineVAD(_VADHeads):
    """Dilated non-causal variant: four Conv1D(k=5) at dilations 1, 2, 4,
    8 with 'SAME' padding between the dense layers."""

    DILATIONS = (1, 2, 4, 8)

    def __init__(self, dmodel: int = 32, frame_input: int = 80,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dmodel, self.frame_input = dmodel, frame_input
        self.embed = Dense(frame_input, dmodel, dtype)
        self.dense1 = Dense(dmodel, dmodel, dtype)
        for i, d in enumerate(self.DILATIONS):
            self.add_module(f"cnn{i + 1}", Conv1D(dmodel, dmodel, 5,
                                                  (2 * d, 2 * d), d, dtype))
        self.dense2 = Dense(dmodel, dmodel, dtype)
        self.fc = Dense(dmodel, 1)
        self.audio_voice_mask = Dense(dmodel, frame_input)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, frame_input] -> the heads' input [B, N, dmodel]."""
        h = self.embed(x)
        h = F.relu(self.dense1(h))
        for i in range(len(self.DILATIONS)):
            h = F.relu(getattr(self, f"cnn{i + 1}")(h))
        return F.relu(self.dense2(h))
