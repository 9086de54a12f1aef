"""Raw-waveform auxiliary encoder (``WavePickModel``), added to the
subsampled mel features when ``add_wav_info`` is on.

Counterpart of ``tensorflowasr_tpu/models/wav_model.py``: a strided conv
pyramid that downsamples raw audio by the total hop (hop x reduction
factor, factorised into at most 4 strides), so that its frames line up
with ``ConvSubsampling``'s.

    DepthwiseConv1D(k=7, s=s0, SAME) -> Conv1D(32, k=1) -> LeakyReLU ->
    [Conv1D(min(32 (i+1), dout), k=3, s=si, SAME) -> ResidualStack]* ->
    Conv1D(dout, k=7, SAME)

``ResidualStack`` = LeakyReLU -> reflect pad -> Conv1D(k=5,
VALID) -> LeakyReLU -> Conv1D(k=1), plus a Conv1D(k=1) shortcut.

Traps kept from the JAX package: the LeakyReLU slope is 0.3 (Keras), not
torch's 0.01; the strided convs pad TF 'SAME' for their stride (torch's
``padding='same'`` refuses a stride above 1); the submodule names are the
flax ones, so ``models/convert.py`` maps the weights by its generic rules.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowasr_tpu_torch.models.layers import Conv1D, DepthwiseConv1D

LEAKY_SLOPE = 0.3        # Keras LeakyReLU's default


def get_scales(num: int) -> List[int]:
    """Factorise ``num`` into at most 4 stride factors, largest first."""
    scale: List[int] = []
    while True:
        for i in range(2, 100):
            if num % i == 0:
                num //= i
                scale.append(i)
                break
        else:
            if num > 1:          # a prime remainder above 99
                scale.append(num)
                num = 1
        if num == 1:
            break
    while len(scale) > 4:
        new_scale = scale[2:]
        new_scale.append(scale[0] * scale[1])
        scale = sorted(new_scale)
    return scale[::-1]


class ResidualStack(nn.Module):
    """[B, T, filters] -> [B, T, filters]: the 5-tap conv at dilation 1 the
    pyramid builds."""

    KERNEL_SIZE = 5

    def __init__(self, filters: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pad = (self.KERNEL_SIZE - 1) // 2
        self.conv = Conv1D(filters, filters, self.KERNEL_SIZE, (0, 0),
                           dtype=dtype)
        self.pw = Conv1D(filters, filters, 1, (0, 0), dtype=dtype)
        self.shortcut = Conv1D(filters, filters, 1, (0, 0), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(x, LEAKY_SLOPE)
        y = F.pad(y.transpose(1, 2), (self.pad, self.pad),
                  mode="reflect").transpose(1, 2)
        y = self.pw(F.leaky_relu(self.conv(y), LEAKY_SLOPE))
        return self.shortcut(x) + y


class WavePickModel(nn.Module):
    """wav [B, T(, 1)] -> [B, ceil(T / hop_size), dout] (for a T the scales
    divide; else each strided conv rounds up)."""

    def __init__(self, dout: int, hop_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.scales = get_scales(hop_size)
        self.sep_dw = DepthwiseConv1D(1, 7, dtype, stride=self.scales[0])
        self.sep_pw = Conv1D(1, 32, 1, (0, 0), dtype=dtype)
        f_in = 32
        for i in range(1, len(self.scales)):
            f = min(32 * (i + 1), dout)
            self.add_module(f"down_{i}", Conv1D(
                f_in, f, 3, "SAME", dtype=dtype, stride=self.scales[i]))
            self.add_module(f"res_{i}", ResidualStack(f, dtype))
            f_in = f
        self.final = Conv1D(f_in, dout, 7, "SAME", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x[:, :, None]
        x = x.to(self.compute_dtype)
        x = F.leaky_relu(self.sep_pw(self.sep_dw(x)), LEAKY_SLOPE)
        for i in range(1, len(self.scales)):
            x = getattr(self, f"res_{i}")(getattr(self, f"down_{i}")(x))
        return self.final(x)
