"""Conformer building blocks as ``nn.Module``s.

Counterpart of ``tensorflowasr_tpu/models/layers.py``. Submodule names
follow the flax names, so ``models/convert.py`` maps one tree onto the
other name by name. Traps kept on purpose:

- every LayerNorm / BatchNorm uses epsilon 1e-3 (Keras), not torch's 1e-5;
- ConvSubsampling pads TF-style 'SAME' (odd extra row right/bottom) with an
  explicit ``F.pad`` and merges [b, t, f, c] -> [b, t, f*c] with f major;
- the depthwise conv pads (K-1)//2 left and K//2 right for an even K and
  is a cross-correlation, like the JAX one (the kernel is not flipped);
- encoder self-attention has no mask and no positional encoding;
- dtype policy: matmuls and convs in the compute dtype (f32 or bf16) with
  f32 parameters cast per call, LayerNorm and BatchNorm in f32.

Training mode (``module.train()``) turns on dropout at every place the flax
modules have one and makes BatchNorm use (and record) batch statistics.
Every dropout mask is drawn from an explicit ``torch.Generator`` handed over
with :func:`set_generator`; nothing reads the global RNG.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NORM_EPS = 1e-3          # Keras LayerNormalization / BatchNormalization


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def _same_pad(t: int, k: int, s: int) -> Tuple[int, int]:
    """TF/flax 'SAME' padding for length t, kernel k, stride s."""
    out = -(-t // s)
    pad = max((out - 1) * s + k - t, 0)
    return pad // 2, pad - pad // 2


class Dense(nn.Linear):
    """flax ``nn.Dense``: runs in ``dtype`` with the f32 weights cast per
    call. ``init_limit`` overrides the glorot-uniform limit (the MHA
    projections' fan rules)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 init_limit: Optional[float] = None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.init_limit = init_limit

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """f32 LayerNorm, epsilon 1e-3 unless ``eps`` says otherwise (the
    punctuation model's is 1e-6); promotes its input to f32."""

    def __init__(self, dim: int, eps: float = NORM_EPS):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.float32))


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training mode zeroes each value with
    probability ``rate`` and scales the kept ones by 1 / (1 - rate); the
    identity in eval mode or at rate 0. The mask comes from ``generator``
    (see :func:`set_generator`), which must live on the input's device."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate < 1.0:
            raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "training-mode dropout needs a generator: call "
                "set_generator(model, torch.Generator(device=...)) first")
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.rate
        return x * keep.to(x.dtype) / (1.0 - self.rate)


def set_generator(model: nn.Module, generator: Optional[torch.Generator]
                  ) -> None:
    """Hand ``generator`` to every module of ``model`` that draws random
    numbers (each :class:`Dropout`, and the encoder for SpecAugment)."""
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = generator


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)`` over the last
    axis, in f32.

    Eval mode normalizes with the running statistics. Training mode
    normalizes with the batch statistics over every leading axis, with the
    variance flax computes, ``max(E[x^2] - E[x]^2, 0)`` (biased); the
    gradient flows through the statistics. A ``mask`` (bool, broadcastable
    to ``x.shape[:-1] + (1,)``, e.g. [B, T, 1]) restricts the statistics to
    the rows it marks, as flax's ``BatchNorm(mask=...)``; every row is still
    normalized with them. The running statistics then move by a factor 0.01
    toward the batch mean and that same biased variance, unless
    ``track_stats`` is off (a recomputed forward under ``remat_blocks`` must
    not count twice). Eval mode ignores the mask.
    ``torch.nn.functional.batch_norm`` is not used: it records the unbiased
    variance."""

    MOMENTUM = 0.99

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.track_stats = True

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.to(torch.float32)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.dim() - 1))
            if mask is None:
                mean = x.mean(dim=axes)
                mean_sq = (x * x).mean(dim=axes)
            else:
                w = mask.to(torch.float32).expand(*x.shape[:-1], 1)
                count = w.sum()
                mean = (x * w).sum(dim=axes) / count
                mean_sq = (x * x * w).sum(dim=axes) / count
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            if self.track_stats:
                with torch.no_grad():
                    self.running_mean.lerp_(mean, 1.0 - self.MOMENTUM)
                    self.running_var.lerp_(var, 1.0 - self.MOMENTUM)
        mul = torch.rsqrt(var + NORM_EPS) * self.weight
        return (x - mean) * mul + self.bias


class DepthwiseConv1D(nn.Module):
    """Depthwise 1-D conv on [B, T, C]; weight [C, 1, K] (the JAX kernel
    [K, 1, C] transposed, not flipped).

    ``padding`` is flax 'SAME' or "CAUSAL" (K-1 left, 0 right: the chunk
    modules' form); ``forward``'s ``pad`` = (lo, hi) overrides it, e.g.
    (0, 0) for a VALID window over a streaming ring that already holds the
    left context."""

    def __init__(self, channels: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32, padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "CAUSAL"):
            raise ValueError(f"DepthwiseConv1D supports padding 'SAME' or "
                             f"'CAUSAL', got {padding!r}")
        self.kernel_size = kernel_size
        self.padding = padding
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.zeros(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor,
                pad: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        dt = self.compute_dtype
        if pad is not None:
            lo, hi = pad
        elif self.padding == "CAUSAL":
            lo, hi = self.kernel_size - 1, 0
        else:
            lo, hi = _same_pad(x.shape[1], self.kernel_size, 1)
        y = F.pad(x.to(dt).transpose(1, 2), (lo, hi))
        y = F.conv1d(y, self.weight.to(dt), self.bias.to(dt),
                     groups=self.weight.shape[0])
        return y.transpose(1, 2)


class Conv1D(nn.Module):
    """flax ``nn.Conv`` over [B, T, C_in] -> [B, T', C_out]; weight
    [out, in, K] (the flax kernel [K, in, out] transposed, not flipped).
    ``padding`` = (left, right) zeros on the time axis: (K - 1, 0) is
    flax's causal ``[(K-1, 0)]``, and with stride 1 and an odd K, TF
    'SAME' is (d * (K - 1) // 2) on each side at dilation d."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, padding: Tuple[int, int],
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.padding = tuple(padding)
        self.dilation = dilation
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.pad(x.to(dt).transpose(1, 2), self.padding)
        y = F.conv1d(y, self.weight.to(dt), self.bias.to(dt),
                     dilation=self.dilation)
        return y.transpose(1, 2)


class ConvSubsampling(nn.Module):
    """[B, T, F, 1] -> [B, ceil(T / reduction_factor), odim]: two 3x3 SAME
    convs with strides (rf/2, 2) and (2, 2), ReLU, then the freq x channel
    dims merge (freq major) into a Dense projection."""

    def __init__(self, odim: int, in_freq: int, reduction_factor: int = 4,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if reduction_factor % 2:
            raise ValueError(f"reduction_factor must be even, got "
                             f"{reduction_factor}")
        self.strides = ((reduction_factor // 2, 2), (2, 2))
        self.compute_dtype = dtype
        self.conv1 = nn.Conv2d(1, odim, 3, stride=self.strides[0])
        self.conv2 = nn.Conv2d(odim, odim, 3, stride=self.strides[1])
        f_out = -(-(-(-in_freq // 2)) // 2)
        self.linear = Dense(f_out * odim, odim, dtype)
        self.dropout = Dropout(dropout)

    def _conv(self, conv: nn.Conv2d, x: torch.Tensor, stride) -> torch.Tensor:
        dt = self.compute_dtype
        t_lo, t_hi = _same_pad(x.shape[2], 3, stride[0])
        f_lo, f_hi = _same_pad(x.shape[3], 3, stride[1])
        x = F.pad(x, (f_lo, f_hi, t_lo, t_hi))
        return F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                               stride=stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)    # NHWC -> NCHW
        x = self._conv(self.conv1, x, self.strides[0])
        x = self._conv(self.conv2, x, self.strides[1])
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)      # f major, c minor
        return self.dropout(self.linear(x))


class FFModule(nn.Module):
    def __init__(self, input_dim: int, dropout: float = 0.0,
                 fc_factor: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc_factor = fc_factor
        self.ln = LayerNorm(input_dim)
        self.ffn1 = Dense(input_dim, 4 * input_dim, dtype)
        self.ffn2 = Dense(4 * input_dim, input_dim, dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dropout(F.silu(self.ffn1(self.ln(x))))
        y = self.dropout(self.ffn2(y))
        return x + self.fc_factor * y


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention``: q/k/v projections to
    num_heads x head_size, query scaled by 1/sqrt(head_size), softmax in
    f32, output projection back to ``out_features``. Where ``mask`` (bool,
    broadcastable to [B, heads, Lq, Lk]) is False the logit becomes
    ``finfo(float32).min``, not -inf, as in flax.

    ``init_limits`` = (q/k/v, out) glorot limits for the seeded init; the
    default is the Conformer's fan rule, (h * in + h * hd) and (h * hd +
    h * out)."""

    def __init__(self, in_features: int, num_heads: int, head_size: int,
                 out_features: int, dtype: torch.dtype = torch.float32,
                 init_limits: Optional[Tuple[float, float]] = None):
        super().__init__()
        self.num_heads, self.head_size = num_heads, head_size
        self.compute_dtype = dtype
        inner = num_heads * head_size
        if init_limits is None:
            init_limits = (
                math.sqrt(6.0 / (num_heads * in_features
                                 + num_heads * head_size)),
                math.sqrt(6.0 / (inner + num_heads * out_features)))
        qkv_limit, out_limit = init_limits
        self.query = Dense(in_features, inner, dtype, qkv_limit)
        self.key = Dense(in_features, inner, dtype, qkv_limit)
        self.value = Dense(in_features, inner, dtype, qkv_limit)
        self.out = Dense(inner, out_features, dtype, out_limit)

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, lq, _ = inputs_q.shape
        lk = inputs_kv.shape[1]
        h, hd = self.num_heads, self.head_size
        q = self.query(inputs_q).view(b, lq, h, hd).transpose(1, 2)
        k = self.key(inputs_kv).view(b, lk, h, hd).transpose(1, 2)
        v = self.value(inputs_kv).view(b, lk, h, hd).transpose(1, 2)
        logits = torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2))
        logits = logits.to(torch.float32)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        w = torch.softmax(logits, dim=-1)
        o = torch.matmul(w.to(self.compute_dtype), v)       # [b, h, lq, hd]
        return self.out(o.transpose(1, 2).reshape(b, lq, h * hd))


class MHSAModule(nn.Module):
    """LN -> self-attention (no mask, no positional encoding) -> residual."""

    def __init__(self, input_dim: int, head_size: int, num_heads: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln = LayerNorm(input_dim)
        self.mha = MultiHeadAttention(input_dim, num_heads, head_size,
                                      input_dim, dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ln(x)
        return x + self.dropout(self.mha(y, y))


class ConvModule(nn.Module):
    """LN -> pw(2d) -> GLU -> depthwise -> pw(2d) -> BN -> swish -> pw(d)
    -> residual."""

    def __init__(self, input_dim: int, kernel_size: int = 32,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln = LayerNorm(input_dim)
        self.pw_conv_1 = Dense(input_dim, 2 * input_dim, dtype)
        self.dw_conv = DepthwiseConv1D(input_dim, kernel_size, dtype)
        self.dw_pw = Dense(input_dim, 2 * input_dim, dtype)
        self.bn = BatchNorm(2 * input_dim)
        self.pw_conv_2 = Dense(2 * input_dim, input_dim, dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = glu(self.pw_conv_1(self.ln(x)))
        y = self.bn(self.dw_pw(self.dw_conv(y)))
        return x + self.dropout(self.pw_conv_2(F.silu(y)))


class ConformerBlock(nn.Module):
    """FF/2 -> MHSA -> Conv -> FF/2 -> LN."""

    def __init__(self, input_dim: int, dropout: float = 0.0,
                 fc_factor: float = 0.5, head_size: int = 36,
                 num_heads: int = 4, kernel_size: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ff_module_1 = FFModule(input_dim, dropout, fc_factor, dtype)
        self.mhsa = MHSAModule(input_dim, head_size, num_heads, dropout,
                               dtype)
        self.conv_module = ConvModule(input_dim, kernel_size, dropout, dtype)
        self.ff_module_2 = FFModule(input_dim, dropout, fc_factor, dtype)
        self.ln = LayerNorm(input_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ff_module_1(x)
        x = self.mhsa(x)
        x = self.conv_module(x)
        x = self.ff_module_2(x)
        return self.ln(x)


def positional_encoding(length: int, dmodel: int) -> np.ndarray:
    """Interleaved sin/cos PE table [length, dmodel]."""
    pos = np.arange(length, dtype=np.float32)[:, None]
    idx = np.arange(dmodel, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, (2.0 * (idx // 2)) / dmodel)
    pe = np.zeros((length, dmodel), dtype=np.float32)
    pe[:, 0::2] = np.sin(angle[:, 0::2])
    pe[:, 1::2] = np.cos(angle[:, 1::2])
    return pe


@functools.lru_cache(maxsize=32)
def _pe_table(length: int, dmodel: int, device: torch.device
              ) -> torch.Tensor:
    return torch.from_numpy(positional_encoding(length, dmodel)).to(device)


class RMHSAModule(nn.Module):
    """Translator cross-attention: PE(x) -> LN -> MHA(q=x, kv=enc); the
    residual adds to the un-PE'd x."""

    def __init__(self, input_dim: int, head_size: int, num_heads: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln = LayerNorm(input_dim)
        self.mha = MultiHeadAttention(input_dim, num_heads, head_size,
                                      input_dim, dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        pe = _pe_table(x.shape[1], x.shape[2], x.device).to(x.dtype)
        return x + self.dropout(self.mha(self.ln(x + pe), enc))


class RBlock(nn.Module):
    """Translator block: FF/2 -> cross-MHSA -> Conv -> FF/2 -> LN."""

    def __init__(self, input_dim: int, dropout: float = 0.0,
                 fc_factor: float = 0.5, head_size: int = 36,
                 num_heads: int = 4, kernel_size: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ff_module_1 = FFModule(input_dim, dropout, fc_factor, dtype)
        self.rmhsa = RMHSAModule(input_dim, head_size, num_heads, dropout,
                                 dtype)
        self.conv_module = ConvModule(input_dim, kernel_size, dropout, dtype)
        self.ff_module_2 = FFModule(input_dim, dropout, fc_factor, dtype)
        self.ln = LayerNorm(input_dim)

    def forward(self, x: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        x = self.ff_module_1(x)
        x = self.rmhsa(x, enc)
        x = self.conv_module(x)
        x = self.ff_module_2(x)
        return self.ln(x)


def _glorot_(w: torch.Tensor, fan_in: int, fan_out: int,
             generator: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    nn.init.uniform_(w, -limit, limit, generator=generator)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Keras-style random init (the JAX package's initializers; the numbers
    differ, the distributions match): glorot-uniform Dense / Conv kernels
    with the reference's depthwise and MHA fan rules, zero biases,
    U(-0.05, 0.05) embeddings, unit norms."""
    for m in model.modules():
        if isinstance(m, Dense):
            if m.init_limit is None:
                _glorot_(m.weight, m.in_features, m.out_features, generator)
            else:
                nn.init.uniform_(m.weight, -m.init_limit, m.init_limit,
                                 generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            rf = m.kernel_size[0] * m.kernel_size[1]
            _glorot_(m.weight, rf * m.in_channels, rf * m.out_channels,
                     generator)
            m.bias.zero_()
        elif isinstance(m, DepthwiseConv1D):
            c, _, k = m.weight.shape
            _glorot_(m.weight, k * c, k, generator)
            m.bias.zero_()
        elif isinstance(m, Conv1D):
            c_out, c_in, k = m.weight.shape
            _glorot_(m.weight, k * c_in, k * c_out, generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            nn.init.uniform_(m.weight, -0.05, 0.05, generator=generator)
        elif isinstance(m, (LayerNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
