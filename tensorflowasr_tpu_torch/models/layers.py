"""Conformer building blocks as ``nn.Module``s.

Counterpart of ``tensorflowasr_tpu/models/layers.py``. Submodule names
follow the flax names, so ``models/convert.py`` maps one tree onto the
other name by name. Traps kept on purpose:

- every LayerNorm / BatchNorm uses epsilon 1e-3 (Keras), not torch's 1e-5;
- ConvSubsampling pads TF-style 'SAME' (odd extra row right/bottom) with an
  explicit ``F.pad`` and merges [b, t, f, c] -> [b, t, f*c] with f major;
- the depthwise conv pads (K-1)//2 left and K//2 right for an even K and
  is a cross-correlation, like the JAX one (the kernel is not flipped);
- the Conformer's encoder self-attention has no mask and no positional
  encoding; the E-Branchformer's (:class:`RelPositionMultiHeadAttention`)
  has relative positions and a key mask;
- dtype policy: matmuls and convs in the compute dtype (f32 or bf16) with
  f32 parameters cast per call, LayerNorm and BatchNorm in f32.

Training mode (``module.train()``) turns on dropout at every place the flax
modules have one and makes BatchNorm use (and record) batch statistics.
Every dropout mask is drawn from an explicit ``torch.Generator`` handed over
with :func:`set_generator`; nothing reads the global RNG.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tensorflowasr_tpu_torch.ops import rel_attention
from tensorflowasr_tpu_torch.ops.rel_attention import rel_shift  # noqa: F401
from tensorflowasr_tpu_torch.parallel.mesh import global_sum
from tensorflowasr_tpu_torch.utils import telemetry

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
    projections' fan rules); ``bias=False`` leaves the bias out."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 init_limit: Optional[float] = None, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype
        self.init_limit = init_limit

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if bias is None else bias.to(dt))


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

    def forward(self, x: torch.Tensor,
                shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """``shard`` = (rank, size): ``x`` is slice ``rank`` of ``size``
        equal slices of its last axis (a tensor-parallel FFN hidden); the
        mask is drawn at the full width and sliced, so every rank of the
        ``model`` axis keeps its generator in step with the others."""
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                "training-mode dropout needs a generator: call "
                "set_generator(model, torch.Generator(device=...)) first")
        shape = x.shape
        if shard is not None:
            shape = (*shape[:-1], shape[-1] * shard[1])
        keep = torch.rand(shape, generator=self.generator,
                          device=x.device) >= self.rate
        if shard is not None:
            keep = keep.chunk(shard[1], dim=-1)[shard[0]]
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
    variance.

    With a ``data_group`` (``parallel/mesh.py::set_data_group``) the
    moments are those of the global batch: the per-channel sums of x and
    x^2 and the row count are all-reduced over the group before the mean
    and the variance are formed (the gradient flows back through the
    all-reduce), so every rank normalizes alike and its running statistics
    move alike. ``nn.SyncBatchNorm`` is not used: it records the unbiased
    variance and takes epsilon 1e-5."""

    MOMENTUM = 0.99

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.track_stats = True
        self.data_group = None

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.to(torch.float32)
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean, mean_sq = self._moments(x, mask)
            var = torch.clamp_min(mean_sq - mean * mean, 0.0)
            if self.track_stats:
                with torch.no_grad():
                    self.running_mean.lerp_(mean, 1.0 - self.MOMENTUM)
                    self.running_var.lerp_(var, 1.0 - self.MOMENTUM)
        mul = torch.rsqrt(var + NORM_EPS) * self.weight
        return (x - mean) * mul + self.bias

    def _moments(self, x: torch.Tensor, mask: Optional[torch.Tensor]):
        """(mean, E[x^2]) over the rows (the masked ones) of every rank of
        the data group: one all-reduce of [sum x, sum x^2, rows], the
        identity without a group."""
        axes = tuple(range(x.dim() - 1))
        if mask is None:
            sx, sxx = x.sum(dim=axes), (x * x).sum(dim=axes)
            rows = x.new_full((1,), float(x[..., 0].numel()))
        else:
            w = mask.to(torch.float32).expand(*x.shape[:-1], 1)
            sx, sxx = (x * w).sum(dim=axes), (x * x * w).sum(dim=axes)
            rows = w.sum().reshape(1)
        total = global_sum(torch.cat([sx, sxx, rows]), self.data_group,
                           differentiable=True)
        c = x.shape[-1]
        count = total[2 * c]
        return total[:c] / count, total[c:2 * c] / count


class DepthwiseConv1D(nn.Module):
    """Depthwise 1-D conv on [B, T, C]; weight [C, 1, K] (the JAX kernel
    [K, 1, C] transposed, not flipped).

    ``padding`` is flax 'SAME' or "CAUSAL" (K-1 left, 0 right: the chunk
    modules' form); ``forward``'s ``pad`` = (lo, hi) overrides it, e.g.
    (0, 0) for a VALID window over a streaming ring that already holds the
    left context. ``stride`` > 1 with 'SAME' pads as TF does for that
    stride (``WavePickModel``'s first conv)."""

    def __init__(self, channels: int, kernel_size: int,
                 dtype: torch.dtype = torch.float32, padding: str = "SAME",
                 stride: int = 1):
        super().__init__()
        if padding not in ("SAME", "CAUSAL"):
            raise ValueError(f"DepthwiseConv1D supports padding 'SAME' or "
                             f"'CAUSAL', got {padding!r}")
        self.kernel_size = kernel_size
        self.padding = padding
        self.stride = stride
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
            lo, hi = _same_pad(x.shape[1], self.kernel_size, self.stride)
        y = F.pad(x.to(dt).transpose(1, 2), (lo, hi))
        y = F.conv1d(y, self.weight.to(dt), self.bias.to(dt),
                     stride=self.stride, groups=self.weight.shape[0])
        return y.transpose(1, 2)


class Conv1D(nn.Module):
    """flax ``nn.Conv`` over [B, T, C_in] -> [B, T', C_out]; weight
    [out, in, K] (the flax kernel [K, in, out] transposed, not flipped).
    ``padding`` = (left, right) zeros on the time axis: (K - 1, 0) is
    flax's causal ``[(K-1, 0)]``, and with stride 1 and an odd K, TF
    'SAME' is (d * (K - 1) // 2) on each side at dilation d. ``padding``
    "SAME" pads as TF does for the input's length and ``stride``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, padding: Union[Tuple[int, int], str],
                 dilation: int = 1, dtype: torch.dtype = torch.float32,
                 stride: int = 1):
        super().__init__()
        self.padding = padding if padding == "SAME" else tuple(padding)
        self.dilation = dilation
        self.stride = stride
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_channels, in_channels,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        pad = self.padding
        if pad == "SAME":
            span = self.dilation * (self.weight.shape[-1] - 1) + 1
            pad = _same_pad(x.shape[1], span, self.stride)
        y = F.pad(x.to(dt).transpose(1, 2), pad)
        y = F.conv1d(y, self.weight.to(dt), self.bias.to(dt),
                     stride=self.stride, dilation=self.dilation)
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
    """LN -> Dense(hidden) -> swish -> dropout -> Dense(d) -> dropout ->
    ``x + fc_factor * y``; ``hidden`` is 4 d unless given, the LayerNorm's
    epsilon Keras' 1e-3 unless ``eps`` says otherwise."""

    def __init__(self, input_dim: int, dropout: float = 0.0,
                 fc_factor: float = 0.5, dtype: torch.dtype = torch.float32,
                 hidden: Optional[int] = None, eps: float = NORM_EPS):
        super().__init__()
        hidden = 4 * input_dim if hidden is None else hidden
        self.fc_factor = fc_factor
        self.ln = LayerNorm(input_dim, eps)
        self.ffn1 = Dense(input_dim, hidden, dtype)
        self.ffn2 = Dense(hidden, input_dim, dtype)
        self.dropout = Dropout(dropout)
        # (rank, size) when ffn1 is column-parallel (parallel/tp.py)
        self.hidden_shard: Optional[Tuple[int, int]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dropout(F.silu(self.ffn1(self.ln(x))), self.hidden_shard)
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
        hd = self.head_size
        # the head count is read from the projection's width: a
        # column-parallel projection (parallel/tp.py) holds this rank's heads
        q = self.query(inputs_q).view(b, lq, -1, hd).transpose(1, 2)
        k = self.key(inputs_kv).view(b, lk, -1, hd).transpose(1, 2)
        v = self.value(inputs_kv).view(b, lk, -1, hd).transpose(1, 2)
        logits = torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2))
        logits = logits.to(torch.float32)
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        w = torch.softmax(logits, dim=-1)
        o = torch.matmul(w.to(self.compute_dtype), v)       # [b, h, lq, hd]
        return self.out(o.transpose(1, 2).reshape(b, lq, -1))


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


_collecting = threading.local()      # .tensors: a collect_constants list


@contextlib.contextmanager
def collect_constants():
    """Collect, in the list this yields, what every :func:`tensor_cache`
    function hands out on this thread inside the block: a captured CUDA
    graph reads such a constant at its address, so it keeps the list as
    long as it lives, after the cache has let the constant go."""
    prev = getattr(_collecting, "tensors", None)
    _collecting.tensors = tensors = []
    try:
        yield tensors
    finally:
        _collecting.tensors = prev


def tensor_cache(fn):
    """``functools.lru_cache`` for a function that builds a constant
    tensor, bypassed while ``torch.export`` (or ``torch.compile``) traces:
    a tensor made then belongs to the tracer and must not reach a later
    eager call. Inside :func:`collect_constants` what it hands out is
    collected."""
    cached = functools.lru_cache(maxsize=64)(fn)

    @functools.wraps(fn)
    def build(*args):
        if torch.compiler.is_compiling():
            return fn(*args)
        out = cached(*args)
        collected = getattr(_collecting, "tensors", None)
        if collected is not None:
            collected.append(out)
        return out
    return build


@tensor_cache
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


def rel_positional_encoding(length: int, dmodel: int) -> np.ndarray:
    """[2 length - 1, dmodel]: the interleaved sin / cos of the relative
    positions length - 1, ..., 0, ..., -(length - 1) (ESPnet's
    ``RelPositionalEncoding``, ``rel_pos_type: latest``)."""
    pos = np.arange(length - 1, -length, -1, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dmodel, 2, dtype=np.float64)
                 * -(math.log(10000.0) / dmodel))
    pe = np.zeros((2 * length - 1, dmodel), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


@tensor_cache
def _rel_pe_table(length: int, dmodel: int, device: torch.device
                  ) -> torch.Tensor:
    return torch.from_numpy(rel_positional_encoding(length, dmodel)).to(
        device)


class RelPositionalEncoding(nn.Module):
    """x [B, T, d] -> (x * sqrt(d) in f32, the [2T - 1, d] table of
    :func:`rel_positional_encoding`), each through the same dropout."""

    def __init__(self, dmodel: int, dropout: float = 0.0):
        super().__init__()
        self.scale = math.sqrt(dmodel)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        pos = _rel_pe_table(x.shape[1], x.shape[2], x.device)
        return (self.dropout(x.to(torch.float32) * self.scale),
                self.dropout(pos))


def key_mask(lengths: Optional[torch.Tensor], t: int
             ) -> Optional[torch.Tensor]:
    """[B, 1, 1, t] bool, True on each row's first ``lengths`` keys (at
    least one); None without lengths."""
    if lengths is None:
        return None
    keep = torch.arange(t, device=lengths.device)[None] \
        < lengths.clamp_min(1)[:, None]
    return keep[:, None, None]


class RelPositionMultiHeadAttention(nn.Module):
    """Self-attention with relative positions in Transformer-XL form
    (ESPnet's ``RelPositionMultiHeadedAttention``, latest): scores
    ``((q + u) k^T + shift((q + v) (W_pos P)^T)) / sqrt(hd)``, so that the
    position term at (i, j) is ``(q_i + v) . p_{i-j}``; keys where ``mask``
    is False at ``finfo(float32).min``; softmax in f32; dropout on the
    weights; output projection. ``pos`` is the bias-free position
    projection, ``pos_bias_u`` / ``pos_bias_v`` the learned biases
    [heads, hd].

    After the projections it takes one of two paths, by what it observes
    (``ops/rel_attention.py``): on a CUDA input with no gradient recorded
    and the weights' dropout inactive, the fused kernel, which never makes
    the [T, T] weights and raises on a dtype or head size it does not take
    (it takes bf16 at a head size of 64); else (training, which needs the
    weights for dropout and autograd, and the CPU) the plain composition.
    The recorder's counter ``ebranchformer.attention_kernel`` gets 1 a
    call on the kernel, 0 on the plain path."""

    def __init__(self, dmodel: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dmodel % num_heads:
            raise ValueError(f"dmodel {dmodel} is not a multiple of "
                             f"{num_heads} heads")
        self.num_heads, self.head_size = num_heads, dmodel // num_heads
        self.compute_dtype = dtype
        self.query = Dense(dmodel, dmodel, dtype)
        self.key = Dense(dmodel, dmodel, dtype)
        self.value = Dense(dmodel, dmodel, dtype)
        self.out = Dense(dmodel, dmodel, dtype)
        self.pos = Dense(dmodel, dmodel, dtype, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads,
                                                   self.head_size))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads,
                                                   self.head_size))
        self.dropout = Dropout(dropout)

    def _fused(self, x: torch.Tensor) -> bool:
        grad = torch.is_grad_enabled() and (
            x.requires_grad or self.query.weight.requires_grad)
        return (x.is_cuda and not grad
                and (not self.dropout.training or self.dropout.rate == 0.0))

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, d], pos [2T - 1, d], mask [B, 1, 1, T] -> [B, T, d]."""
        b, t, _ = x.shape
        h, hd, dt = self.num_heads, self.head_size, self.compute_dtype
        q, k, v = self.query(x), self.key(x), self.value(x)
        p = self.pos(pos).view(-1, h, hd).transpose(0, 1)  # [h, 2T-1, hd]
        qv = q.view(b, t, h, hd) + self.pos_bias_v.to(dt)
        fused = self._fused(x)
        telemetry.count("ebranchformer.attention_kernel", float(fused),
                        shared=True)
        if fused:
            # h products over all B x T queries, so P is not broadcast over
            # the batch, into rows padded to a multiple of 8 positions (16
            # bytes), which cuBLAS writes with aligned stores; bd is a
            # [B, h, T, 2T-1] view of the [h, B, T, 8k] buffer
            n = p.shape[1]
            pad = F.pad(p, (0, 0, 0, -n % 8))
            bd = torch.matmul(qv.view(b * t, h, hd).transpose(0, 1),
                              pad.transpose(-1, -2))
            bd = bd.view(h, b, t, -1)[..., :n].transpose(0, 1)
            o = rel_attention.rel_attention(q, k, v, bd, self.pos_bias_u,
                                            mask)
        else:
            bd = torch.matmul(qv.transpose(1, 2), p.transpose(-1, -2))
            o = rel_attention.rel_attention_reference(
                q, k, v, bd, self.pos_bias_u, mask, self.dropout)
        return self.out(o)


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
            if m.bias is not None:
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
        elif isinstance(m, RelPositionMultiHeadAttention):
            for u in (m.pos_bias_u, m.pos_bias_v):
                _glorot_(u, u.shape[1], u.shape[0], generator)
        elif isinstance(m, (LayerNorm, BatchNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
