"""Plain PyTorch Conformer blocks, written from the published description
(Conformer: Gulati et al. 2020, arXiv:2005.08100) with TensorflowASR's
choices: FF/2 -> MHSA -> Conv -> FF/2 -> LayerNorm, Keras epsilons (1e-3),
GLU then a depthwise conv then a pointwise conv before BatchNorm, swish.

Every function reads its weights from a flat dict ``W`` (name -> f32
tensor) under a prefix. ``Prec`` sets the precision of the products:
``Prec("f32")`` is the reference itself (f32, TF32 off); a lower one rounds
the operands of every matrix product and convolution to it, which is how
the control is computed. ``Drop`` reproduces dropout masks from a seeded
generator in the order the layers draw them; ``None`` is eval mode.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

EPS = 1e-3          # Keras LayerNormalization / BatchNormalization
F8_MAX = 448.0      # largest float8_e4m3fn


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


_ROUND = {"f32": lambda x: x, "bf16": _bf16, "fp8": _fp8}


class Prec:
    """Operand rounding of the products: ``low`` for the layers the
    configuration runs in its compute dtype, ``head`` for its f32 heads.
    A rounding is an identity in value for the backward pass (a straight-
    through estimator), so gradients flow as the rounded forward left
    them."""

    def __init__(self, low: str = "f32", head: str = "f32"):
        self.low_name, self.head_name = low, head
        self._low, self._head = _ROUND[low], _ROUND[head]

    @staticmethod
    def _ste(fn, x):
        if fn is _ROUND["f32"]:
            return x
        return x + (fn(x) - x).detach()

    def low(self, x: torch.Tensor) -> torch.Tensor:
        return self._ste(self._low, x)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self._ste(self._head, x)


F32 = Prec()


class Drop:
    """Dropout at ``rate`` whose keep masks are ``torch.rand(shape,
    generator) >= rate``, drawn in call order."""

    def __init__(self, rate: float, generator: torch.Generator):
        self.rate, self.generator = float(rate), generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.rate
        return x * keep.to(x.dtype) / (1.0 - self.rate)


def drop(d: Optional[Drop], x: torch.Tensor) -> torch.Tensor:
    return x if d is None or d.rate == 0.0 else d(x)


def dense(W, p: str, x: torch.Tensor, P: Prec, head: bool = False
          ) -> torch.Tensor:
    r = P.head if head else P.low
    return torch.matmul(r(x), r(W[p + ".weight"]).t()) + W[p + ".bias"]


def layer_norm(W, p: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), W[p + ".weight"], W[p + ".bias"],
                        EPS)


def batch_norm(W, p: str, x: torch.Tensor, training: bool,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Over the last axis; training mode normalises with the (masked) batch
    moments and the biased variance, eval mode with the running ones."""
    if training:
        axes = tuple(range(x.dim() - 1))
        w = torch.ones_like(x[..., :1]) if mask is None else \
            mask.to(x.dtype).expand(*x.shape[:-1], 1)
        n = w.sum()
        mean = (x * w).sum(axes) / n
        var = torch.clamp_min((x * x * w).sum(axes) / n - mean * mean, 0.0)
    else:
        mean, var = W[p + ".running_mean"], W[p + ".running_var"]
    return (x - mean) * (torch.rsqrt(var + EPS) * W[p + ".weight"]) \
        + W[p + ".bias"]


def ff_module(W, p: str, x, P: Prec, d: Optional[Drop], fc_factor=0.5):
    y = drop(d, F.silu(dense(W, p + ".ffn1", layer_norm(W, p + ".ln", x),
                             P)))
    y = drop(d, dense(W, p + ".ffn2", y, P))
    return x + fc_factor * y


def attention(W, p: str, q_in, kv_in, P: Prec, heads: int,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention: projections, softmax(q k^T / sqrt(hd)) v with
    masked logits at the f32 minimum, output projection."""
    b, lq, _ = q_in.shape
    lk = kv_in.shape[1]
    q = dense(W, p + ".query", q_in, P).view(b, lq, heads, -1).transpose(1, 2)
    k = dense(W, p + ".key", kv_in, P).view(b, lk, heads, -1).transpose(1, 2)
    v = dense(W, p + ".value", kv_in, P).view(b, lk, heads, -1).transpose(
        1, 2)
    hd = q.shape[-1]
    logits = torch.matmul(P.low(q / math.sqrt(hd)), P.low(k).transpose(-1,
                                                                       -2))
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    o = torch.matmul(P.low(torch.softmax(logits, dim=-1)), P.low(v))
    return dense(W, p + ".out", o.transpose(1, 2).reshape(b, lq, -1), P)


def depthwise(W, p: str, x, P: Prec, lo: int, hi: int) -> torch.Tensor:
    """Depthwise cross-correlation over time of [B, T, C], zero padded
    (lo, hi)."""
    w = W[p + ".weight"]
    y = F.conv1d(F.pad(P.low(x).transpose(1, 2), (lo, hi)), P.low(w),
                 W[p + ".bias"], groups=w.shape[0])
    return y.transpose(1, 2)


def conv_module(W, p: str, x, P: Prec, d: Optional[Drop], training: bool,
                causal: bool, bn_mask=None):
    """LN -> pointwise 2d -> GLU -> depthwise (TF 'SAME', or causal) ->
    pointwise 2d -> BatchNorm -> swish -> pointwise d -> residual."""
    k = W[p + ".dw_conv.weight"].shape[-1]
    lo, hi = (k - 1, 0) if causal else ((k - 1) // 2, k - 1 - (k - 1) // 2)
    y = dense(W, p + ".pw_conv_1", layer_norm(W, p + ".ln", x), P)
    a, g = y.chunk(2, dim=-1)
    y = depthwise(W, p + ".dw_conv", a * torch.sigmoid(g), P, lo, hi)
    y = batch_norm(W, p + ".bn", dense(W, p + ".dw_pw", y, P), training,
                   bn_mask)
    return x + drop(d, dense(W, p + ".pw_conv_2", F.silu(y), P))


def positional_encoding(length: int, dmodel: int, device) -> torch.Tensor:
    """Interleaved sin / cos table [length, dmodel]."""
    pos = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    idx = torch.arange(dmodel, dtype=torch.float64, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * torch.div(idx, 2,
                                                     rounding_mode="floor")
                            / dmodel)
    pe = torch.where(idx.long() % 2 == 0, torch.sin(angle), torch.cos(angle))
    return pe.to(torch.float32)


def conv_subsampling(W, p: str, mel, P: Prec, d: Optional[Drop],
                     pads, strides) -> torch.Tensor:
    """[B, T, F] -> two 3x3 convs (zero pads ``pads`` = ((t_lo, t_hi,
    f_lo, f_hi) a conv), ``strides``) with ReLU -> [B, T', F' * C] with
    frequency major -> Dense."""
    x = mel[:, None]                                        # [B, 1, T, F]
    for i, (pad, stride) in enumerate(zip(pads, strides), start=1):
        t_lo, t_hi, f_lo, f_hi = pad
        x = F.pad(x, (f_lo, f_hi, t_lo, t_hi))
        x = F.relu(F.conv2d(P.low(x), P.low(W[f"{p}.conv{i}.weight"]),
                            W[f"{p}.conv{i}.bias"], stride=stride))
    b, c, t, f = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
    return drop(d, dense(W, p + ".linear", x, P))


def same_pad(n: int, k: int, s: int):
    """TF 'SAME' pads (lo, hi) for length n, kernel k, stride s."""
    out = -(-n // s)
    pad = max((out - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2
