"""A plain float32 PyTorch E-Branchformer CTC, written from the published
description and held apart from the port: it imports neither JAX nor
``tensorflowasr_tpu_torch``.

E-Branchformer (Kim et al., SLT 2022, arXiv:2210.00077), as ESPnet's
``EBranchformerEncoderLayer`` computes it, under TensorflowASR's CTC head
and translator:

wav -> 'same' log-mel -> two 3x3 stride-2 convs with ReLU (TF 'SAME' pads,
frequency-major flatten) -> Dense -> x * sqrt(d) and the sin / cos table of
the relative positions T'-1 ... -(T'-1) (both through dropout) -> blocks:

    x += 1/2 FFN(LN(x))
    g  = Drop(RelMHA(LN(x)))   scores ((q+u).k_j + (q+v).p_{i-j}) / sqrt(hd),
                               keys at or past the row's length masked
    l  = Drop(W2 Drop(x_r * DWConv(LN(x_g))))   [x_r, x_g] = GELU(W1 LN(x))
    x += Drop(Wm (c + DWConv(c))), c = [g, l]
    x += 1/2 FFN(LN(x));  x = LN(x)

-> LN -> the CTC head (Dense, Conformer blocks, Dense) and the translator
(phone embedding, cross-attention Conformer blocks with a sin / cos PE on
the queries, Dense). The position term is an explicit gather of
``p_{i-j}``, not the shift the port uses. Weights are a flat dict
``W`` (name -> f32 tensor) under the port's parameter names; sizes a dict
``m`` with the port configuration's field names. ``Drop`` draws dropout
masks ``torch.rand(shape, generator) >= rate`` in the order the layers run;
``None`` is eval mode.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

N_FFT = 1024
HEAD_EPS = 1e-3          # the heads' Keras LayerNorm / BatchNorm epsilon


class Drop:
    def __init__(self, rate: float, generator: torch.Generator):
        self.rate, self.generator = float(rate), generator

    def __call__(self, x: torch.Tensor, rate: Optional[float] = None
                 ) -> torch.Tensor:
        rate = self.rate if rate is None else float(rate)
        if rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator) >= rate
        return x * keep.to(x.dtype) / (1.0 - rate)


def drop(d: Optional[Drop], x, rate: Optional[float] = None):
    return x if d is None else d(x, rate)


# -- log-mel ------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / logstep, f / (200.0 / 3))


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    logstep = np.log(6.4) / 27.0
    return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)),
                    m * (200.0 / 3))


def mel_basis(sample_rate: int, n_mels: int) -> torch.Tensor:
    """Slaney filters with area normalisation, [n_fft / 2 + 1, n_mels]."""
    fft_f = np.linspace(0.0, sample_rate / 2.0, N_FFT // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0),
                                   _hz_to_mel(sample_rate / 2.0), n_mels + 2))
    ramps = mel_f[:, None] - fft_f[None, :]
    fdiff = np.diff(mel_f)
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                   ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return torch.from_numpy(w.T.astype(np.float32))


def log_mel(wav: torch.Tensor, hop: int, n_mels: int,
            sample_rate: int = 16000) -> torch.Tensor:
    """'same' frames (TF padding), periodic Hann, |rfft|^2 in dB minus each
    row's maximum, floored at -80, Slaney mel product."""
    b, t = wav.shape
    nf = -(-t // hop)
    lo = max((nf - 1) * hop + N_FFT - t, 0) // 2
    total = (nf - 1) * hop + N_FFT
    frames = F.pad(wav, (lo, max(0, total - lo - t))).unfold(
        1, N_FFT, hop)[:, :nf]
    n = torch.arange(N_FFT, dtype=torch.float64)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * n / N_FFT)).float()
    spec = torch.fft.rfft(frames * window, dim=-1)
    db = 10.0 * torch.log10(torch.clamp_min(spec.real ** 2 + spec.imag ** 2,
                                            1e-10))
    db = torch.clamp_min(db - db.amax(dim=(1, 2), keepdim=True), -80.0)
    return db @ mel_basis(sample_rate, n_mels)


# -- shared pieces ------------------------------------------------------------

def dense(W, p: str, x):
    y = x @ W[p + ".weight"].t()
    return y + W[p + ".bias"] if p + ".bias" in W else y


def layer_norm(W, p: str, x, eps: float):
    return F.layer_norm(x, (x.shape[-1],), W[p + ".weight"], W[p + ".bias"],
                        eps)


def same_pad(n: int, k: int, s: int):
    out = -(-n // s)
    pad = max((out - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def depthwise(W, p: str, x):
    """Cross-correlation over time of [B, T, C], TF 'SAME' zero pads."""
    w = W[p + ".weight"]
    y = F.conv1d(F.pad(x.transpose(1, 2), same_pad(x.shape[1], w.shape[-1],
                                                    1)),
                 w, W[p + ".bias"], groups=w.shape[0])
    return y.transpose(1, 2)


def ffn(W, p: str, x, d: Optional[Drop], rate: float, scale: float,
        eps: float):
    y = drop(d, F.silu(dense(W, p + ".ffn1", layer_norm(W, p + ".ln", x,
                                                          eps))), rate)
    return x + scale * drop(d, dense(W, p + ".ffn2", y), rate)


def subsampling(W, mel, rf: int):
    x = mel[:, None]
    for i, stride in enumerate(((rf // 2, 2), (2, 2)), start=1):
        x = F.pad(x, (*same_pad(x.shape[3], 3, stride[1]),
                      *same_pad(x.shape[2], 3, stride[0])))
        x = F.relu(F.conv2d(x, W[f"encoder.conv_subsampling.conv{i}.weight"],
                            W[f"encoder.conv_subsampling.conv{i}.bias"],
                            stride=stride))
    b, c, t, f = x.shape
    x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)
    return dense(W, "encoder.conv_subsampling.linear", x)


# -- E-Branchformer -----------------------------------------------------------

def rel_positions(t: int, dim: int) -> torch.Tensor:
    """Row k: position t - 1 - k, [sin, cos] interleaved at the frequencies
    10000^(-2i / dim)."""
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float64)[:, None]
    freq = torch.pow(10000.0, -torch.arange(0, dim, 2, dtype=torch.float64)
                     / dim)
    pe = torch.stack([torch.sin(pos * freq), torch.cos(pos * freq)], -1)
    return pe.reshape(2 * t - 1, dim).float()


def rel_attention(W, p: str, x, pos, lengths, heads: int,
                  d: Optional[Drop], rate: float):
    """Relative-position self-attention with the position term gathered as
    ``(q_i + v) . p_{i-j}``; keys j >= max(length, 1) masked."""
    b, t, dim = x.shape
    hd = dim // heads
    q = dense(W, p + ".query", x).view(b, t, heads, hd).transpose(1, 2)
    k = dense(W, p + ".key", x).view(b, t, heads, hd).transpose(1, 2)
    v = dense(W, p + ".value", x).view(b, t, heads, hd).transpose(1, 2)
    proj = (pos @ W[p + ".pos.weight"].t()).view(-1, heads, hd)  # [2t-1,h,hd]
    u_bias = W[p + ".pos_bias_u"][None, :, None]
    v_bias = W[p + ".pos_bias_v"][None, :, None]
    i = torch.arange(t)[:, None]
    j = torch.arange(t)[None]
    rel = proj[(t - 1) - (i - j)]                   # [t, t, h, hd]: p_{i-j}
    content = (q + u_bias) @ k.transpose(-1, -2)
    position = torch.einsum("bhic,ijhc->bhij", q + v_bias, rel)
    scores = (content + position) / math.sqrt(hd)
    if lengths is not None:
        keep = j < lengths.clamp_min(1)[:, None, None]       # [b, 1, t]
        scores = torch.where(keep[:, None], scores,
                             torch.finfo(torch.float32).min)
    w = drop(d, torch.softmax(scores, dim=-1), rate)
    o = (w @ v).transpose(1, 2).reshape(b, t, dim)
    return dense(W, p + ".out", o)


def ebranchformer_block(W, p: str, x, pos, lengths, m: dict,
                        d: Optional[Drop]):
    eps, rate = m["norm_eps"], m["dropout"]
    x = ffn(W, p + ".ff_module_1", x, d, rate, m["fc_factor"], eps)
    g = drop(d, rel_attention(W, p + ".attn",
                              layer_norm(W, p + ".norm_mha", x, eps), pos,
                              lengths, m["num_heads"], d,
                              m["attention_dropout"]), rate)
    c = p + ".cgmlp"
    y = F.gelu(dense(W, c + ".channel_proj1",
                     layer_norm(W, p + ".norm_mlp", x, eps)))
    x_r, x_g = y.chunk(2, dim=-1)
    gate = depthwise(W, c + ".conv", layer_norm(W, c + ".norm", x_g, eps))
    loc = drop(d, dense(W, c + ".channel_proj2",
                        drop(d, x_r * gate, rate)), rate)
    cat = torch.cat([g, loc], dim=-1)
    x = x + drop(d, dense(W, p + ".merge_proj",
                          cat + depthwise(W, p + ".depthwise_conv_fusion",
                                          cat)), rate)
    x = ffn(W, p + ".ff_module_2", x, d, rate, m["fc_factor"], eps)
    return layer_norm(W, p + ".norm_final", x, eps)


def encode(W, m: dict, wav, lengths=None, d: Optional[Drop] = None):
    """f32 wav [B, T] (int16 scaled by 1 / 32768), frame lengths [B] ->
    [B, ceil(ceil(T / hop) / 4), d]."""
    if wav.dtype == torch.int16:
        wav = wav.float() / 32768.0
    hop = m["sample_rate"] * m["stride_ms"] // 1000
    x = subsampling(W, log_mel(wav, hop, m["n_mels"], m["sample_rate"]),
                    m["reduction_factor"])
    dim = x.shape[-1]
    x = drop(d, x * math.sqrt(dim), m["positional_dropout"])
    pos = drop(d, rel_positions(x.shape[1], dim), m["positional_dropout"])
    for i in range(m["num_blocks"]):
        x = ebranchformer_block(W, f"encoder.blocks.{i}", x, pos, lengths, m,
                                d)
    return layer_norm(W, "encoder.after_norm", x, m["norm_eps"])


# -- the heads ----------------------------------------------------------------

def batch_norm(W, p: str, x, training: bool):
    if training:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = torch.clamp_min((x * x).mean(axes) - mean * mean, 0.0)
    else:
        mean, var = W[p + ".running_mean"], W[p + ".running_var"]
    return (x - mean) * torch.rsqrt(var + HEAD_EPS) * W[p + ".weight"] \
        + W[p + ".bias"]


def mha(W, p: str, q_in, kv_in, heads: int):
    b, lq, dim = q_in.shape
    hd = dim // heads
    q = dense(W, p + ".query", q_in).view(b, lq, heads, hd).transpose(1, 2)
    k = dense(W, p + ".key", kv_in).view(b, -1, heads, hd).transpose(1, 2)
    v = dense(W, p + ".value", kv_in).view(b, -1, heads, hd).transpose(1, 2)
    w = torch.softmax((q / math.sqrt(hd)) @ k.transpose(-1, -2), dim=-1)
    return dense(W, p + ".out", (w @ v).transpose(1, 2).reshape(b, lq, dim))


def sincos(length: int, dim: int) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float64)[:, None]
    idx = torch.arange(dim)[None]
    angle = pos / torch.pow(10000.0, (2.0 * (idx // 2)) / dim)
    return torch.where(idx % 2 == 0, torch.sin(angle),
                       torch.cos(angle)).float()


def conformer_block(W, p: str, x, m: dict, kind: str, d: Optional[Drop],
                    enc=None):
    """A head's Conformer block (``kind`` ctcdecoder or translator; a
    translator block cross-attends ``enc``)."""
    rate, scale = m[kind + "_dropout"], m[kind + "_fc_factor"]
    x = ffn(W, p + ".ff_module_1", x, d, rate, scale, HEAD_EPS)
    if enc is None:
        y = layer_norm(W, p + ".mhsa.ln", x, HEAD_EPS)
        x = x + drop(d, mha(W, p + ".mhsa.mha", y, y, m["num_heads"]), rate)
    else:
        y = layer_norm(W, p + ".rmhsa.ln", x + sincos(x.shape[1], x.shape[2]),
                       HEAD_EPS)
        x = x + drop(d, mha(W, p + ".rmhsa.mha", y, enc, m["num_heads"]),
                     rate)
    c = p + ".conv_module"
    y = dense(W, c + ".pw_conv_1", layer_norm(W, c + ".ln", x, HEAD_EPS))
    a, gate = y.chunk(2, dim=-1)
    y = depthwise(W, c + ".dw_conv", a * torch.sigmoid(gate))
    y = batch_norm(W, c + ".bn", dense(W, c + ".dw_pw", y), d is not None)
    x = x + drop(d, dense(W, c + ".pw_conv_2", F.silu(y)), rate)
    x = ffn(W, p + ".ff_module_2", x, d, rate, scale, HEAD_EPS)
    return layer_norm(W, p + ".ln", x, HEAD_EPS)


def ctc_logits(W, m: dict, enc, d: Optional[Drop] = None):
    x = dense(W, "ctc_decoder.project", enc)
    for i in range(m["ctcdecoder_num_blocks"]):
        x = conformer_block(W, f"ctc_decoder.blocks.{i}", x, m, "ctcdecoder",
                            d)
    return dense(W, "ctc_decoder.fully_connected", x)


def translate(W, m: dict, ids, enc, d: Optional[Drop] = None):
    x = W["translator.inp_embedding.weight"][ids.long()]
    for i in range(m["translator_num_blocks"]):
        x = conformer_block(W, f"translator.blocks.{i}", x, m, "translator",
                            d, enc)
    return dense(W, "translator.fully_connected", x)


# -- decoding and training ----------------------------------------------------

def greedy(logits, lengths, blank: int):
    """Frame argmax, repeats merged, blanks dropped: (ids [B, T] left-
    justified and zero padded, counts [B])."""
    ids = logits.argmax(-1)
    t = ids.shape[1]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], 1)
    keep = (torch.arange(t)[None] < lengths[:, None]) & (ids != blank) \
        & (ids != prev)
    out = torch.zeros_like(ids)
    for r in range(ids.shape[0]):
        kept = ids[r][keep[r]]
        out[r, :kept.numel()] = kept
    return out, keep.sum(1)


def mask_loss(labels, logits):
    ce = F.cross_entropy(logits.transpose(1, 2), labels.long(),
                         reduction="none")
    need = (labels != 0).float()
    pad = (labels == 0).float()
    return (ce.mean(-1) + (ce * need).sum() / (need.sum() + 1e-6)
            + (ce * pad).sum() / (pad.sum() + 1e-6))


def train_loss(W, m: dict, batch: Dict[str, torch.Tensor], d: Drop):
    """mean(CTC (probabilities floored at 1e-7) + 2 (2 translator loss on
    the label phones + 5 pads + translator loss on the greedy ids))."""
    enc = encode(W, m, batch["wav"], batch["input_length"], d)
    logits = ctc_logits(W, m, enc, d)
    blank = logits.shape[-1] - 1
    decoded, _ = greedy(logits.detach(), batch["input_length"], blank)
    label_out = translate(W, m, F.pad(batch["phones"], (0, 5)), enc, d)
    ctc_out = translate(W, m, decoded, enc, d)
    logp = torch.logaddexp(F.log_softmax(logits, -1),
                           torch.tensor(math.log(1e-7)))
    ctc = F.ctc_loss(logp.transpose(0, 1), batch["phones"].long(),
                     batch["input_length"].long(),
                     batch["phone_length"].long(), blank=blank,
                     reduction="none", zero_infinity=True)
    u = batch["chars"].shape[1]
    tl = 2.0 * mask_loss(batch["chars"], label_out[:, :u]) \
        + mask_loss(batch["chars"], ctc_out[:, :u])
    return (ctc + 2.0 * tl).mean()


def train_step(W: Dict[str, torch.Tensor], m: dict, batch,
               generator: torch.Generator, lr: float, b1: float, b2: float,
               eps: float) -> dict:
    """One step from ``W`` (left as it is) with fresh Adam moments:
    {"loss", "grad": {name: gradient}, "new": {name: updated weight}} over
    the parameters (the running statistics are left out)."""
    names: List[str] = [k for k in W if not k.endswith(
        ("running_mean", "running_var"))]
    params = {k: W[k].detach().clone().requires_grad_(True) for k in names}
    work = dict(W, **params)
    loss = train_loss(work, m, batch, Drop(m["dropout"], generator))
    grads = torch.autograd.grad(loss, [params[k] for k in names])
    new = {}
    for k, g in zip(names, grads):
        m1, m2 = (1 - b1) * g, (1 - b2) * g * g
        step = lr * (m1 / (1 - b1)) / ((m2 / (1 - b2)).sqrt() + eps)
        new[k] = W[k] - step
    return {"loss": float(loss.detach()), "grad": dict(zip(names, grads)),
            "new": new}
