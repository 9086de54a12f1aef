"""Plain PyTorch E-Branchformer CTC, the reference of the
``ebranchformer_l`` cells: the E-Branchformer encoder (Kim et al.,
"E-Branchformer: Branchformer with Enhanced Merging for Speech
Recognition", SLT 2022, arXiv:2210.00077, as ESPnet's
``EBranchformerEncoderLayer`` computes it) under TensorflowASR's CTC head
and translator (``reference/conformer.py``'s).

wav -> 'same' log-mel -> conv subsampling (time / 4) -> x * sqrt(d) and the
sin / cos table of the relative positions T'-1 ... -(T'-1) -> blocks:

    x += 1/2 FFN(LN(x))               FFN = W2 swish(W1 .)
    g  = RelMHA(LN(x))                scores ((q+u).k_j + (q+v).p_{i-j})
                                      / sqrt(hd), keys at or past the
                                      row's length masked
    l  = W2 (x_r * DWConv(LN(x_g)))   [x_r, x_g] = GELU(W1 LN(x))
    x += Wm (c + DWConv(c))           c = [g, l]
    x += 1/2 FFN(LN(x)); x = LN(x)    LayerNorm epsilon 1e-12

-> LN. Eval mode only (the cell decodes). The position term is an explicit
gather of ``p_{i-j}``, not the program's shift. ``Prec`` rounds the
operands of every matrix product and convolution (``reference/blocks.py``).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from reference import blocks as B
from reference import conformer as ref
from reference.frontend import log_mel


def _ln(spec, p: str, d: int):
    spec[p + ".weight"] = ((d,), "one")
    spec[p + ".bias"] = ((d,), "zero")


def _dense(spec, p: str, out: int, inp: int, kind: str = "dense",
           bias: bool = True):
    spec[p + ".weight"] = ((out, inp), kind)
    if bias:
        spec[p + ".bias"] = ((out,), "zero")


def _depthwise(spec, p: str, c: int, k: int):
    spec[p + ".weight"] = ((c, 1, k), "depthwise")
    spec[p + ".bias"] = ((c,), "zero")


def _block_params(spec, p: str, m: dict):
    d, u, c = m["dmodel"], m["linear_units"], m["cgmlp_linear_units"]
    h = m["num_heads"]
    for ff in ("ff_module_1", "ff_module_2"):
        _ln(spec, f"{p}.{ff}.ln", d)
        _dense(spec, f"{p}.{ff}.ffn1", u, d)
        _dense(spec, f"{p}.{ff}.ffn2", d, u)
    _ln(spec, p + ".norm_mha", d)
    for proj in ("query", "key", "value"):
        _dense(spec, f"{p}.attn.{proj}", d, d, "attn_in")
    _dense(spec, p + ".attn.out", d, d, "attn_out")
    _dense(spec, p + ".attn.pos", d, d, "attn_in", bias=False)
    spec[p + ".attn.pos_bias_u"] = ((h, d // h), "dense")
    spec[p + ".attn.pos_bias_v"] = ((h, d // h), "dense")
    _ln(spec, p + ".norm_mlp", d)
    _dense(spec, p + ".cgmlp.channel_proj1", c, d)
    _ln(spec, p + ".cgmlp.norm", c // 2)
    _depthwise(spec, p + ".cgmlp.conv", c // 2, m["cgmlp_conv_kernel"])
    _dense(spec, p + ".cgmlp.channel_proj2", d, c // 2)
    _depthwise(spec, p + ".depthwise_conv_fusion", 2 * d,
               m["merge_conv_kernel"])
    _dense(spec, p + ".merge_proj", d, 2 * d)
    _ln(spec, p + ".norm_final", d)


def param_spec(m: dict, n_phone: int, n_char: int) -> "OrderedDict":
    """name -> (shape, kind) of every weight and statistic, under the
    program's names."""
    d = m["dmodel"]
    spec = OrderedDict()
    ref.subsampling_params(spec, "encoder.conv_subsampling", d,
                           -(-(-(-m["num_feature_bins"] // 2)) // 2))
    for i in range(m["num_blocks"]):
        _block_params(spec, f"encoder.blocks.{i}", m)
    _ln(spec, "encoder.after_norm", d)
    heads = ref.param_spec(dict(m, num_blocks=0), n_phone, n_char)
    for name in list(heads):
        if name.startswith("encoder."):
            del heads[name]
    spec.update(heads)
    return spec


def rel_positions(t: int, dim: int, device) -> torch.Tensor:
    """Row k: position t - 1 - k, [sin, cos] interleaved at the frequencies
    10000^(-2i / dim)."""
    pos = torch.arange(t - 1, -t, -1, dtype=torch.float64,
                       device=device)[:, None]
    freq = torch.pow(10000.0, -torch.arange(0, dim, 2, dtype=torch.float64,
                                            device=device) / dim)
    pe = torch.stack([torch.sin(pos * freq), torch.cos(pos * freq)], -1)
    return pe.reshape(2 * t - 1, dim).to(torch.float32)


class EBranchformer(ref.Conformer):
    """The forward passes over weights ``W`` at precision ``P`` (eval
    mode); ``ctc_logits`` and ``translate`` are the Conformer reference's
    heads."""

    def _ln(self, p: str, x):
        return F.layer_norm(x, (x.shape[-1],), self.W[p + ".weight"],
                            self.W[p + ".bias"], self.m["norm_eps"])

    def _ffn(self, p: str, x):
        y = F.silu(B.dense(self.W, p + ".ffn1", self._ln(p + ".ln", x),
                           self.P))
        return x + self.m["fc_factor"] * B.dense(self.W, p + ".ffn2", y,
                                                 self.P)

    def _depthwise(self, p: str, x):
        k = self.W[p + ".weight"].shape[-1]
        lo, hi = B.same_pad(x.shape[1], k, 1)
        return B.depthwise(self.W, p, x, self.P, lo, hi)

    def _attention(self, p: str, x, pos, lengths):
        W, P, h = self.W, self.P, self.heads
        b, t, dim = x.shape
        hd = dim // h
        q = B.dense(W, p + ".query", x, P).view(b, t, h, hd).transpose(1, 2)
        k = B.dense(W, p + ".key", x, P).view(b, t, h, hd).transpose(1, 2)
        v = B.dense(W, p + ".value", x, P).view(b, t, h, hd).transpose(1, 2)
        proj = torch.matmul(P.low(pos), P.low(W[p + ".pos.weight"]).t())
        proj = proj.view(-1, h, hd)                        # [2t-1, h, hd]
        i = torch.arange(t, device=x.device)[:, None]
        j = torch.arange(t, device=x.device)[None]
        content = torch.matmul(P.low(q + W[p + ".pos_bias_u"][:, None]),
                               P.low(k).transpose(-1, -2))
        position = torch.einsum(
            "bhic,ijhc->bhij", P.low(q + W[p + ".pos_bias_v"][:, None]),
            P.low(proj)[(t - 1) - (i - j)])                # p_{i-j}
        scores = (content + position) / math.sqrt(hd)
        if lengths is not None:
            keep = j < lengths.clamp_min(1)[:, None, None]      # [b, 1, t]
            scores = torch.where(keep[:, None], scores,
                                 torch.finfo(torch.float32).min)
        o = torch.matmul(P.low(torch.softmax(scores, dim=-1)), P.low(v))
        return B.dense(W, p + ".out", o.transpose(1, 2).reshape(b, t, dim), P)

    def _eblock(self, p: str, x, pos, lengths):
        x = self._ffn(p + ".ff_module_1", x)
        g = self._attention(p + ".attn", self._ln(p + ".norm_mha", x), pos,
                            lengths)
        c = p + ".cgmlp"
        y = F.gelu(B.dense(self.W, c + ".channel_proj1",
                           self._ln(p + ".norm_mlp", x), self.P))
        x_r, x_g = y.chunk(2, dim=-1)
        gate = self._depthwise(c + ".conv", self._ln(c + ".norm", x_g))
        loc = B.dense(self.W, c + ".channel_proj2", x_r * gate, self.P)
        cat = torch.cat([g, loc], dim=-1)
        x = x + B.dense(self.W, p + ".merge_proj",
                        cat + self._depthwise(p + ".depthwise_conv_fusion",
                                              cat), self.P)
        x = self._ffn(p + ".ff_module_2", x)
        return self._ln(p + ".norm_final", x)

    def encode(self, wav: torch.Tensor,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """int16 or f32 wav [B, T], frame lengths [B] -> [B, ceil(T / 640),
        dmodel]."""
        if wav.dtype == torch.int16:
            wav = wav.to(torch.float32) / 32768.0
        mel = log_mel(wav, same=True, hop=self.hop,
                      n_mels=self.m["num_feature_bins"])
        strides = ((self.rf // 2, 2), (2, 2))
        pads, t, f = [], mel.shape[1], mel.shape[2]
        for st in strides:
            pads.append((*B.same_pad(t, 3, st[0]), *B.same_pad(f, 3, st[1])))
            t, f = -(-t // st[0]), -(-f // st[1])
        x = B.conv_subsampling(self.W, "encoder.conv_subsampling", mel,
                               self.P, None, pads, strides)
        dim = x.shape[-1]
        x = x * math.sqrt(dim)
        pos = rel_positions(x.shape[1], dim, x.device)
        for i in range(self.m["num_blocks"]):
            x = self._eblock(f"encoder.blocks.{i}", x, pos, lengths)
        return self._ln("encoder.after_norm", x)


@torch.no_grad()
def calibrate(W: Dict[str, torch.Tensor], m: dict, wav: torch.Tensor,
              blank: int) -> float:
    """As ``reference/conformer.py::calibrate``, in place: the first conv's
    bias centres the log-mel of ``wav``, and the CTC head's blank bias
    moves by the median margin of the blank logit over the other classes
    on ``wav``. Returns the blank bias's move."""
    hop = m["sample_rate"] * m["stride_ms"] // 1000
    mean = log_mel(wav, same=True, hop=hop, n_mels=m["num_feature_bins"]
                   ).mean()
    w = W["encoder.conv_subsampling.conv1.weight"]
    W["encoder.conv_subsampling.conv1.bias"] -= mean * w.sum(dim=(1, 2, 3))
    model = EBranchformer(W, m)
    logits = model.ctc_logits(model.encode(wav))
    margin = (logits[..., blank] - logits[..., :blank].amax(-1)).median()
    W["ctc_decoder.fully_connected.bias"][blank] -= margin
    return -float(margin)
