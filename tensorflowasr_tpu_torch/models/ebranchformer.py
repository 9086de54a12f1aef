"""E-Branchformer CTC: the E-Branchformer encoder (Kim et al., "E-Branchformer:
Branchformer with Enhanced Merging for Speech Recognition", SLT 2022,
arXiv:2210.00077; ESPnet's ``EBranchformerEncoderLayer``) under the
offline family's CTC head and translator.

- front: the log-mel (``MelFrontend``), ``ConvSubsampling`` (time / 4, TF
  'SAME' pads), then ``x * sqrt(d)`` and the table of 2T' - 1 relative
  positions (``layers.RelPositionalEncoding``), both through dropout;
- each block (LayerNorm epsilon ``norm_eps``, 1e-12 as in ESPnet):
  ``x += fc_factor * FFN(LN(x))`` (hidden ``linear_units``, swish); a
  global branch ``g = Dropout(RelMHA(LN(x)))`` with the key mask of the
  rows' frame lengths; a local branch, the convolutional gating MLP
  ``l = Dropout(Linear(Dropout(x_r * DWConv(LN(x_g)))))`` with ``[x_r,
  x_g] = split(GELU(Linear(LN(x))))``; the merge ``x += Dropout(Linear(c
  + DWConv(c)))`` of ``c = [g, l]``; ``x += fc_factor * FFN(LN(x))``;
  ``x = LN(x)``;
- a final LayerNorm, then the Conformer family's ``CTCDecoder`` and
  ``Translator``.

``EBranchformerCTC`` has ``ConformerCTC``'s interface (``encode(wav,
lengths)``, ``ctc_logits``, ``translate``, ``train_forward``), so the
trainer, the predict step, the testers and ``ASREngine`` drive it as they
do a Conformer; ``model_config.name: EBranchformerCTC`` selects it
(:func:`offline_config`). ESPnet's layer drop is not implemented.

The recorder (``utils/telemetry.py``) keeps the stage
``ebranchformer.stack`` (subsampling, positions and blocks, after the
log-mel op; a ``tasr::`` range in a trace) and, inside it, the spans
``ebranchformer.attention``, ``ebranchformer.cgmlp`` and
``ebranchformer.merge`` of each block (``tasr.`` ranges).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowasr_tpu_torch.models.conformer import (
    ConformerConfig,
    ConformerCTC,
    MelFrontend,
)
from tensorflowasr_tpu_torch.models.layers import (
    ConvSubsampling,
    Dense,
    DepthwiseConv1D,
    Dropout,
    FFModule,
    LayerNorm,
    RelPositionalEncoding,
    RelPositionMultiHeadAttention,
    key_mask,
)
from tensorflowasr_tpu_torch.ops import frontend as fe
from tensorflowasr_tpu_torch.utils import telemetry

NAME = "EBranchformerCTC"


@dataclasses.dataclass(frozen=True)
class EBranchformerConfig(ConformerConfig):
    """``ConformerConfig`` (front, heads, compute dtype) plus the
    E-Branchformer encoder's own widths. ``num_heads`` x ``head_size`` is
    the encoder's and the heads' attention width, ``kernel_size`` unused
    by the encoder."""

    linear_units: int = 1024                 # macaron FFN hidden
    cgmlp_linear_units: int = 3072           # cgMLP hidden, split in two
    cgmlp_conv_kernel: int = 31
    merge_conv_kernel: int = 31
    attention_dropout: float = 0.1
    positional_dropout: float = 0.1
    norm_eps: float = 1e-12

    @property
    def model_class(self) -> type:
        return EBranchformerCTC

    @classmethod
    def from_user_config(cls, config, dtype_str: str = "float32"
                         ) -> "EBranchformerConfig":
        base = ConformerConfig.from_user_config(config, dtype_str)
        mc = config["model_config"] or {}
        own = {f.name: mc.get(f.name) for f in dataclasses.fields(cls)
               if f.name not in base.__dataclass_fields__}
        return cls(**dataclasses.asdict(base),
                   **{k: v for k, v in own.items() if v is not None})


def offline_config(config, dtype_str: str = "float32") -> ConformerConfig:
    """The offline family's configuration from the YAML sections: an
    :class:`EBranchformerConfig` for ``model_config.name:
    EBranchformerCTC``, a ``ConformerConfig`` for any other name."""
    mc = config["model_config"] or {}
    name = mc.get("name") if hasattr(mc, "get") else None
    cls = EBranchformerConfig if name == NAME else ConformerConfig
    return cls.from_user_config(config, dtype_str)


class ConvolutionalGatingMLP(nn.Module):
    """``channel_proj2(Dropout(x_r * conv(norm(x_g))))`` with ``[x_r,
    x_g] = split(GELU(channel_proj1(x)))``: no linear after the
    convolution, identity gate activation."""

    def __init__(self, dmodel: int, units: int, kernel: int,
                 dropout: float, eps: float, dtype: torch.dtype):
        super().__init__()
        if units % 2:
            raise ValueError(f"cgmlp_linear_units must be even, got {units}")
        self.channel_proj1 = Dense(dmodel, units, dtype)
        self.norm = LayerNorm(units // 2, eps)
        self.conv = DepthwiseConv1D(units // 2, kernel, dtype)
        self.dropout = Dropout(dropout)
        self.channel_proj2 = Dense(units // 2, dmodel, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_r, x_g = F.gelu(self.channel_proj1(x)).chunk(2, dim=-1)
        gate = self.conv(self.norm(x_g))
        return self.channel_proj2(self.dropout(x_r * gate))


class EBranchformerBlock(nn.Module):
    """FFN/2 -> [global RelMHA | local cgMLP] -> depthwise-conv merge ->
    FFN/2 -> LN."""

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        d, eps, dt = cfg.dmodel, cfg.norm_eps, cfg.dtype
        self.ff_module_1 = FFModule(d, cfg.dropout, cfg.fc_factor, dt,
                                    cfg.linear_units, eps)
        self.norm_mha = LayerNorm(d, eps)
        self.attn = RelPositionMultiHeadAttention(
            d, cfg.num_heads, cfg.attention_dropout, dt)
        self.norm_mlp = LayerNorm(d, eps)
        self.cgmlp = ConvolutionalGatingMLP(
            d, cfg.cgmlp_linear_units, cfg.cgmlp_conv_kernel, cfg.dropout,
            eps, dt)
        self.depthwise_conv_fusion = DepthwiseConv1D(
            2 * d, cfg.merge_conv_kernel, dt)
        self.merge_proj = Dense(2 * d, d, dt)
        self.ff_module_2 = FFModule(d, cfg.dropout, cfg.fc_factor, dt,
                                    cfg.linear_units, eps)
        self.norm_final = LayerNorm(d, eps)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.ff_module_1(x)
        with telemetry.span("ebranchformer.attention", shared=True):
            g = self.dropout(self.attn(self.norm_mha(x), pos, mask))
        with telemetry.span("ebranchformer.cgmlp", shared=True):
            loc = self.dropout(self.cgmlp(self.norm_mlp(x)))
        with telemetry.span("ebranchformer.merge", shared=True):
            c = torch.cat([g, loc], dim=-1)
            x = x + self.dropout(self.merge_proj(
                c + self.depthwise_conv_fusion(c)))
        x = self.ff_module_2(x)
        return self.norm_final(x)


class EBranchformerEncoder(nn.Module):
    """(wav [B, T(,1)], frame lengths [B] or None) -> [B, ceil(ceil(T /
    hop) / rf), dmodel] f32; a row's keys at or past its length are
    masked in every block's attention."""

    def __init__(self, cfg: EBranchformerConfig):
        super().__init__()
        unsupported = [k for k in ("streaming", "add_wav_info",
                                   "spec_augment", "remat_blocks")
                       if getattr(cfg, k)]
        if unsupported:
            raise ValueError(f"{NAME} does not support {unsupported}")
        if cfg.num_heads * cfg.head_size != cfg.dmodel:
            raise ValueError("num_heads x head_size must equal dmodel")
        self.cfg = cfg
        self.mel_layer = MelFrontend(cfg)
        self.conv_subsampling = ConvSubsampling(
            cfg.dmodel, self.mel_layer.out_features, cfg.reduction_factor,
            0.0, cfg.dtype)
        self.pos_enc = RelPositionalEncoding(cfg.dmodel,
                                             cfg.positional_dropout)
        self.blocks = nn.ModuleList([EBranchformerBlock(cfg)
                                     for _ in range(cfg.num_blocks)])
        self.after_norm = LayerNorm(cfg.dmodel, cfg.norm_eps)

    def forward(self, wav: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        mel = self.mel_layer(fe.wav_to_float(wav))
        with telemetry.span("ebranchformer.stack", leaf=True, shared=True):
            x, pos = self.pos_enc(self.conv_subsampling(mel[..., None]))
            mask = key_mask(lengths, x.shape[1])
            for block in self.blocks:
                x = block(x, pos, mask)
            return self.after_norm(x)


class EBranchformerCTC(ConformerCTC):
    """:class:`EBranchformerEncoder` + the Conformer family's CTCDecoder and
    Translator, with ``ConformerCTC``'s interface; ``encode(wav,
    lengths)`` masks each row's padded keys."""

    @staticmethod
    def _encoder(cfg: EBranchformerConfig) -> nn.Module:
        return EBranchformerEncoder(cfg)

    def encode(self, wav: torch.Tensor,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.encoder(wav, lengths)
