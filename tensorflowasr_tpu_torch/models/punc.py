"""Punctuation-recovery transformer with a BERT-feature distillation head.

Counterpart of ``tensorflowasr_tpu/models/punc.py``:

  char ids -> embedding * sqrt(d_model) + sin/cos PE -> Dense -> elu
           -> N x [post-LN EncoderLayer -> causal Conv1D(k=3) -> relu,
              inside an outer residual]
  -> Dense(bert_dim) (the distillation target) -> Dense(d_model)
  -> max(N - 1, 1) map EncoderLayers -> per-token punctuation classes

Submodule names are the flax names. Traps kept: LayerNorm epsilon is 1e-6
here (not the Conformer's 1e-3); the embedding is scaled by sqrt(d_model)
while the PE table is [pe_input, embedding_dim]; keys at pad positions (id
0) are masked with ``finfo(float32).min`` and the softmax is f32; the query
is scaled by 1/sqrt(head_dim); the BERT and class heads run in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowasr_tpu_torch.models.layers import (
    Conv1D,
    Dense,
    Dropout,
    LayerNorm,
    MultiHeadAttention,
    _pe_table,
)

PUNC_NORM_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class PuncConfig:
    num_layers: int = 3
    d_model: int = 64
    embedding_dim: int = 64
    num_heads: int = 8
    dff: int = 64
    pe_input: int = 1024
    dropout: float = 0.1
    bert_dim: int = 768

    @classmethod
    def from_user_config(cls, config) -> "PuncConfig":
        mc = config["model_config"] or {}
        return cls(
            num_layers=mc.get("num_layers", 3),
            d_model=mc.get("d_model", 64),
            embedding_dim=mc.get("enc_embedding_dim", 64),
            num_heads=mc.get("num_heads", 8),
            dff=mc.get("dff", 64),
            pe_input=mc.get("pe_input", 1024),
            dropout=mc.get("rate", 0.1),
            bert_dim=mc.get("bert_dim", 768),
        )


class EncoderLayer(nn.Module):
    """Post-LN transformer encoder layer: x + MHA(x) -> LN -> x + FFN(x)
    -> LN."""

    def __init__(self, d_model: int, num_heads: int, dff: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        # flax's attention kernels are glorot over the flattened (d, h*hd)
        # fans, the Keras Dense fans of the reference's projections
        limit = math.sqrt(6.0 / (2 * d_model))
        self.mha = MultiHeadAttention(d_model, num_heads,
                                      d_model // num_heads, d_model, dtype,
                                      init_limits=(limit, limit))
        self.ln1 = LayerNorm(d_model, PUNC_NORM_EPS)
        self.ffn1 = Dense(d_model, dff, dtype)
        self.ffn2 = Dense(dff, d_model, dtype)
        self.ln2 = LayerNorm(d_model, PUNC_NORM_EPS)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.ln1(x + self.dropout(self.mha(x, x, mask)))
        y = self.ffn2(F.relu(self.ffn1(x)))
        return self.ln2(x + self.dropout(y))


class PuncTransformer(nn.Module):
    """(char ids [B, T]) -> (punctuation logits [B, T, n_classes], BERT
    features [B, T, bert_dim])."""

    def __init__(self, cfg: PuncConfig, vocab_size: int,
                 num_punc_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.compute_dtype = dtype
        self.embedding = nn.Embedding(vocab_size, c.embedding_dim)
        self.dropout = Dropout(c.dropout)
        self.input_projecter = Dense(c.embedding_dim, c.d_model, dtype)
        for i in range(c.num_layers):
            self.add_module(f"enc_layer_{i}", EncoderLayer(
                c.d_model, c.num_heads, c.dff, c.dropout, dtype))
            self.add_module(f"cnn_{i}", Conv1D(c.d_model, c.d_model, 3,
                                               (2, 0), dtype=dtype))
        self.to_bert_embedding = Dense(c.d_model, c.bert_dim)
        self.to_hidden_state = Dense(c.bert_dim, c.d_model, dtype)
        self.num_map_layers = max(c.num_layers - 1, 1)
        for i in range(self.num_map_layers):
            self.add_module(f"map_layer_{i}", EncoderLayer(
                c.d_model, c.num_heads, c.dff, c.dropout, dtype))
        self.final_bd_layer = Dense(c.d_model, num_punc_classes)

    def forward(self, ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        key_ok = (ids != 0)[:, None, None, :]                  # [B,1,1,T]
        x = self.embedding(ids).to(self.compute_dtype)
        x = x * math.sqrt(c.d_model)
        pe = _pe_table(c.pe_input, c.embedding_dim, ids.device)
        x = self.dropout(x + pe[None, :ids.shape[1]].to(x.dtype))
        x = F.elu(self.input_projecter(x))
        for i in range(c.num_layers):
            plus = x
            x = getattr(self, f"enc_layer_{i}")(x, key_ok)
            x = F.relu(getattr(self, f"cnn_{i}")(x))
            x = x + plus
        bert_out = self.to_bert_embedding(x)
        y = self.to_hidden_state(bert_out)
        for i in range(self.num_map_layers):
            y = getattr(self, f"map_layer_{i}")(y, key_ok)
        return self.final_bd_layer(y), bert_out
