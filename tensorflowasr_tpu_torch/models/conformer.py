"""Offline Conformer-CTC model (inference).

Counterpart of ``tensorflowasr_tpu/models/conformer.py``:

- MelFrontend       wav -> log-mel (or dB spectrogram); the power spectrum
                    runs the K1 kernel on a CUDA tensor
- ConformerEncoder  mel -> ConvSubsampling -> N x ConformerBlock
- CTCDecoder        Dense -> M x ConformerBlock -> Dense(classes) in f32
- Translator        phone embedding -> N x RBlock (cross-attention with PE)
                    -> Dense(char classes) in f32
- ConformerCTC      bundle with ``encode`` / ``ctc_logits`` / ``translate``

The block-streaming encoder, the LEAF frontend and ``add_wav_info`` are not
ported yet and raise. Weights come from ``models/convert.py`` (flax
variables) or from :func:`build_model`'s seeded random init.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowasr_tpu_torch.models.layers import (
    ConformerBlock,
    ConvSubsampling,
    Dense,
    RBlock,
    init_weights_,
)
from tensorflowasr_tpu_torch.ops import frontend as fe
from tensorflowasr_tpu_torch.utils.device import resolve_device

N_FFT = 1024

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    """The conformerS.yml ``model_config`` plus the ``speech_config``
    fields the model needs (the serving subset of the JAX config)."""

    # encoder
    dmodel: int = 144
    reduction_factor: int = 4
    num_blocks: int = 13
    head_size: int = 36
    num_heads: int = 4
    kernel_size: int = 32
    fc_factor: float = 0.5
    # ctc decoder
    ctcdecoder_num_blocks: int = 1
    ctcdecoder_kernel_size: int = 32
    ctcdecoder_fc_factor: float = 0.5
    # translator
    translator_num_blocks: int = 2
    translator_kernel_size: int = 32
    translator_fc_factor: float = 0.5
    # frontend / speech
    sample_rate: int = 16000
    n_mels: int = 80
    stride_ms: int = 10
    mel_layer_type: str = "Melspectrogram"   # Melspectrogram | Spectrogram
    mel_layer_trainable: bool = False
    add_wav_info: bool = False
    streaming: bool = False
    # compute
    dtype_str: str = "float32"               # compute dtype for matmuls

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype_str]

    @property
    def hop_size(self) -> int:
        return self.sample_rate * self.stride_ms // 1000

    @classmethod
    def from_user_config(cls, config, dtype_str: str = "float32"
                         ) -> "ConformerConfig":
        mc = config["model_config"] or {}
        sc = config["speech_config"] or {}

        def g(d, k, default):
            v = d.get(k) if hasattr(d, "get") else None
            return default if v is None else v
        return cls(
            dmodel=g(mc, "dmodel", 144),
            reduction_factor=g(mc, "reduction_factor", 4),
            num_blocks=g(mc, "num_blocks", 13),
            head_size=g(mc, "head_size", 36),
            num_heads=g(mc, "num_heads", 4),
            kernel_size=g(mc, "kernel_size", 32),
            fc_factor=g(mc, "fc_factor", 0.5),
            ctcdecoder_num_blocks=g(mc, "ctcdecoder_num_blocks", 1),
            ctcdecoder_kernel_size=g(mc, "ctcdecoder_kernel_size", 32),
            ctcdecoder_fc_factor=g(mc, "ctcdecoder_fc_factor", 0.5),
            translator_num_blocks=g(mc, "translator_num_blocks", 2),
            translator_kernel_size=g(mc, "translator_kernel_size", 32),
            translator_fc_factor=g(mc, "translator_fc_factor", 0.5),
            sample_rate=g(sc, "sample_rate", 16000),
            n_mels=g(sc, "num_feature_bins", 80),
            stride_ms=g(sc, "stride_ms", 10),
            mel_layer_type=g(sc, "mel_layer_type", "Melspectrogram"),
            mel_layer_trainable=g(sc, "mel_layer_trainable", False),
            add_wav_info=g(sc, "add_wav_info", False),
            streaming=g(sc, "streaming", False),
            dtype_str=dtype_str,
        )


class MelFrontend(nn.Module):
    """wav [B, T] -> log-mel [B, ceil(T/hop), n_mels] (Melspectrogram) or
    dB power spectrum [B, F, n_freq] (Spectrogram)."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        if cfg.mel_layer_type not in ("Melspectrogram", "Spectrogram"):
            raise NotImplementedError(
                f"mel_layer_type {cfg.mel_layer_type!r} is not ported yet")
        self.mel_layer_type = cfg.mel_layer_type
        self.fcfg = fe.LogMelFrontendConfig(
            sample_rate=cfg.sample_rate, n_fft=N_FFT,
            stride_ms=cfg.stride_ms, n_mels=cfg.n_mels, padding="same")
        self.freq2mel = None
        if cfg.mel_layer_trainable and cfg.mel_layer_type == "Melspectrogram":
            self.freq2mel = nn.Parameter(torch.from_numpy(
                fe.mel_filterbank(cfg.sample_rate, N_FFT, cfg.n_mels)))

    @property
    def out_features(self) -> int:
        if self.mel_layer_type == "Spectrogram":
            return self.fcfg.n_freq
        return self.fcfg.n_mels

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if wav.dim() == 3:
            wav = wav[..., 0]
        if self.mel_layer_type == "Spectrogram":
            return fe.spectrogram_feature(wav, self.fcfg)
        return fe.log_mel_spectrogram(wav, self.fcfg,
                                      mel_weights=self.freq2mel)


class ConformerEncoder(nn.Module):
    """wav [B, T(,1)] -> [B, ceil(ceil(T/hop)/rf), dmodel] f32."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        if cfg.add_wav_info:
            raise NotImplementedError("add_wav_info is not ported yet")
        self.mel_layer = MelFrontend(cfg)
        self.conv_subsampling = ConvSubsampling(
            cfg.dmodel, self.mel_layer.out_features, cfg.reduction_factor,
            cfg.dtype)
        self.blocks = nn.ModuleList([
            ConformerBlock(cfg.dmodel, cfg.fc_factor, cfg.head_size,
                           cfg.num_heads, cfg.kernel_size, cfg.dtype)
            for _ in range(cfg.num_blocks)])

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        mel = self.mel_layer(fe.wav_to_float(wav))
        x = self.conv_subsampling(mel[..., None])
        for block in self.blocks:
            x = block(x)
        return x.to(torch.float32)


class CTCDecoder(nn.Module):
    """[B, T', dmodel] -> [B, T', num_classes] phone logits (f32 head)."""

    def __init__(self, cfg: ConformerConfig, num_classes: int):
        super().__init__()
        self.project = Dense(cfg.dmodel, cfg.dmodel, cfg.dtype)
        self.blocks = nn.ModuleList([
            ConformerBlock(cfg.dmodel, cfg.ctcdecoder_fc_factor,
                           cfg.head_size, cfg.num_heads,
                           cfg.ctcdecoder_kernel_size, cfg.dtype)
            for _ in range(cfg.ctcdecoder_num_blocks)])
        self.fully_connected = Dense(cfg.dmodel, num_classes, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.project(x)
        for block in self.blocks:
            x = block(x)
        return self.fully_connected(x)


class Translator(nn.Module):
    """(phone ids [B, U], enc [B, T', dmodel]) -> char logits [B, U,
    classes]: a non-autoregressive pass of cross-attention RBlocks."""

    def __init__(self, cfg: ConformerConfig, inp_classes: int,
                 tar_classes: int):
        super().__init__()
        self.compute_dtype = cfg.dtype
        self.inp_embedding = nn.Embedding(inp_classes, cfg.dmodel)
        self.blocks = nn.ModuleList([
            RBlock(cfg.dmodel, cfg.translator_fc_factor, cfg.head_size,
                   cfg.num_heads, cfg.translator_kernel_size, cfg.dtype)
            for _ in range(cfg.translator_num_blocks)])
        self.fully_connected = Dense(cfg.dmodel, tar_classes, torch.float32)

    def forward(self, phone_ids: torch.Tensor, enc: torch.Tensor
                ) -> torch.Tensor:
        x = F.embedding(phone_ids.long(), self.inp_embedding.weight)
        x = x.to(self.compute_dtype)
        enc = enc.to(self.compute_dtype)
        for block in self.blocks:
            x = block(x, enc)
        return self.fully_connected(x)


class ConformerCTC(nn.Module):
    """Encoder + CTCDecoder + Translator.

    - ``forward(wav, phone_ids)`` -> (enc, ctc_logits, char_logits)
    - ``encode(wav)``             -> enc [B, T', dmodel] f32
    - ``ctc_logits(enc)``         -> phone logits [B, T', n_phone] f32
    - ``translate(ids, enc)``     -> char logits [B, U, n_char] f32
    """

    def __init__(self, cfg: ConformerConfig, num_phone_classes: int,
                 num_char_classes: int):
        super().__init__()
        if cfg.streaming:
            raise NotImplementedError(
                "the block-streaming encoder is not ported yet")
        self.cfg = cfg
        self.num_phone_classes = num_phone_classes
        self.num_char_classes = num_char_classes
        self.encoder = ConformerEncoder(cfg)
        self.ctc_decoder = CTCDecoder(cfg, num_phone_classes)
        self.translator = Translator(cfg, num_phone_classes,
                                     num_char_classes)

    def forward(self, wav: torch.Tensor, phone_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        enc = self.encode(wav)
        return enc, self.ctc_logits(enc), self.translate(phone_ids, enc)

    def encode(self, wav: torch.Tensor) -> torch.Tensor:
        return self.encoder(wav)

    def ctc_logits(self, enc: torch.Tensor) -> torch.Tensor:
        return self.ctc_decoder(enc)

    def translate(self, phone_ids: torch.Tensor, enc: torch.Tensor
                  ) -> torch.Tensor:
        return self.translator(phone_ids, enc)


def build_model(cfg: ConformerConfig, num_phone_classes: int,
                num_char_classes: int,
                device: Union[str, torch.device] = "cuda",
                seed: int = 0) -> ConformerCTC:
    """A ConformerCTC in eval mode on ``device`` with seeded Keras-style
    random weights (load real ones with ``load_state_dict``)."""
    dev = resolve_device(device)
    model = ConformerCTC(cfg, num_phone_classes, num_char_classes)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
