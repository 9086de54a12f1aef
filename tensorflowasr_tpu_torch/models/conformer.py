"""Offline Conformer-CTC model (inference and training).

Counterpart of ``tensorflowasr_tpu/models/conformer.py``:

- MelFrontend       wav -> log-mel (or dB spectrogram); the power spectrum
                    runs the K1 kernel on a CUDA tensor
- ConformerEncoder  mel -> ConvSubsampling -> N x ConformerBlock
- StreamingConformerEncoder
                    the block-streaming encoder: fixed-size time chunks
                    folded into the batch axis before the frontend, so no
                    chunk sees another
- CTCDecoder        Dense -> M x ConformerBlock -> Dense(classes) in f32
- Translator        phone embedding -> N x RBlock (cross-attention with PE)
                    -> Dense(char classes) in f32
- ConformerCTC      bundle with ``encode`` / ``ctc_logits`` / ``translate``
                    and the trainer's ``train_forward``

In training mode (``model.train()``) dropout, batch-statistics BatchNorm and
(with ``spec_augment``) SpecAugment on the log-mel are active; their random
draws come from the generator handed over with ``layers.set_generator``.

``mel_layer_type: leaf`` puts the LEAF frontend (``models/leaf.py``) in
place of the log-mel; ``add_wav_info`` adds a ``WavePickModel``
(``models/wav_model.py``) of the raw wav to the subsampled features.
Weights come from ``models/convert.py`` (flax variables) or from
:func:`build_model`'s seeded random init.

The recorder (``utils/telemetry.py``) keeps three stages as leaf spans,
``tasr::`` ranges in a profiler's trace: ``conformer.stack`` (subsampling
and blocks, after the log-mel op), ``conformer.ctc_head`` and
``conformer.translator``. On the card, in inference, each stage's body
replays as a CUDA graph of its input signature once the signature repeats
(``models/graphs.py``); a replay's span opens the range ``tasr.<stage>``,
which no trace reduction credits with device time. Every call of a stage
records the counter ``conformer.graph``, 1 on a replay and 0 on an eager
body.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tensorflowasr_tpu_torch.models.graphs import GraphedStage
from tensorflowasr_tpu_torch.models.leaf import Leaf
from tensorflowasr_tpu_torch.models.layers import (
    BatchNorm,
    ConformerBlock,
    ConvSubsampling,
    Dense,
    RBlock,
    init_weights_,
)
from tensorflowasr_tpu_torch.models.wav_model import WavePickModel
from tensorflowasr_tpu_torch.ops import frontend as fe
from tensorflowasr_tpu_torch.ops.ctc import collapse_and_remove_blank
from tensorflowasr_tpu_torch.ops.specaug import spec_augment
from tensorflowasr_tpu_torch.utils.device import resolve_device

N_FFT = 1024

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    """The conformerS.yml ``model_config`` plus the ``speech_config``
    fields the model needs."""

    # encoder
    dmodel: int = 144
    reduction_factor: int = 4
    num_blocks: int = 13
    head_size: int = 36
    num_heads: int = 4
    kernel_size: int = 32
    fc_factor: float = 0.5
    dropout: float = 0.1
    # ctc decoder
    ctcdecoder_num_blocks: int = 1
    ctcdecoder_kernel_size: int = 32
    ctcdecoder_fc_factor: float = 0.5
    ctcdecoder_dropout: float = 0.1
    # translator
    translator_num_blocks: int = 2
    translator_kernel_size: int = 32
    translator_fc_factor: float = 0.5
    translator_dropout: float = 0.1
    # frontend / speech
    sample_rate: int = 16000
    n_mels: int = 80
    stride_ms: int = 10
    # Melspectrogram | Spectrogram | leaf
    mel_layer_type: str = "Melspectrogram"
    mel_layer_trainable: bool = False
    add_wav_info: bool = False
    # SpecAugment on the log-mel, on the device (training mode only)
    spec_augment: bool = False
    specaug_freq_masks: int = 2
    specaug_freq_width: int = 27
    specaug_time_masks: int = 2
    specaug_time_ratio: float = 0.05
    # the block-streaming encoder and its chunk length in seconds
    streaming: bool = False
    streaming_bucket: float = 0.5
    # compute
    dtype_str: str = "float32"               # compute dtype for matmuls
    # scan_layers / scan_unroll choose how the JAX package traces its
    # encoder stack for the XLA compiler. Eager PyTorch compiles nothing,
    # so both are read (the shipped YAMLs may set them) and change nothing:
    # the blocks are always ``encoder.blocks.{i}``.
    scan_layers: bool = False
    scan_unroll: int = 1
    # recompute each encoder block's activations in the backward pass
    # (``torch.utils.checkpoint``) instead of storing them
    remat_blocks: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype_str]

    @property
    def model_class(self) -> type:
        return ConformerCTC

    @property
    def hop_size(self) -> int:
        return self.sample_rate * self.stride_ms // 1000

    @property
    def chunk_samples(self) -> int:
        """Samples a streaming chunk, ``streaming_bucket`` seconds rounded
        down to whole encoder frames (hop x reduction factor), at least
        one."""
        quantum = self.hop_size * self.reduction_factor
        raw = int(self.streaming_bucket * self.sample_rate)
        return max(quantum, (raw // quantum) * quantum)

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
            dropout=g(mc, "dropout", 0.1),
            ctcdecoder_num_blocks=g(mc, "ctcdecoder_num_blocks", 1),
            ctcdecoder_kernel_size=g(mc, "ctcdecoder_kernel_size", 32),
            ctcdecoder_fc_factor=g(mc, "ctcdecoder_fc_factor", 0.5),
            ctcdecoder_dropout=g(mc, "ctcdecoder_dropout", 0.1),
            translator_num_blocks=g(mc, "translator_num_blocks", 2),
            translator_kernel_size=g(mc, "translator_kernel_size", 32),
            translator_fc_factor=g(mc, "translator_fc_factor", 0.5),
            translator_dropout=g(mc, "translator_dropout", 0.1),
            sample_rate=g(sc, "sample_rate", 16000),
            n_mels=g(sc, "num_feature_bins", 80),
            stride_ms=g(sc, "stride_ms", 10),
            mel_layer_type=g(sc, "mel_layer_type", "Melspectrogram"),
            mel_layer_trainable=g(sc, "mel_layer_trainable", False),
            add_wav_info=g(sc, "add_wav_info", False),
            spec_augment=g(sc, "spec_augment", False),
            specaug_freq_masks=g(sc, "specaug_freq_masks", 2),
            specaug_freq_width=g(sc, "specaug_freq_width", 27),
            specaug_time_masks=g(sc, "specaug_time_masks", 2),
            specaug_time_ratio=g(sc, "specaug_time_ratio", 0.05),
            streaming=g(sc, "streaming", False),
            streaming_bucket=g(sc, "streaming_bucket", 0.5),
            dtype_str=dtype_str,
            scan_layers=g(mc, "scan_layers", False),
            scan_unroll=g(mc, "scan_unroll", 1),
            remat_blocks=g(mc, "remat_blocks", False),
        )


class MelFrontend(nn.Module):
    """wav [B, T] -> log-mel [B, ceil(T/hop), n_mels] (Melspectrogram),
    dB power spectrum [B, F, n_freq] (Spectrogram) or LEAF features [B, F,
    n_mels] (leaf, the submodule ``leaf``)."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        if cfg.mel_layer_type not in ("Melspectrogram", "Spectrogram",
                                      "leaf"):
            raise ValueError(
                f"unknown mel_layer_type {cfg.mel_layer_type!r}")
        self.mel_layer_type = cfg.mel_layer_type
        self.fcfg = fe.LogMelFrontendConfig(
            sample_rate=cfg.sample_rate, n_fft=N_FFT,
            stride_ms=cfg.stride_ms, n_mels=cfg.n_mels, padding="same")
        self.freq2mel = self.leaf = None
        if cfg.mel_layer_type == "leaf":
            self.leaf = Leaf(n_filters=cfg.n_mels,
                             sample_rate=cfg.sample_rate,
                             window_stride_ms=cfg.stride_ms)
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
        if self.leaf is not None:
            return self.leaf(wav)
        return fe.log_mel_spectrogram(wav, self.fcfg,
                                      mel_weights=self.freq2mel)


def _remat(block: nn.Module, x: torch.Tensor,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """``block(x)`` whose activations are recomputed in the backward pass.
    The recomputation replays the generator from the state it had at the
    first run, so it draws the same dropout masks, and leaves the BatchNorm
    running statistics alone, which the first run already moved."""
    start = None if generator is None else generator.get_state()
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    first = [True]

    def run(x):
        if first[0]:
            first[0] = False
            return block(x)
        now = None if generator is None else generator.get_state()
        for m in norms:
            m.track_stats = False
        try:
            if generator is not None:
                generator.set_state(start)
            return block(x)
        finally:
            for m in norms:
                m.track_stats = True
            if generator is not None:
                generator.set_state(now)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class ConformerEncoder(GraphedStage):
    """wav [B, T(,1)] -> [B, ceil(ceil(T/hop)/rf), dmodel] f32."""

    def __init__(self, cfg: ConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.generator: Optional[torch.Generator] = None   # SpecAugment
        self.mel_layer = MelFrontend(cfg)
        self.conv_subsampling = ConvSubsampling(
            cfg.dmodel, self.mel_layer.out_features, cfg.reduction_factor,
            cfg.dropout, cfg.dtype)
        self.wav_layer = None
        if cfg.add_wav_info:
            self.wav_layer = WavePickModel(
                cfg.dmodel, cfg.hop_size * cfg.reduction_factor, cfg.dtype)
        self.blocks = nn.ModuleList([
            ConformerBlock(cfg.dmodel, cfg.dropout, cfg.fc_factor,
                           cfg.head_size, cfg.num_heads, cfg.kernel_size,
                           cfg.dtype)
            for _ in range(cfg.num_blocks)])

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        wav = fe.wav_to_float(wav)
        return self._stack(self.mel_layer(wav), wav)

    def _stack(self, mel: torch.Tensor, wav: torch.Tensor) -> torch.Tensor:
        """log-mel [B, F, n_mels] -> SpecAugment in training mode ->
        subsampling (+ the ``wav_layer`` features of ``wav`` [B, T(, 1)]
        under ``add_wav_info``) -> blocks -> [B, T', dmodel] f32: the
        stage ``conformer.stack``, after the log-mel op."""
        inputs = (mel,) if self.wav_layer is None else (mel, wav)
        return self.stage_graphs(self, "conformer.stack", self._stack_body,
                                 inputs)

    def _stack_body(self, mel: torch.Tensor,
                    wav: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = self.cfg
        if self.training and c.spec_augment:
            if self.generator is None:
                raise RuntimeError("training-mode SpecAugment needs a "
                                   "generator: call set_generator first")
            mel = spec_augment(
                mel, self.generator, n_freq_masks=c.specaug_freq_masks,
                freq_width=c.specaug_freq_width,
                n_time_masks=c.specaug_time_masks,
                time_ratio=c.specaug_time_ratio)
        x = self.conv_subsampling(mel[..., None])
        if self.wav_layer is not None:
            x = x + self.wav_layer(wav)[:, :x.shape[1]]
        remat = c.remat_blocks and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            x = _remat(block, x, self.generator) if remat else block(x)
        return x.to(torch.float32)


class StreamingConformerEncoder(ConformerEncoder):
    """The block-streaming encoder: wav [B, n * chunk(, 1)] is cut into
    [B * n, chunk] before the frontend, the offline stack runs on every
    chunk alone (SpecAugment's ``time_ratio`` is of a chunk) and the output
    is [B, n * T'_chunk, dmodel]. The 'same' log-mel is normalised by each
    chunk's own maximum and padded at each chunk's edges, so folding after
    the frontend would not give these numbers; ``wav_layer`` sees the
    folded chunks too. The submodules and their parameter names are the
    offline encoder's."""

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        wav = fe.wav_to_float(wav)
        if wav.dim() == 3:
            wav = wav[..., 0]
        b, t = wav.shape
        chunk = self.cfg.chunk_samples
        if t % chunk != 0:
            raise ValueError(f"input length {t} not a multiple of the "
                             f"streaming chunk {chunk}")
        folded = wav.reshape(b * (t // chunk), chunk)
        x = self._stack(self.mel_layer(folded), folded)
        return x.reshape(b, -1, self.cfg.dmodel)


class CTCDecoder(GraphedStage):
    """[B, T', dmodel] -> [B, T', num_classes] phone logits (f32 head)."""

    def __init__(self, cfg: ConformerConfig, num_classes: int):
        super().__init__()
        self.project = Dense(cfg.dmodel, cfg.dmodel, cfg.dtype)
        self.blocks = nn.ModuleList([
            ConformerBlock(cfg.dmodel, cfg.ctcdecoder_dropout,
                           cfg.ctcdecoder_fc_factor, cfg.head_size,
                           cfg.num_heads, cfg.ctcdecoder_kernel_size,
                           cfg.dtype)
            for _ in range(cfg.ctcdecoder_num_blocks)])
        self.fully_connected = Dense(cfg.dmodel, num_classes, torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.stage_graphs(self, "conformer.ctc_head", self._body,
                                 (x,))

    def _body(self, x: torch.Tensor) -> torch.Tensor:
        x = self.project(x)
        for block in self.blocks:
            x = block(x)
        return self.fully_connected(x)


class Translator(GraphedStage):
    """(phone ids [B, U], enc [B, T', dmodel]) -> char logits [B, U,
    classes]: a non-autoregressive pass of cross-attention RBlocks."""

    def __init__(self, cfg: ConformerConfig, inp_classes: int,
                 tar_classes: int):
        super().__init__()
        self.compute_dtype = cfg.dtype
        self.inp_embedding = nn.Embedding(inp_classes, cfg.dmodel)
        self.blocks = nn.ModuleList([
            RBlock(cfg.dmodel, cfg.translator_dropout,
                   cfg.translator_fc_factor, cfg.head_size, cfg.num_heads,
                   cfg.translator_kernel_size, cfg.dtype)
            for _ in range(cfg.translator_num_blocks)])
        self.fully_connected = Dense(cfg.dmodel, tar_classes, torch.float32)

    def forward(self, phone_ids: torch.Tensor, enc: torch.Tensor
                ) -> torch.Tensor:
        return self.stage_graphs(self, "conformer.translator", self._body,
                                 (phone_ids, enc))

    def _body(self, phone_ids: torch.Tensor, enc: torch.Tensor
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
    - ``encode(wav, lengths)``    -> enc [B, T', dmodel] f32
    - ``ctc_logits(enc)``         -> phone logits [B, T', n_phone] f32
    - ``translate(ids, enc)``     -> char logits [B, U, n_char] f32
    - ``train_forward(wav, phones, input_length)`` -> the trainer's forward
    """

    def __init__(self, cfg: ConformerConfig, num_phone_classes: int,
                 num_char_classes: int):
        super().__init__()
        self.cfg = cfg
        self.num_phone_classes = num_phone_classes
        self.num_char_classes = num_char_classes
        self.encoder = self._encoder(cfg)
        self.ctc_decoder = CTCDecoder(cfg, num_phone_classes)
        self.translator = Translator(cfg, num_phone_classes,
                                     num_char_classes)

    @staticmethod
    def _encoder(cfg: ConformerConfig) -> nn.Module:
        return (StreamingConformerEncoder if cfg.streaming
                else ConformerEncoder)(cfg)

    def forward(self, wav: torch.Tensor, phone_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        enc = self.encode(wav)
        return enc, self.ctc_logits(enc), self.translate(phone_ids, enc)

    def train_forward(self, wav: torch.Tensor, phones: torch.Tensor,
                      input_length: torch.Tensor):
        """The CTC train step's forward: encoder -> CTC logits -> greedy
        decode of the detached logits -> translator on the ground-truth
        phones (+ 5 zero pads) and on the decoded ids, which keep their
        static [B, T'] shape. Returns (enc, ctc_logits, decoded, label_out
        [B, L + 5, n_char], ctc_out [B, T', n_char])."""
        blank_id = self.num_phone_classes - 1
        enc = self.encode(wav, input_length)
        ctc_logits = self.ctc_decoder(enc)
        ids = torch.argmax(ctc_logits.detach().to(torch.float32), dim=-1)
        decoded, _ = collapse_and_remove_blank(ids.to(torch.int32),
                                               input_length, blank_id)
        label_out = self.translator(F.pad(phones, (0, 5)), enc)
        ctc_out = self.translator(decoded, enc)
        return enc, ctc_logits, decoded, label_out, ctc_out

    def encode(self, wav: torch.Tensor,
               lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``lengths`` (valid encoder frames a row) are ignored: no layer
        of a Conformer mixes frames through a mask."""
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
    """The configuration's model (``cfg.model_class``: a ConformerCTC, or
    an EBranchformerCTC for an ``EBranchformerConfig``) in eval mode on
    ``device`` with seeded Keras-style random weights (load real ones with
    ``load_state_dict``)."""
    dev = resolve_device(device)
    model = cfg.model_class(cfg, num_phone_classes, num_char_classes)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def count_params(model: nn.Module) -> int:
    """Total parameter count of a module: the same number as the JAX
    package's ``count_params`` over the flax ``params`` tree of the same
    model (BatchNorm statistics and fixed tables are buffers here, and
    outside ``params`` there)."""
    return sum(p.numel() for p in model.parameters())
