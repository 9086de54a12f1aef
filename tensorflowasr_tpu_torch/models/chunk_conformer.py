"""Chunk-streaming (SMLTA2) ChunkConformer: offline predict and streaming.

Counterpart of ``tensorflowasr_tpu/models/chunk_conformer.py``. Streaming
state is a dict of fixed-size tensors (ring buffers) with the JAX package's
keys and layouts, zero at a cold start:

- ChunkFront             'valid' (causal) log-mel, K1 on a CUDA tensor,
                         SpecAugment in training, and
                         ChunkConvSubsampling; state: the last chunk of wav
                         [B, chunk_samples] and a mel tail [B, chunk/rf,
                         n_mels, 1]
- ChunkMHSA              banded attention (query i sees keys [i - win_front,
                         i + win_back], with the reference's edge rules);
                         state: post-projection K/V rows [B, win_front,
                         2*H*hd], k rows then v rows
- ChunkConv              causal depthwise-separable conv; state: post-GLU
                         rows [B, kernel_size - 1, d], zero where invalid
- ChunkBlock             FF/2 -> ChunkMHSA -> ChunkConv -> FF/2 -> LN
- ChunkStack             N blocks; caches [L, B, ...]; the lookahead
                         (``num_blocks * win_back``) split
- ChunkCTCDecoder        Dense -> stack -> Dense(classes) in f32
- ContextHelper          phone embedding + stack
- feature_pick           stable compaction of the frames whose phone argmax
                         is not blank
- ChunkConformer         front -> encoder -> picker -> feature_pick ->
                         helper -> char decoder; ``train_forward`` adds the
                         text-only branch (helper.phone_call -> decoder)

A zero row in a cache is exactly the offline zero padding for the wav and
mel tails and for the conv ring (the conv input is zeroed where invalid);
attention masks invalid cache slots out by per-row ``fill`` / ``skip``
vectors. So streaming from a cold start equals the offline path.

Every step works on a batch of independent streams: ``fill``, ``skip`` and
``n_final`` are [B] vectors and every cache update selects per row, so
``fused_stream_step`` takes a slot batch directly (the JAX package vmaps its
batch-1 step) and ``batched_stream_step`` is a reset, that step and an
advance select. Caches keep the JAX package's keys; the per-layer ones are
[L, B, ...] (the JAX pool's leaves are [S, L, 1, ...]). No step reads a
value back to the host.

``scan_layers`` and ``scan_unroll`` choose how the JAX package traces a
stack; eager PyTorch runs the same unrolled blocks either way. Each stack
runs its blocks on an f32 input, as the scanned JAX stack does.

Training mode (``model.train()``) turns on dropout, SpecAugment (with
``spec_augment``) and batch-statistics BatchNorm; a ``t_valid`` width
restricts the conv modules' BatchNorm statistics to the first ``t_valid``
rows, as the JAX package's masked BatchNorm. Random draws come from the
generator handed over with ``layers.set_generator``.

``fused_decoder: true`` replaces the t sequential decoder micro-steps of
``fused_stream_step`` with one helper and decoder pass over the chunk
(``_fused_decoder_phase``): picked frames stay where they are, rings advance
by compacting gathers (``ring_append_dyn``) and attention is banded by
real-row index (``dyn_band_mask``), so the state and the ids are those of the
sequential path, up to rounding. It holds for helper ``win_back`` 0 only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tensorflowasr_tpu_torch.models.conformer import count_params  # noqa: F401
from tensorflowasr_tpu_torch.models.layers import (
    BatchNorm,
    DepthwiseConv1D,
    Dense,
    Dropout,
    FFModule,
    LayerNorm,
    MultiHeadAttention,
    glu,
    init_weights_,
    tensor_cache,
)
from tensorflowasr_tpu_torch.ops import frontend as fe
from tensorflowasr_tpu_torch.parallel.mesh import global_max
from tensorflowasr_tpu_torch.ops.specaug import spec_augment
from tensorflowasr_tpu_torch.utils.device import resolve_device

N_FFT = 1024

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

Caches = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkStackConfig:
    """One stack (encoder / picker / decoder / helper)."""

    dmodel: int = 144
    num_blocks: int = 15
    head_size: int = 36
    num_heads: int = 4
    kernel_size: int = 32
    fc_factor: float = 0.5
    dropout: float = 0.0
    win_front: int = 36
    win_back: int = 0
    scan_layers: bool = False     # read, changes nothing in eager PyTorch
    scan_unroll: int = 1          # read, changes nothing in eager PyTorch

    @property
    def lookahead(self) -> int:
        """The stack's exact streaming delay in frames: each block looks
        ``win_back`` frames ahead, so the stack's cone reaches
        ``num_blocks * win_back``; streaming re-feeds that many frames
        through a ring so that its outputs equal the offline ones."""
        return self.num_blocks * self.win_back


@dataclasses.dataclass(frozen=True)
class ChunkConformerConfig:
    """The ``model_config`` of ``configs/chunk_conformerS.yml``."""

    # front
    dmodel: int = 144
    reduction_factor: int = 4
    front_dropout: float = 0.0
    sample_rate: int = 16000
    n_mels: int = 80
    mel_layer_trainable: bool = False
    stride_ms: int = 10
    chunk_num: int = 16           # mel frames per streaming step
    # SpecAugment on the 'valid' log-mel, training only (ops/specaug.py)
    spec_augment: bool = False
    specaug_freq_masks: int = 2
    specaug_freq_width: int = 27
    specaug_time_masks: int = 2
    specaug_time_ratio: float = 0.05
    # stacks
    encoder: ChunkStackConfig = ChunkStackConfig(num_blocks=15)
    picker: ChunkStackConfig = ChunkStackConfig(num_blocks=1)
    decoder: ChunkStackConfig = ChunkStackConfig(num_blocks=1, win_back=8)
    helper: ChunkStackConfig = ChunkStackConfig(num_blocks=2)
    dtype_str: str = "float32"
    fused_decoder: bool = False   # one decoder pass a chunk (serving)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype_str]

    @property
    def hop(self) -> int:
        return self.sample_rate * self.stride_ms // 1000

    @property
    def chunk_samples(self) -> int:
        """Wav samples per streaming step."""
        return self.chunk_num * self.hop

    @property
    def sub_length(self) -> int:
        """Encoder frames per streaming step."""
        return self.chunk_num // self.reduction_factor

    @classmethod
    def from_user_config(cls, config, dtype_str: str = "float32"
                         ) -> "ChunkConformerConfig":
        mc = config["model_config"] or {}

        def stack(section, **defaults) -> ChunkStackConfig:
            d = dict(section or {})
            keys = ("dmodel", "num_blocks", "head_size", "num_heads",
                    "kernel_size", "fc_factor", "dropout", "win_front",
                    "win_back", "scan_layers", "scan_unroll")
            kw = {k: d[k] for k in keys if k in d}
            return ChunkStackConfig(**{**defaults, **kw})

        front = dict(mc.get("ChunkConformerFront") or {})
        return cls(
            dmodel=front.get("dmodel", 144),
            reduction_factor=front.get("reduction_factor", 4),
            front_dropout=front.get("dropout", 0.0),
            sample_rate=front.get("sample_rate", 16000),
            n_mels=front.get("n_mels", 80),
            mel_layer_trainable=front.get("mel_layer_trainable", False),
            stride_ms=front.get("stride_ms", 10),
            chunk_num=front.get("chunk_num", 16),
            spec_augment=front.get("spec_augment", False),
            specaug_freq_masks=front.get("specaug_freq_masks", 2),
            specaug_freq_width=front.get("specaug_freq_width", 27),
            specaug_time_masks=front.get("specaug_time_masks", 2),
            specaug_time_ratio=front.get("specaug_time_ratio", 0.05),
            fused_decoder=mc.get("fused_decoder", False),
            encoder=stack(mc.get("ChunkConformerEncoder"), num_blocks=15),
            picker=stack(mc.get("ChunkCTCPicker"), num_blocks=1),
            decoder=stack(mc.get("ChunkCTCDecoder"), num_blocks=1,
                          win_back=8),
            helper=stack(mc.get("ContextHelper"), num_blocks=2),
            dtype_str=dtype_str,
        )


# ---------------------------------------------------------------------------
# Masks / validity
# ---------------------------------------------------------------------------

def _band(p: torch.Tensor, length: int, win_front: int, win_back: int
          ) -> torch.Tensor:
    """[len(p), length] band of queries at positions ``p`` with the
    reference's edge adjustments."""
    j = torch.arange(length, device=p.device)[None, :]
    p = p[:, None]
    low = torch.clamp_min(p - win_front, 0)
    high = torch.clamp_max(p + win_back, length)
    low = low - torch.clamp_min(low - (length - win_back), 0)
    high = high + torch.clamp_min(win_back - high, 0)
    return (j >= low) & (j <= high)


@tensor_cache
def chunk_band_mask(t: int, win_front: int, win_back: int,
                    device: Union[str, torch.device, None] = None
                    ) -> torch.Tensor:
    """Offline banded mask [t, t]: query i attends keys [i-wf, i+wb] with
    the reference's edge adjustments."""
    return _band(torch.arange(t, device=device), t, win_front, win_back)


def buffer_validity(cache_len: int, t: int, fill: torch.Tensor,
                    skip: torch.Tensor) -> torch.Tensor:
    """[B, cache_len + t] bool: which slots of [cache | input] hold real
    frames. ``fill`` [B]: real frames in the cache (right-aligned, so the
    zero-init slots form an invalid prefix); ``skip`` [B]: garbage slots at
    the front of the input (the unfilled part of a lookahead ring)."""
    j = torch.arange(cache_len + t, device=fill.device)[None, :]
    fill = torch.clamp_max(fill.to(torch.int32), cache_len)[:, None]
    skip = skip.to(torch.int32)[:, None]
    cache_ok = j >= (cache_len - fill)
    input_bad = (j >= cache_len) & (j < cache_len + skip)
    return cache_ok & ~input_bad


@tensor_cache
def _stream_band(cache_len: int, t: int, win_front: int, win_back: int,
                 device: torch.device) -> torch.Tensor:
    p = cache_len + torch.arange(t, device=device)
    return _band(p, cache_len + t, win_front, win_back)


def stream_band_mask(cache_len: int, t: int, win_front: int, win_back: int,
                     valid: torch.Tensor) -> torch.Tensor:
    """Streaming attention mask [B, 1, t, cache_len + t] = band ∧ validity;
    the queries are the t inputs after the cache, ``valid`` is
    :func:`buffer_validity`'s."""
    band = _stream_band(cache_len, t, win_front, win_back, valid.device)
    return band[None, None] & valid[:, None, None, :]


def left_compact_idx(valid: torch.Tensor) -> torch.Tensor:
    """[B, T] bool -> [B, T] gather indices that move the True rows to the
    front in their order (a stable sort of an integer key: the stable sort
    of a bool tensor is not supported on every device)."""
    return torch.argsort((~valid).to(torch.int32), dim=1, stable=True)


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, d] gathered along T by idx [B, T']."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def ring_append_dyn(ring: torch.Tensor, rows: torch.Tensor,
                    m: torch.Tensor) -> torch.Tensor:
    """Append the first ``m`` [B] of ``rows`` [B, T, d] (left-compacted) to
    the right-aligned ring [B, r, d] and keep its last r entries, in one
    gather: output slot s (p = r - s from the end) is row m - p of ``rows``
    where p <= m, else ring slot s + m. A ring of width 0 is returned
    as it is."""
    r = ring.shape[1]
    if r == 0:
        return ring
    buf = torch.cat([ring, rows.to(ring.dtype)], dim=1)
    s = torch.arange(r, device=ring.device)[None, :]
    p = r - s
    m = m.to(torch.int64)[:, None]
    return _take_rows(buf, torch.where(p <= m, r + m - p, s + m))


def dyn_band_mask(ring_fill: torch.Tensor, r: int, row_valid: torch.Tensor,
                  win_front: int, win_back: int) -> torch.Tensor:
    """Banded attention mask [B, 1, T, r + T] by real-row index for a buffer
    [ring (r) | rows (T)] whose real rows (``row_valid``) may have holes:
    the query with real index q sees the keys with real index in
    [q - win_front, q + win_back]. Where the garbage forms a prefix, as on
    the sequential path, this is the positional band."""
    ring_valid = torch.arange(r, device=row_valid.device)[None, :] >= (
        r - torch.clamp_max(ring_fill.to(torch.int32), r))[:, None]
    valid = torch.cat([ring_valid, row_valid], dim=1)            # [B, r+T]
    ri = torch.cumsum(valid.to(torch.int32), dim=1) - 1
    q_ri = ri[:, r:, None]
    band = (ri[:, None, :] >= q_ri - win_front) & \
        (ri[:, None, :] <= q_ri + win_back)
    return (band & valid[:, None, :] & row_valid[:, :, None])[:, None]


def _batch_axis(key: str) -> int:
    """Where the stream axis sits in a cache leaf: per-layer rings are
    [L, B, ...], everything else [B, ...]."""
    return 1 if key.endswith(("_mha", "_cnn")) else 0


def _rows(mask: torch.Tensor, key: str, like: torch.Tensor) -> torch.Tensor:
    """A [B] bool mask shaped to broadcast over cache leaf ``key``."""
    shape = [1] * like.dim()
    shape[_batch_axis(key)] = -1
    return mask.view(shape)


def select_rows(mask: torch.Tensor, new: Caches, old: Caches) -> Caches:
    """Per stream: ``new`` where ``mask`` [B] holds, else ``old``."""
    return {k: torch.where(_rows(mask, k, v), v, old[k])
            for k, v in new.items()}


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class StreamableMHA(MultiHeadAttention):
    """The port's multi-head attention with the K/V projections exposed,
    so that streaming caches rows after projection, and a boolean mask.

    A masked logit becomes ``finfo(float32).min``, never ``-inf``, as in
    flax's ``dot_product_attention``: a query whose keys are all masked
    attends uniformly instead of giving NaN. The product stays an explicit
    ``softmax(q kᵀ / √hd) v`` with the softmax in f32."""

    def project_kv(self, y: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B, t, d] -> (k, v), each [B, t, H, hd] (H this rank's heads
        under tensor parallelism, as in ``MultiHeadAttention``)."""
        b, t, _ = y.shape
        hd = self.head_size
        return (self.key(y).view(b, t, -1, hd),
                self.value(y).view(b, t, -1, hd))

    def attend(self, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, lq, _ = q_in.shape
        hd = self.head_size
        q = self.query(q_in).view(b, lq, -1, hd).transpose(1, 2)
        k = k.transpose(1, 2)
        v = v.transpose(1, 2)
        logits = torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2))
        logits = logits.to(torch.float32)
        if mask is not None:
            logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
        w = torch.softmax(logits, dim=-1)
        o = torch.matmul(w.to(self.compute_dtype), v.to(self.compute_dtype))
        return self.out(o.transpose(1, 2).reshape(b, lq, -1))

    def forward(self, inputs_q: torch.Tensor, inputs_kv: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.attend(inputs_q, *self.project_kv(inputs_kv), mask)


class ChunkMHSA(nn.Module):
    """Banded self-attention with a post-projection K/V ring [B, win_front,
    2*H*hd] (k rows then v rows, packed as [B, wf, 2, H, hd])."""

    def __init__(self, dmodel: int, head_size: int, num_heads: int,
                 dropout: float = 0.0, win_front: int = 36,
                 win_back: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.win_front, self.win_back = win_front, win_back
        self.num_heads, self.head_size = num_heads, head_size
        self.ln = LayerNorm(dmodel)
        self.mha = StreamableMHA(dmodel, num_heads, head_size, dmodel, dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                t_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        t = x.shape[1]
        mask = chunk_band_mask(t, self.win_front, self.win_back,
                               x.device)[None, None]
        if t_valid is not None:
            # a width-t_valid buffer emulated on a width-t one: keys at or
            # past t_valid do not exist. The band's edge rule is taken at
            # width t, which equals the rule at width t_valid only while
            # win_back <= win_front + 1.
            if self.win_back > self.win_front + 1:
                raise ValueError(
                    f"t_valid needs win_back <= win_front + 1, got "
                    f"win_back {self.win_back}, win_front {self.win_front}")
            keys = torch.arange(t, device=x.device) < t_valid
            mask = mask & keys[None, None, None, :]
        y = self.ln(x)
        y = self.mha(y, y, mask)
        return x + self.dropout(y)

    def stream_call(self, x: torch.Tensor, cache: torch.Tensor,
                    valid: torch.Tensor, keep: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, t, d] module inputs; cache [B, wf, 2*H*hd]; valid [B, wf +
        t] buffer validity; keep [B, n_keep, 1]: which of the first n_keep
        inputs advance into the cache (zeroed where not)."""
        b, t = x.shape[0], x.shape[1]
        h, hd, wf = self.num_heads, self.head_size, self.win_front
        y = self.ln(x)
        k_new, v_new = self.mha.project_kv(y)              # [B, t, H, hd]
        kv = cache.view(b, wf, 2, h, hd)
        k = torch.cat([kv[:, :, 0], k_new.to(kv.dtype)], dim=1)
        v = torch.cat([kv[:, :, 1], v_new.to(kv.dtype)], dim=1)
        mask = stream_band_mask(wf, t, wf, self.win_back, valid)
        out = self.mha.attend(y, k, v, mask)
        n_keep = keep.shape[1]
        app = torch.stack([k_new[:, :n_keep], v_new[:, :n_keep]], dim=2)
        app = torch.where(keep[..., None, None], app.to(kv.dtype), 0.0)
        new_cache = torch.cat([kv, app], dim=1)[:, -wf:]
        return x + out, new_cache.reshape(b, wf, 2 * h * hd)

    def stream_call_dyn(self, x: torch.Tensor, cache: torch.Tensor,
                        fill: torch.Tensor, row_valid: torch.Tensor,
                        adv_mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``stream_call`` for the fused decoder phase: the real inputs sit
        anywhere (``row_valid`` [B, t], holes allowed), attention is banded
        by real-row index, and the ``adv_mask`` [B, t] rows enter the ring
        in order, so it never holds garbage (its real rows are the last
        ``fill``). Outputs at garbage rows are garbage."""
        b, t = x.shape[0], x.shape[1]
        h, hd, wf = self.num_heads, self.head_size, self.win_front
        y = self.ln(x)
        k_new, v_new = self.mha.project_kv(y)              # [B, t, H, hd]
        kv = cache.view(b, wf, 2, h, hd)
        k = torch.cat([kv[:, :, 0], k_new.to(kv.dtype)], dim=1)
        v = torch.cat([kv[:, :, 1], v_new.to(kv.dtype)], dim=1)
        mask = dyn_band_mask(fill, wf, row_valid, wf, self.win_back)
        out = self.mha.attend(y, k, v, mask)
        packed = torch.stack([k_new, v_new], dim=2).reshape(b, t, 2 * h * hd)
        rows = _take_rows(packed, left_compact_idx(adv_mask))
        return x + out, ring_append_dyn(cache, rows, adv_mask.sum(dim=1))


class ChunkConv(nn.Module):
    """Causal conformer conv module with a [B, kernel_size - 1, d] ring of
    post-GLU rows."""

    def __init__(self, dmodel: int, kernel_size: int = 32,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.ln = LayerNorm(dmodel)
        self.pw_conv_1 = Dense(dmodel, 2 * dmodel, dtype)
        self.dw_conv = DepthwiseConv1D(dmodel, kernel_size, dtype,
                                       padding="CAUSAL")
        self.dw_pw = Dense(dmodel, 2 * dmodel, dtype)
        self.bn = BatchNorm(2 * dmodel)
        self.pw_conv_2 = Dense(2 * dmodel, dmodel, dtype)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor,
                t_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.dw_pw(self.dw_conv(glu(self.pw_conv_1(self.ln(x)))))
        mask = None
        if t_valid is not None:
            # a width-t_valid buffer emulated on a width-t one: rows at or
            # past t_valid do not exist, so they stay out of the batch
            # statistics (the causal conv keeps them out of earlier rows)
            mask = (torch.arange(y.shape[1], device=y.device)
                    < t_valid)[None, :, None]
        y = self.bn(y, mask)
        return x + self.dropout(self.pw_conv_2(F.silu(y)))

    def stream_call(self, x: torch.Tensor, cache: torch.Tensor,
                    valid: torch.Tensor, keep: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """cache [B, k-1, d] post-GLU rows (zero where invalid, which is
        the offline causal pad); valid [B, k + t]; keep [B, n_keep, 1]."""
        y = glu(self.pw_conv_1(self.ln(x)))
        y = torch.where(valid[:, self.kernel_size:, None], y, 0.0)
        buf = torch.cat([cache, y.to(cache.dtype)], dim=1)  # [B, k-1+t, d]
        z = self.dw_conv(buf, pad=(0, 0))                   # [B, t, d]
        z = F.silu(self.bn(self.dw_pw(z)))
        z = self.pw_conv_2(z)
        appended = torch.where(keep, y[:, :keep.shape[1]].to(cache.dtype),
                               0.0)
        new_cache = torch.cat([cache, appended],
                              dim=1)[:, -(self.kernel_size - 1):]
        return x + z, new_cache

    def stream_call_dyn(self, x: torch.Tensor, cache: torch.Tensor,
                        row_valid: torch.Tensor, adv_mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``stream_call`` for the fused decoder phase: the causal window
        needs the real rows adjacent, so the post-GLU rows are moved to the
        front against the ring (whose zero slots are the stream-start pad),
        convolved, and put back where they were. The ``adv_mask`` rows enter
        the ring."""
        b, t = x.shape[0], x.shape[1]
        y = glu(self.pw_conv_1(self.ln(x)))
        y = torch.where(row_valid[..., None], y, 0.0)
        lc = left_compact_idx(row_valid)
        inv = torch.empty_like(lc).scatter_(
            1, lc, torch.arange(t, device=x.device).expand(b, t))
        buf = torch.cat([cache, _take_rows(y, lc).to(cache.dtype)], dim=1)
        z = _take_rows(self.dw_conv(buf, pad=(0, 0)), inv)  # [B, t, d]
        z = self.pw_conv_2(F.silu(self.bn(self.dw_pw(z))))
        rows = _take_rows(y, left_compact_idx(adv_mask))
        return x + z, ring_append_dyn(cache, rows, adv_mask.sum(dim=1))


class ChunkBlock(nn.Module):
    """FF/2 -> ChunkMHSA -> ChunkConv -> FF/2 -> LN."""

    def __init__(self, cfg: ChunkStackConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = self.cfg = cfg
        self.ff_module_1 = FFModule(c.dmodel, c.dropout, c.fc_factor, dtype)
        self.mhsa = ChunkMHSA(c.dmodel, c.head_size, c.num_heads, c.dropout,
                              c.win_front, c.win_back, dtype)
        self.conv_module = ChunkConv(c.dmodel, c.kernel_size, c.dropout,
                                     dtype)
        self.ff_module_2 = FFModule(c.dmodel, c.dropout, c.fc_factor, dtype)
        self.ln = LayerNorm(c.dmodel)

    def forward(self, x: torch.Tensor,
                t_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.ff_module_1(x)
        x = self.mhsa(x, t_valid)
        x = self.conv_module(x, t_valid)
        x = self.ff_module_2(x)
        return self.ln(x)

    def stream_call(self, x, mha_cache, cnn_cache, fill, skip, n_keep: int):
        """The first ``n_keep`` inputs advance into the caches, except the
        ``skip`` [B] garbage ones at the front, which are zeroed."""
        c = self.cfg
        t = x.shape[1]
        mha_valid = buffer_validity(c.win_front, t, fill, skip)
        cnn_valid = buffer_validity(c.kernel_size, t, fill, skip)
        keep = (torch.arange(n_keep, device=x.device)[None, :]
                >= skip[:, None])[..., None]
        x = self.ff_module_1(x)
        x, new_mha = self.mhsa.stream_call(x, mha_cache, mha_valid, keep)
        x, new_cnn = self.conv_module.stream_call(x, cnn_cache, cnn_valid,
                                                  keep)
        x = self.ff_module_2(x)
        return self.ln(x), new_mha, new_cnn

    def stream_call_dyn(self, x, mha_cache, cnn_cache, fill, row_valid,
                        adv_mask):
        """The fused decoder phase's block step: real rows where
        ``row_valid``, the ``adv_mask`` subset advancing into the rings."""
        x = self.ff_module_1(x)
        x, new_mha = self.mhsa.stream_call_dyn(x, mha_cache, fill, row_valid,
                                               adv_mask)
        x, new_cnn = self.conv_module.stream_call_dyn(x, cnn_cache,
                                                      row_valid, adv_mask)
        x = self.ff_module_2(x)
        return self.ln(x), new_mha, new_cnn


def _conv_out(n: int, stride: int) -> int:
    return (n - 3) // stride + 1


class ChunkConvSubsampling(nn.Module):
    """'valid' causal subsampling: offline, time is padded (rf, 0) and
    frequency (2, 2), then two 3x3 VALID convs with strides (rf/2, 2) and
    (2, 2), ReLU, freq-major merge and a Dense. Streaming prepends a
    [B, chunk/rf, n_mels, 1] mel tail instead of the time pad (its zero
    init is that pad) and keeps the last chunk/rf outputs."""

    def __init__(self, odim: int, n_mels: int, chunk_num: int = 16,
                 reduction_factor: int = 4, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if reduction_factor % 2:
            raise ValueError(f"reduction_factor must be even, got "
                             f"{reduction_factor}")
        self.reduction_factor = reduction_factor
        self.sub_length = chunk_num // reduction_factor
        self.compute_dtype = dtype
        self.conv1 = nn.Conv2d(1, odim, 3, stride=(reduction_factor // 2, 2))
        self.conv2 = nn.Conv2d(odim, odim, 3, stride=(2, 2))
        f_out = _conv_out(_conv_out(n_mels + 4, 2), 2)
        self.linear = Dense(f_out * odim, odim, dtype)
        self.dropout = Dropout(dropout)

    def _convs(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, F + 4, 1] already padded -> [B, T', odim]."""
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)                    # NHWC -> NCHW
        x = F.relu(F.conv2d(x, self.conv1.weight.to(dt),
                            self.conv1.bias.to(dt),
                            stride=self.conv1.stride))
        x = F.relu(F.conv2d(x, self.conv2.weight.to(dt),
                            self.conv2.bias.to(dt),
                            stride=self.conv2.stride))
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)      # f major
        return self.dropout(self.linear(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._convs(F.pad(x, (0, 0, 2, 2, self.reduction_factor, 0)))

    def stream_call(self, x: torch.Tensor, sub_cache: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, chunk_num, n_mels, 1]; sub_cache [B, chunk/rf, n_mels,
        1]."""
        full = torch.cat([sub_cache, x], dim=1)
        y = self._convs(F.pad(full, (0, 0, 2, 2)))[:, -self.sub_length:]
        return y, full[:, -self.sub_length:]

    def init_cache(self, batch: int, n_mels: int, device) -> torch.Tensor:
        return torch.zeros((batch, self.sub_length, n_mels, 1),
                           dtype=torch.float32, device=device)


class ChunkFront(nn.Module):
    """'valid' log-mel + ChunkConvSubsampling. On a CUDA tensor the mel's
    power spectrum is the K1 kernel. In training mode with
    ``spec_augment`` the log-mel is masked (``ops/specaug.py``) with bands
    drawn from ``generator``. The streaming wav tail starts at zero, which
    is the offline 'valid' left pad."""

    def __init__(self, cfg: ChunkConformerConfig):
        super().__init__()
        self.cfg = cfg
        self.generator: Optional[torch.Generator] = None   # SpecAugment
        self.conv_subsampling = ChunkConvSubsampling(
            cfg.dmodel, cfg.n_mels, cfg.chunk_num, cfg.reduction_factor,
            cfg.front_dropout, cfg.dtype)
        self.fcfg = fe.LogMelFrontendConfig(
            sample_rate=cfg.sample_rate, n_fft=N_FFT,
            stride_ms=cfg.stride_ms, n_mels=cfg.n_mels, padding="valid")
        self.freq2mel = None
        if cfg.mel_layer_trainable:
            self.freq2mel = nn.Parameter(torch.from_numpy(
                fe.mel_filterbank(cfg.sample_rate, N_FFT, cfg.n_mels)))

    def _mel(self, wav: torch.Tensor) -> torch.Tensor:
        wav = fe.wav_to_float(wav)
        if wav.dim() == 3:
            wav = wav[..., 0]
        return fe.log_mel_spectrogram(wav, self.fcfg,
                                      mel_weights=self.freq2mel)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        mel = self._mel(wav)
        if self.training and c.spec_augment:
            if self.generator is None:
                raise RuntimeError("training-mode SpecAugment needs a "
                                   "generator: call set_generator first")
            mel = spec_augment(
                mel, self.generator, n_freq_masks=c.specaug_freq_masks,
                freq_width=c.specaug_freq_width,
                n_time_masks=c.specaug_time_masks,
                time_ratio=c.specaug_time_ratio)
        return self.conv_subsampling(mel[..., None])

    def stream_call(self, wav: torch.Tensor, wav_cache: torch.Tensor,
                    sub_cache: torch.Tensor):
        """wav [B, chunk_samples]; wav_cache [B, chunk_samples]: the mel of
        both (32 frames for the shipped config), of which the last
        ``chunk_num`` frames are this chunk's."""
        c = self.cfg
        wav = fe.wav_to_float(wav)
        if wav.dim() == 3:
            wav = wav[..., 0]
        full = torch.cat([wav_cache, wav.to(torch.float32)], dim=1)
        mel = self._mel(full)[:, -c.chunk_num:]
        out, new_sub = self.conv_subsampling.stream_call(mel[..., None],
                                                         sub_cache)
        return out, full[:, -c.chunk_samples:], new_sub

    def init_caches(self, batch: int, device):
        c = self.cfg
        return (torch.zeros((batch, c.chunk_samples), dtype=torch.float32,
                            device=device),
                self.conv_subsampling.init_cache(batch, c.n_mels, device))


class ChunkStack(nn.Module):
    """N ChunkBlocks threading per-layer caches [L, B, wf, 2*H*hd] and
    [L, B, k-1, d], with the lookahead split of the streaming path."""

    def __init__(self, cfg: ChunkStackConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.blocks = nn.ModuleList([ChunkBlock(cfg, dtype)
                                     for _ in range(cfg.num_blocks)])

    def forward(self, x: torch.Tensor,
                t_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.to(torch.float32)
        for block in self.blocks:
            x = block(x, t_valid)
        return x

    def stream_call(self, x: torch.Tensor, mha_caches: torch.Tensor,
                    cnn_caches: torch.Tensor, fill: torch.Tensor,
                    skip: torch.Tensor):
        """Process t inputs, the first ``skip`` [B] of which are ring zero
        slots. The caches advance past the t - lookahead inputs that gain
        full lookahead this step, minus the skipped ones, which never enter
        a cache. Returns (out [B, t, d], new_mha, new_cnn, new_fill);
        outputs [skip, t - lookahead) are final."""
        c = self.cfg
        t = x.shape[1]
        n_keep = t - c.lookahead
        appended_real = torch.clamp_min(n_keep - skip, 0)
        new_mha, new_cnn = [], []
        out = x.to(torch.float32)
        for i, block in enumerate(self.blocks):
            out, mha_c, cnn_c = block.stream_call(
                out, mha_caches[i], cnn_caches[i], fill, skip, n_keep)
            new_mha.append(mha_c)
            new_cnn.append(cnn_c)
        new_fill = (fill + appended_real).to(fill.dtype)
        return out, torch.stack(new_mha), torch.stack(new_cnn), new_fill

    def stream_call_dyn(self, x: torch.Tensor, mha_caches: torch.Tensor,
                        cnn_caches: torch.Tensor, fill: torch.Tensor,
                        row_valid: torch.Tensor, adv_mask: torch.Tensor):
        """The fused decoder phase's stack step: real rows where
        ``row_valid`` [B, t] (holes allowed); the ``adv_mask`` subset
        advances into every block's rings, and ``fill`` by its count.
        Returns (out [B, t, d], new_mha, new_cnn, new_fill)."""
        new_mha, new_cnn = [], []
        out = x.to(torch.float32)
        for i, block in enumerate(self.blocks):
            out, mha_c, cnn_c = block.stream_call_dyn(
                out, mha_caches[i], cnn_caches[i], fill, row_valid, adv_mask)
            new_mha.append(mha_c)
            new_cnn.append(cnn_c)
        new_fill = (fill + adv_mask.sum(dim=1)).to(fill.dtype)
        return out, torch.stack(new_mha), torch.stack(new_cnn), new_fill

    def init_caches(self, batch: int, device):
        c = self.cfg
        kv = 2 * c.num_heads * c.head_size
        dt = self.compute_dtype
        return (torch.zeros((c.num_blocks, batch, c.win_front, kv),
                            dtype=dt, device=device),
                torch.zeros((c.num_blocks, batch, c.kernel_size - 1,
                             c.dmodel), dtype=dt, device=device))


class ChunkCTCDecoder(nn.Module):
    """Dense -> stack -> Dense(classes) in f32; returns (logits, hidden)."""

    def __init__(self, cfg: ChunkStackConfig, num_classes: int,
                 in_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.project = Dense(in_features, cfg.dmodel, dtype)
        self.stack = ChunkStack(cfg, dtype)
        self.fully_connected = Dense(cfg.dmodel, num_classes, torch.float32)

    def forward(self, x: torch.Tensor,
                t_valid: Optional[torch.Tensor] = None):
        hidden = self.stack(self.project(x), t_valid)
        return self.fully_connected(hidden.to(torch.float32)), hidden

    def stream_call(self, x, mha_caches, cnn_caches, fill, skip):
        out, new_mha, new_cnn, new_fill = self.stack.stream_call(
            self.project(x), mha_caches, cnn_caches, fill, skip)
        return (self.fully_connected(out.to(torch.float32)), out, new_mha,
                new_cnn, new_fill)

    def stream_call_dyn(self, x, mha_caches, cnn_caches, fill, row_valid,
                        adv_mask):
        out, new_mha, new_cnn, new_fill = self.stack.stream_call_dyn(
            self.project(x), mha_caches, cnn_caches, fill, row_valid,
            adv_mask)
        return (self.fully_connected(out.to(torch.float32)), out, new_mha,
                new_cnn, new_fill)

    def init_caches(self, batch: int, device):
        return self.stack.init_caches(batch, device)


class ContextHelper(nn.Module):
    """Phone-embedding helper: refines the picked frames; ``phone_call``
    is the text-only branch of training."""

    def __init__(self, cfg: ChunkStackConfig, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.sample_helper = nn.Embedding(num_classes, cfg.dmodel)
        self.stack = ChunkStack(cfg, dtype)

    def forward(self, x: torch.Tensor,
                t_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.stack(x, t_valid)

    def phone_call(self, phone_ids: torch.Tensor):
        """The text-only branch: (embedded phones, the stack on them)."""
        emb = F.embedding(phone_ids.long(), self.sample_helper.weight)
        emb = emb.to(self.compute_dtype)
        return emb, self.stack(emb)

    def stream_call(self, x, mha_caches, cnn_caches, fill, skip):
        return self.stack.stream_call(x, mha_caches, cnn_caches, fill, skip)

    def stream_call_dyn(self, x, mha_caches, cnn_caches, fill, row_valid,
                        adv_mask):
        return self.stack.stream_call_dyn(x, mha_caches, cnn_caches, fill,
                                          row_valid, adv_mask)

    def init_caches(self, batch: int, device):
        return self.stack.init_caches(batch, device)


# ---------------------------------------------------------------------------
# feature_pick — the SMLTA2 CTC picker / length regulator
# ---------------------------------------------------------------------------

def feature_pick(hidden: torch.Tensor, ctc_logits: torch.Tensor,
                 blank_id: int, max_out: Optional[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keep the frames whose argmax phone is not blank, moved to the front
    of a [B, max_out, ...] buffer in order (a stable sort), zero padded.
    ``max_out=None`` is the full frame count, so nothing is ever cut.
    Returns (picked_hidden, picked_ctc, counts [B] int32)."""
    t = hidden.shape[1]
    if max_out is None:
        max_out = t
    keep = torch.argmax(ctc_logits, dim=-1) != blank_id          # [B, T]
    # sort an integer key: the stable sort of a bool tensor is not
    # supported on every device
    order = torch.argsort((~keep).to(torch.int32), dim=1,
                          stable=True)[:, :max_out]
    kept = torch.gather(keep, 1, order)[..., None]

    def take(x):
        idx = order[..., None].expand(-1, -1, x.shape[-1])
        return torch.where(kept, torch.gather(x, 1, idx), 0.0)

    counts = torch.clamp_max(keep.sum(dim=1), max_out).to(torch.int32)
    return take(hidden), take(ctc_logits), counts


# ---------------------------------------------------------------------------
# Top-level model
# ---------------------------------------------------------------------------

class ChunkConformer(nn.Module):
    """front -> encoder -> phone picker -> feature_pick -> helper -> char
    decoder. Streaming state is an explicit dict of tensors."""

    def __init__(self, cfg: ChunkConformerConfig, num_phone_classes: int,
                 num_char_classes: int):
        super().__init__()
        if cfg.picker.dmodel != cfg.helper.dmodel:
            raise ValueError("the helper reads the picker's hidden rows: "
                             "their dmodel must agree")
        self.cfg = cfg
        self.num_phone_classes = num_phone_classes
        self.num_char_classes = num_char_classes
        dt = cfg.dtype
        self.front = ChunkFront(cfg)
        self.encoder = ChunkStack(cfg.encoder, dt)
        self.phone_picker = ChunkCTCDecoder(cfg.picker, num_phone_classes,
                                            cfg.encoder.dmodel, dt)
        self.decoder = ChunkCTCDecoder(cfg.decoder, num_char_classes,
                                       cfg.helper.dmodel, dt)
        self.helper = ContextHelper(cfg.helper, num_phone_classes, dt)
        # the data-parallel group t_ref is reduced over (parallel/mesh.py)
        self.data_group = None

    @property
    def phone_blank(self) -> int:
        return self.num_phone_classes - 1

    @property
    def device(self) -> torch.device:
        return self.front.conv_subsampling.linear.weight.device

    # -- offline ------------------------------------------------------------
    def forward(self, wav: torch.Tensor):
        """Eval forward without picking: (char logits, hidden)."""
        enc = self.encoder(self.front(wav))
        _, hidden = self.phone_picker(enc)
        return self.decoder(hidden)

    def encode_to_phones(self, wav: torch.Tensor):
        """front -> encoder -> picker: (phone_logits, hidden)."""
        return self.phone_picker(self.encoder(self.front(wav)))

    def train_forward(self, wav: torch.Tensor, extra_phones: torch.Tensor,
                      max_pick: Optional[int],
                      label_width: Union[int, torch.Tensor, None] = None
                      ) -> Dict[str, Optional[torch.Tensor]]:
        """The three-branch forward of a train or eval step, in the
        model's current mode.

        ``max_pick=None`` lets every encoder frame be picked, and the
        helper and the decoder on the picked frames run at the width
        ``t_ref = clip(max(max(picked_counts), label_width), 1, T)`` (a
        device tensor, through ``t_valid``: attention keys and BatchNorm
        statistics stop there), the reference's grown pick buffer.
        ``label_width`` (the batch's longest phone label) is then required
        in training: without it the picked branch would run on the whole
        buffer, padding in its BatchNorm statistics. An int ``max_pick``
        caps the buffer and ``t_ref`` is None.

        Returns phone_logits [B, T, Vp], picked_counts [B], txt_logits
        [B, cap, Vc] (the decoder on helper(picked)), help_logits [B, Le,
        Vc] (the decoder on helper.phone_call(extra_phones)) and t_ref."""
        if self.training and max_pick is None and label_width is None:
            raise ValueError("train_forward with max_pick=None needs "
                             "label_width in training")
        phone_logits, hidden = self.encode_to_phones(wav)
        picked_f, _, counts = feature_pick(hidden, phone_logits,
                                           self.phone_blank, max_pick)
        t_ref = None
        if max_pick is None and label_width is not None:
            # the max over the global batch: under data parallelism the
            # ranks' local maxima of the picks and the labels (the frame
            # count T is the bucket's, the same on every rank)
            t_ref = global_max(torch.clamp(
                counts.max().clamp_min(label_width), 1, picked_f.shape[1]),
                self.data_group)
        # the JAX package's order, so that BatchNorm running statistics
        # move in the same sequence
        _, helper_out = self.helper.phone_call(extra_phones)
        picked_help = self.helper(picked_f, t_ref)
        txt_logits, _ = self.decoder(picked_help, t_ref)
        help_logits, _ = self.decoder(helper_out)
        return {"phone_logits": phone_logits, "picked_counts": counts,
                "txt_logits": txt_logits, "help_logits": help_logits,
                "t_ref": t_ref}

    def predict(self, wav: torch.Tensor, max_pick: Optional[int]):
        """Offline inference: (char logits over the picked frames, phone
        logits, picked counts). ``max_pick=None`` picks without a cap and
        runs helper and decoder at the width of the batch's largest count
        (``t_valid``, a device tensor), as the reference's grown buffer."""
        phone_logits, hidden = self.encode_to_phones(wav)
        picked_f, _, counts = feature_pick(hidden, phone_logits,
                                           self.phone_blank, max_pick)
        t_ref = None
        if max_pick is None:
            t_ref = torch.clamp(counts.max(), 1, picked_f.shape[1])
        help_out = self.helper(picked_f, t_ref)
        char_logits, _ = self.decoder(help_out, t_ref)
        return char_logits, phone_logits, counts

    # -- streaming ----------------------------------------------------------
    def init_picker_caches(self, batch: int) -> Caches:
        c, dev = self.cfg, self.device
        wav_cache, sub_cache = self.front.init_caches(batch, dev)
        enc_mha, enc_cnn = self.encoder.init_caches(batch, dev)
        pk_mha, pk_cnn = self.phone_picker.init_caches(batch, dev)

        def fill():
            return torch.zeros((batch,), dtype=torch.int32, device=dev)

        caches = {
            "wav": wav_cache, "sub": sub_cache,
            "enc_mha": enc_mha, "enc_cnn": enc_cnn, "enc_fill": fill(),
            "picker_mha": pk_mha, "picker_cnn": pk_cnn,
            "picker_fill": fill(),
            "ring": torch.zeros((batch, c.picker.lookahead, c.dmodel),
                                dtype=torch.float32, device=dev),
            "ring_fill": fill(),
        }
        if c.encoder.lookahead > 0:
            caches["enc_ring"] = torch.zeros(
                (batch, c.encoder.lookahead, c.dmodel), dtype=torch.float32,
                device=dev)
            caches["enc_ring_fill"] = fill()
        return caches

    def init_decoder_caches(self, batch: int) -> Caches:
        c, dev = self.cfg, self.device
        h_mha, h_cnn = self.helper.init_caches(batch, dev)
        d_mha, d_cnn = self.decoder.init_caches(batch, dev)

        def fill():
            return torch.zeros((batch,), dtype=torch.int32, device=dev)

        caches = {
            "helper_mha": h_mha, "helper_cnn": h_cnn, "helper_fill": fill(),
            "dec_mha": d_mha, "dec_cnn": d_cnn, "dec_fill": fill(),
            "ring": torch.zeros((batch, c.decoder.lookahead, c.dmodel),
                                dtype=torch.float32, device=dev),
            "ring_fill": fill(),
        }
        if c.helper.lookahead > 0:
            caches["helper_ring"] = torch.zeros(
                (batch, c.helper.lookahead, c.dmodel), dtype=torch.float32,
                device=dev)
            caches["helper_ring_fill"] = fill()
        return caches

    @staticmethod
    def _ring_feed(ring, ring_fill, new, wb: int, in_skip=None):
        """Prepend a right-aligned lookahead ring to ``new`` frames.

        ``in_skip`` [B] marks a garbage prefix of ``new`` (warm-up frames
        of an upstream ring). Real frames always form a contiguous suffix.
        Returns (x [B, wb + t, d], skip [B], new_ring, new_ring_fill,
        n_final [B]): of the first t slots of x, [skip, t) gain full
        lookahead, and the last n_final = t - skip of them are real."""
        b, t = new.shape[0], new.shape[1]
        if in_skip is None:
            in_skip = torch.zeros((b,), dtype=torch.int32, device=new.device)
        in_skip = in_skip.to(torch.int32)
        if wb == 0:
            return (new, in_skip, ring, ring_fill,
                    torch.clamp_min(t - in_skip, 0).to(torch.int32))
        x = torch.cat([ring, new.to(ring.dtype)], dim=1)
        skip = ((wb - torch.clamp_max(ring_fill, wb)) + in_skip).to(
            torch.int32)
        new_ring = x[:, -wb:]
        new_ring_fill = torch.clamp_max(
            ring_fill + torch.clamp_min(t - in_skip, 0), wb).to(torch.int32)
        n_final = torch.clamp_min(t - skip, 0).to(torch.int32)
        return x, skip, new_ring, new_ring_fill, n_final

    def picker_stream_step(self, wav_chunk: torch.Tensor, caches: Caches):
        """One streaming step of front, encoder and picker.

        wav_chunk [B, chunk_samples] -> (phone_logits [B, t, Vp], hidden
        [B, t, d], n_final [B], new caches), t = sub_length; the last
        n_final of the t frames are final outputs (fewer only while a
        lookahead ring warms up)."""
        c = self.cfg
        if wav_chunk.shape[-1] != c.chunk_samples and (
                wav_chunk.dim() != 3
                or wav_chunk.shape[1] != c.chunk_samples):
            raise ValueError(
                f"picker_stream_step expects chunks of exactly "
                f"{c.chunk_samples} samples, got {tuple(wav_chunk.shape)}")
        front_out, new_wav, new_sub = self.front.stream_call(
            wav_chunk, caches["wav"], caches["sub"])
        t_new = front_out.shape[1]
        x_e, skip_e, new_enc_ring, new_enc_ring_fill, n_final_e = \
            self._ring_feed(caches.get("enc_ring"),
                            caches.get("enc_ring_fill"), front_out,
                            c.encoder.lookahead)
        enc_out, new_enc_mha, new_enc_cnn, new_enc_fill = \
            self.encoder.stream_call(x_e, caches["enc_mha"],
                                     caches["enc_cnn"], caches["enc_fill"],
                                     skip_e)
        x, skip, new_ring, new_ring_fill, n_final = self._ring_feed(
            caches["ring"], caches["ring_fill"], enc_out[:, :t_new],
            c.picker.lookahead, in_skip=t_new - n_final_e)
        pk_logits, pk_hidden, new_pk_mha, new_pk_cnn, new_pk_fill = \
            self.phone_picker.stream_call(
                x, caches["picker_mha"], caches["picker_cnn"],
                caches["picker_fill"], skip)
        new_caches = {
            "wav": new_wav, "sub": new_sub,
            "enc_mha": new_enc_mha, "enc_cnn": new_enc_cnn,
            "enc_fill": new_enc_fill,
            "picker_mha": new_pk_mha, "picker_cnn": new_pk_cnn,
            "picker_fill": new_pk_fill,
            "ring": new_ring, "ring_fill": new_ring_fill,
        }
        if c.encoder.lookahead > 0:
            new_caches["enc_ring"] = new_enc_ring
            new_caches["enc_ring_fill"] = new_enc_ring_fill
        return (pk_logits[:, :t_new], pk_hidden[:, :t_new], n_final,
                new_caches)

    def decoder_stream_step(self, picked: torch.Tensor, caches: Caches):
        """One helper + char-decoder step on picked [B, s, d] real frames.

        Returns (char_logits [B, s, Vc], provisional [B, L_d, Vc], n_final
        [B], new caches): the last n_final of the s logits are final; the
        provisional ones are the lookahead-truncated logits of the L_d
        frames still in the decoder ring."""
        c = self.cfg
        s = picked.shape[1]
        x_h, skip_h, new_h_ring, new_h_ring_fill, n_final_h = \
            self._ring_feed(caches.get("helper_ring"),
                            caches.get("helper_ring_fill"), picked,
                            c.helper.lookahead)
        helper_out, new_h_mha, new_h_cnn, new_h_fill = \
            self.helper.stream_call(x_h, caches["helper_mha"],
                                    caches["helper_cnn"],
                                    caches["helper_fill"], skip_h)
        x, skip, new_ring, new_ring_fill, n_final = self._ring_feed(
            caches["ring"], caches["ring_fill"], helper_out[:, :s],
            c.decoder.lookahead, in_skip=s - n_final_h)
        logits, _, new_d_mha, new_d_cnn, new_d_fill = \
            self.decoder.stream_call(x, caches["dec_mha"],
                                     caches["dec_cnn"], caches["dec_fill"],
                                     skip)
        new_caches = {
            "helper_mha": new_h_mha, "helper_cnn": new_h_cnn,
            "helper_fill": new_h_fill,
            "dec_mha": new_d_mha, "dec_cnn": new_d_cnn,
            "dec_fill": new_d_fill,
            "ring": new_ring, "ring_fill": new_ring_fill,
        }
        if c.helper.lookahead > 0:
            new_caches["helper_ring"] = new_h_ring
            new_caches["helper_ring_fill"] = new_h_ring_fill
        return logits[:, :s], logits[:, s:], n_final, new_caches

    def _fused_decoder_phase(self, hidden: torch.Tensor, keep: torch.Tensor,
                             dec: Caches):
        """One helper and decoder pass over a chunk in place of its t
        sequential micro-steps. The kept frames (``keep`` [B, t]) stay where
        they are; the rings advance by compacting gathers, so a stream's
        number of picks never puts garbage between real rows; attention is
        banded by real-row index. The state and the ids equal the
        sequential path's up to rounding (other matmul shapes). A row whose
        ``keep`` is all False leaves its decoder state as it was. No value
        is read back to the host.

        Returns (char_ids [B, t] aligned to the frames, -1 where no final
        char; prov_ids [B, max(L_d, 1)], -1 padded; new decoder caches)."""
        c = self.cfg
        if c.helper.lookahead:
            raise ValueError(
                "fused_decoder supports helper win_back == 0 only (the "
                "shipped config); use the sequential path for helper "
                "lookahead")
        wb = c.decoder.lookahead
        b, t = keep.shape
        dev = keep.device
        n = keep.sum(dim=1).to(torch.int32)

        h_out, new_h_mha, new_h_cnn, new_h_fill = self.helper.stream_call_dyn(
            hidden.to(torch.float32), dec["helper_mha"], dec["helper_cnn"],
            dec["helper_fill"], keep, keep)

        # the decoder runs on [ring | helper rows]: the ring's pending rows
        # re-enter with the new ones, and the first n_adv real rows exit
        # with their full lookahead
        ring = dec["ring"]
        rf = torch.clamp_max(dec["ring_fill"].to(torch.int32), wb)
        x_d = torch.cat([ring, h_out.to(ring.dtype)], dim=1)
        ring_valid = torch.arange(wb, device=dev)[None, :] >= (wb - rf)[:, None]
        row_valid_d = torch.cat([ring_valid, keep], dim=1)
        n_adv = torch.clamp_min(rf + n - wb, 0)
        rank_d = torch.cumsum(row_valid_d.to(torch.int32), dim=1) - 1
        adv_mask = row_valid_d & (rank_d < n_adv[:, None])
        logits, _, new_d_mha, new_d_cnn, new_d_fill = \
            self.decoder.stream_call_dyn(x_d, dec["dec_mha"], dec["dec_cnn"],
                                         dec["dec_fill"], row_valid_d,
                                         adv_mask)

        lc_d = left_compact_idx(row_valid_d)              # reals in order
        final_ids = torch.argmax(_take_rows(logits, lc_d[:, :t]),
                                 dim=-1).to(torch.int32)
        # the k-th emission goes to the frame whose push released it, as on
        # the sequential path: kept rank >= wb - rf emits #(rank - wb + rf)
        k_rank = torch.cumsum(keep.to(torch.int32), dim=1) - 1
        emit_idx = torch.clamp(k_rank - wb + rf[:, None], 0, t - 1)
        emits = keep & (k_rank >= (wb - rf)[:, None])
        char_ids = torch.where(
            emits, torch.gather(final_ids, 1, emit_idx.to(torch.int64)), -1)

        # pending ring: the last min(rf + n, wb) reals of [ring | kept rows]
        kept_rows = _take_rows(h_out.to(ring.dtype), left_compact_idx(keep))
        new_ring = ring_append_dyn(ring, kept_rows, n)
        new_rf = torch.clamp_max(rf + n, wb)

        # provisional: the pending reals' lookahead-truncated ids,
        # right-aligned as on the sequential path, all -1 where nothing was
        # kept this chunk
        if wb > 0:
            slot = torch.arange(wb, device=dev)[None, :]
            pend_pos = torch.gather(
                lc_d, 1, torch.clamp(n_adv[:, None] + slot, 0,
                                     wb + t - 1).to(torch.int64))
            pend_ids = torch.argmax(_take_rows(logits, pend_pos),
                                    dim=-1).to(torch.int32)
            src = torch.clamp(slot - (wb - new_rf)[:, None], 0, wb - 1)
            prov_ids = torch.where(
                (slot >= (wb - new_rf)[:, None]) & (n > 0)[:, None],
                torch.gather(pend_ids, 1, src.to(torch.int64)), -1)
        else:
            prov_ids = torch.full((b, 1), -1, dtype=torch.int32, device=dev)

        new_dec = {
            "helper_mha": new_h_mha, "helper_cnn": new_h_cnn,
            "helper_fill": new_h_fill,
            "dec_mha": new_d_mha, "dec_cnn": new_d_cnn,
            "dec_fill": new_d_fill,
            "ring": new_ring,
            "ring_fill": new_rf.to(dec["ring_fill"].dtype),
        }
        return char_ids, prov_ids, new_dec

    # -- fully fused streaming ----------------------------------------------
    def init_stream_caches(self, batch: int) -> Caches:
        caches = dict(self.init_picker_caches(batch))
        for k, v in self.init_decoder_caches(batch).items():
            caches[f"dec_{k}"] = v
        return caches

    def fused_stream_step(self, wav_chunk: torch.Tensor, caches: Caches):
        """One whole streaming step for B independent streams: picker,
        feature pick, and a char-decoder micro-step for each of the t new
        encoder frames, whose cache update each stream keeps only where
        that frame was picked (compute and discard, so shapes never depend
        on the picks); with ``fused_decoder``, one pass over the t frames
        instead (``_fused_decoder_phase``).

        wav_chunk [B, chunk_samples] -> (phone_ids [B, t], char_ids [B, t]
        (-1 where no final char), prov_ids [B, max(L_d, 1)] (-1 padded),
        n_final [B], new caches)."""
        t = self.cfg.sub_length
        wb = self.cfg.decoder.lookahead
        pk_caches = {k: v for k, v in caches.items()
                     if not k.startswith("dec_")}
        dec = {k[len("dec_"):]: v for k, v in caches.items()
               if k.startswith("dec_")}
        logits, hidden, n_final, new_pk = self.picker_stream_step(
            wav_chunk, pk_caches)
        b, dev = logits.shape[0], logits.device
        phone_ids = torch.argmax(logits, dim=-1).to(torch.int32)   # [B, t]
        f_idx = torch.arange(t, device=dev)[None, :]
        keep = (phone_ids != self.phone_blank) & (
            f_idx >= (t - n_final)[:, None])
        out_caches = dict(new_pk)
        if self.cfg.fused_decoder:
            char_ids, prov, new_dec = self._fused_decoder_phase(hidden, keep,
                                                                dec)
            for k, v in new_dec.items():
                out_caches[f"dec_{k}"] = v
            return phone_ids, char_ids, prov, n_final, out_caches

        prov = torch.full((b, max(wb, 1)), -1, dtype=torch.int32,
                          device=dev)
        slots = torch.arange(wb, device=dev)[None, :]
        char_ids = []
        for f in range(t):
            keep_f = keep[:, f]
            lg, pv, nf, new_dec = self.decoder_stream_step(
                hidden[:, f:f + 1], dec)
            emit = keep_f & (nf > 0)
            char_ids.append(torch.where(
                emit, torch.argmax(lg[:, 0], dim=-1).to(torch.int32), -1))
            if wb > 0:
                p = torch.argmax(pv, dim=-1).to(torch.int32)       # [B, wb]
                slot_valid = slots >= (wb - new_dec["ring_fill"])[:, None]
                prov = torch.where(keep_f[:, None],
                                   torch.where(slot_valid, p, -1), prov)
            dec = select_rows(keep_f, new_dec, dec)
        for k, v in dec.items():
            out_caches[f"dec_{k}"] = v
        return (phone_ids, torch.stack(char_ids, dim=1), prov, n_final,
                out_caches)

    # -- multi-stream serving -----------------------------------------------
    def init_multi_stream_caches(self, n_streams: int) -> Caches:
        """The state of a pool of ``n_streams`` slots: zeros, as a cold
        start. Per-layer leaves are [L, S, ...], the others [S, ...]."""
        return self.init_stream_caches(n_streams)

    def batched_stream_step(self, wav_chunks: torch.Tensor, caches: Caches,
                            reset: Optional[torch.Tensor] = None,
                            advance: Optional[torch.Tensor] = None):
        """Advance a pool of independent streams in one step.

        wav_chunks [S, chunk_samples]; caches from
        ``init_multi_stream_caches(S)``; reset [S] bool: slots zeroed
        before the step (a stream opens); advance [S] bool: slots whose
        state moves (the others keep their post-reset state, and their
        outputs mean nothing). Returns fused_stream_step's outputs over the
        slots."""
        if reset is not None:
            caches = {k: torch.where(_rows(reset, k, v), 0, v)
                      for k, v in caches.items()}
        phone_ids, char_ids, prov_ids, n_final, new = \
            self.fused_stream_step(wav_chunks, caches)
        if advance is not None:
            new = select_rows(advance, new, caches)
        return phone_ids, char_ids, prov_ids, n_final, new


def build_chunk_model(cfg: ChunkConformerConfig, num_phone_classes: int,
                      num_char_classes: int,
                      device: Union[str, torch.device] = "cuda",
                      seed: int = 0) -> ChunkConformer:
    """A ChunkConformer in eval mode on ``device`` with seeded Keras-style
    random weights (load real ones with ``load_state_dict``)."""
    dev = resolve_device(device)
    model = ChunkConformer(cfg, num_phone_classes, num_char_classes)
    init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
