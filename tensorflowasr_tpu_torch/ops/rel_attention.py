"""Relative-position self-attention in one kernel: the E-Branchformer's global
branch (``models/layers.py::RelPositionMultiHeadAttention``) after its
projections.

For each row b, head h, query i and key j::

    s[i, j] = ((q_i + u) . k_j + bd[i, j - i + T - 1]) / sqrt(hd)
    o_i     = sum_j softmax_j(s[i, j], keys masked) v_j

``q``, ``k``, ``v`` are the projections' [B, T, d] outputs (d = h x hd),
``u`` the learned bias ``pos_bias_u`` [h, hd], and ``bd`` the position
scores ``(q + pos_bias_v) (W_pos P)^T`` [B, h, T, 2T - 1] against the
relative positions T - 1, ..., -(T - 1): entry ``j - i + T - 1`` of row i is
the score against position i - j, the Transformer-XL shift of
:func:`rel_shift`.

**The kernel** (Triton, :func:`rel_attention_cuda`) replaces no TPU kernel:
the JAX package has no E-Branchformer. It was added because the plain
composition (:func:`rel_attention_reference`: two batched products, the
shift's pad-and-reshape copy, f32 casts, add, scale, mask, softmax, the
weights' cast, the product with v and the heads' transpose) made about ten
passes over a [B, h, T, T] tensor and ~20 launches a block, ~1.4 ms a block
at B = 32, T = 300 on an H100. What bounds the same work there: the two
products are 5.9 GFLOP (~6 us at 989 TFLOP/s bf16), while q, k, v and o
(39 MB) and the position scores read once (92 MB) take ~39 us at
3.35 TB/s. So it is memory-bound, and the design keeps every [T, T] score,
weight and cast out of device memory: one program a (b, h, block of
queries) loads its queries once, adds ``u``, and walks the keys in blocks
with an online softmax in f32 (the running max and sum a query, the output
rescaled as the max grows). A block's ``(q + u) k^T`` is one ``tl.dot`` on
the tensor cores with an f32 sum; its position scores are read straight
from ``bd`` at the skewed index, each query a contiguous run, so the shift
is an address and not a copy; the weights go to bf16 for the product with
v, as the plain version's ``w.to(dtype)`` does, summed in f32. q, k, v and
o are read and written in their [B, T, d] layout by strides, so neither
the heads' transposes nor their copies are made. Masked keys (and the
tile's keys past T) are never loaded and weigh exactly 0, so what padded
frames hold cannot reach a valid one. The bytes left are ``bd`` (written by
cuBLAS, read here once, half of it: the run each query needs) and q, k,
v, o; computing the position term inside the kernel would remove ``bd``.

The tiles are fixed (:data:`TILES`), never autotuned, so one
compilation serves every length: the lengths and the strides that follow
from them are not specialised. ``rel_attention`` takes the plain version
for CPU tensors; for CUDA tensors it launches the kernel or raises on what
it does not take (a dtype other than bf16, a head size other than 64),
never falling back. The kernel has no backward and no dropout: the module
calls the plain composition itself to train.
``rel_attention_cuda.launches`` counts its launches.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Callable, Optional

import torch
import torch.nn.functional as F

HEAD_SIZES = (64,)                  # the E-Branchformer's


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """[..., T, 2T - 1] scores against the positions T - 1, ..., -(T - 1)
    -> [..., T, T] whose entry (i, j) is the score against position i - j:
    the Transformer-XL shift, one zero column and a reshape."""
    *lead, t, p = x.shape
    x = F.pad(x, (1, 0)).view(*lead, p + 1, t)
    return x[..., 1:, :].reshape(*lead, t, p)[..., :p // 2 + 1]


def rel_attention_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bd: torch.Tensor,
                            pos_bias_u: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            dropout: Optional[Callable] = None
                            ) -> torch.Tensor:
    """The plain composition: q, k, v [B, T, d], bd [B, h, T, 2T - 1] in
    one dtype, ``pos_bias_u`` [h, hd], ``mask`` [B, 1, 1, T] bool (True on
    the keys that count) or None -> [B, T, d] in q's dtype. ``(q + u) k^T``
    in that dtype, the shifted ``bd`` added and scaled in f32, masked keys
    at ``finfo(float32).min``, softmax in f32, ``dropout`` (a module, in
    training) on the weights, then the weights in q's dtype times v."""
    b, t, _ = q.shape
    h, hd = pos_bias_u.shape
    dt = q.dtype
    q = q.view(b, t, h, hd)
    k = k.view(b, t, h, hd).transpose(1, 2)
    v = v.view(b, t, h, hd).transpose(1, 2)
    ac = torch.matmul((q + pos_bias_u.to(dt)).transpose(1, 2),
                      k.transpose(-1, -2))
    scores = (ac.to(torch.float32) + rel_shift(bd).to(torch.float32)) \
        / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    w = torch.softmax(scores, dim=-1)
    if dropout is not None:
        w = dropout(w)
    o = torch.matmul(w.to(dt), v)                      # [b, h, t, hd]
    return o.transpose(1, 2).reshape(b, t, -1)


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bd: torch.Tensor, pos_bias_u: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`rel_attention_reference` without dropout: the plain version
    for CPU tensors, the kernel for CUDA tensors (raising on what it does
    not take)."""
    if q.device.type == "cpu":
        return rel_attention_reference(q, k, v, bd, pos_bias_u, mask)
    return rel_attention_cuda(q, k, v, bd, pos_bias_u, mask)


# (queries a program, keys a step of its loop, warps, pipeline stages):
# 128 queries by 32 keys, four warps, two stages (a [128, 32] f32 score
# block and a [128, hd] f32 output in registers): of the tiles timed at
# B = 32, h = 8, hd = 64 on an H100, the least time summed over the decode
# buckets' shares (``kernels/sweep_rel_attention.py``, ``PERF.md``)
TILES = (128, 32, 4, 2)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The Triton kernel, built at first use (no ``triton`` where the port
    runs on the CPU only)."""
    import triton
    import triton.language as tl

    @triton.jit(do_not_specialize=["t", "s_qb", "s_kb", "s_vb", "s_ob",
                                   "s_bb", "s_bh", "s_bi", "s_mb"])
    def rel_attention_fwd(q_ptr, k_ptr, v_ptr, bd_ptr, u_ptr, mask_ptr,
                          o_ptr, t, h, scale_log2,
                          s_qb, s_qt, s_kb, s_kt, s_vb, s_vt, s_ob, s_ot,
                          s_bb, s_bh, s_bi, s_mb,
                          HD: tl.constexpr, BLOCK_M: tl.constexpr,
                          BLOCK_N: tl.constexpr, HAS_MASK: tl.constexpr):
        pid_bh = tl.program_id(1)
        b = (pid_bh // h).to(tl.int64)
        hh = pid_bh % h
        rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        dims = tl.arange(0, HD)
        row_ok = rows < t
        q = tl.load(q_ptr + b * s_qb + rows[:, None] * s_qt + hh * HD
                    + dims[None, :], mask=row_ok[:, None], other=0.0)
        u = tl.load(u_ptr + hh * HD + dims).to(q.dtype)
        qu = (q.to(tl.float32) + u.to(tl.float32)[None, :]).to(q.dtype)
        k_at = k_ptr + b * s_kb + hh * HD + dims[None, :]
        v_at = v_ptr + b * s_vb + hh * HD + dims[None, :]
        # query i reads bd[b, h, i, (T - 1 - i) + j]: a contiguous run
        bd_at = bd_ptr + b * s_bb + hh.to(tl.int64) * s_bh \
            + rows[:, None] * (s_bi - 1) + (t - 1)
        m_i = tl.full([BLOCK_M], float("-inf"), tl.float32)
        l_i = tl.zeros([BLOCK_M], tl.float32)
        acc = tl.zeros([BLOCK_M, HD], tl.float32)
        for start in range(0, t, BLOCK_N):
            keys = start + tl.arange(0, BLOCK_N)
            key_ok = keys < t
            if HAS_MASK:
                key_ok = key_ok & (tl.load(mask_ptr + b * s_mb + keys,
                                           mask=key_ok, other=0) != 0)
            k = tl.load(k_at + keys[:, None] * s_kt, mask=key_ok[:, None],
                        other=0.0)
            pos = tl.load(bd_at + keys[None, :],
                          mask=row_ok[:, None] & key_ok[None, :], other=0.0)
            # the scores in log2 units: exp2 of them is exp of the scores
            s = (tl.dot(qu, tl.trans(k)) + pos.to(tl.float32)) * scale_log2
            s = tl.where(key_ok[None, :], s, float("-inf"))
            m_new = tl.maximum(m_i, tl.max(s, 1))
            # a query with no key yet: nothing to rescale, every weight 0
            m_use = tl.where(m_new == float("-inf"), 0.0, m_new)
            alpha = tl.exp2(m_i - m_use)
            p = tl.exp2(s - m_use[:, None])
            l_i = l_i * alpha + tl.sum(p, 1)
            v = tl.load(v_at + keys[:, None] * s_vt, mask=key_ok[:, None],
                        other=0.0)
            acc = tl.dot(p.to(v.dtype), v, acc * alpha[:, None])
            m_i = m_new
        o = acc / l_i[:, None]
        tl.store(o_ptr + b * s_ob + rows[:, None] * s_ot + hh * HD
                 + dims[None, :], o.to(o_ptr.dtype.element_ty),
                 mask=row_ok[:, None])

    return rel_attention_fwd


def _check(q, k, v, bd, pos_bias_u, mask) -> None:
    b, t, d = q.shape
    h, hd = pos_bias_u.shape
    if q.dtype != torch.bfloat16 or hd not in HEAD_SIZES or h * hd != d:
        raise ValueError(f"rel_attention_cuda takes bf16 with head "
                         f"sizes {HEAD_SIZES}, got {q.dtype} and "
                         f"pos_bias_u {tuple(pos_bias_u.shape)} for d {d}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"{name} {x.dtype} {tuple(x.shape)} is not "
                             f"q's {q.dtype} {tuple(q.shape)}")
    if bd.shape != (b, h, t, 2 * t - 1) or bd.dtype != q.dtype:
        raise ValueError(f"bd must be {q.dtype} {(b, h, t, 2 * t - 1)}, "
                         f"got {bd.dtype} {tuple(bd.shape)}")
    tensors = [q, k, v, bd, pos_bias_u] + ([] if mask is None else [mask])
    if any(x.device != q.device or x.stride(-1) != 1 for x in tensors):
        raise ValueError("rel_attention_cuda takes tensors on q's CUDA "
                         "device, each with a unit last stride")
    if not pos_bias_u.is_contiguous() or pos_bias_u.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError("pos_bias_u must be a contiguous float tensor")
    if mask is not None and (mask.shape != (b, t)
                             or mask.dtype != torch.bool):
        raise ValueError(f"mask must be bool {(b, t)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")


def rel_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bd: torch.Tensor, pos_bias_u: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the kernel on q's current stream: q, k, v [B, T, d]
    bf16, bd [B, h, T, 2T - 1] in their dtype (any strides with a
    unit last one), ``pos_bias_u`` [h, hd], ``mask`` [B, 1, 1, T] or
    [B, T] bool, each row keeping at least one key, or None -> o [B, T, d]."""
    b, t, d = q.shape
    h, hd = pos_bias_u.shape
    if mask is not None:
        mask = mask.reshape(b, t)
    _check(q, k, v, bd, pos_bias_u, mask)
    block_m, block_n, num_warps, num_stages = TILES
    out = torch.empty((b, t, d), dtype=q.dtype, device=q.device)
    grid = (-(-t // block_m), b * h)
    with torch.cuda.device(q.device):
        _kernel()[grid](
            q, k, v, bd, pos_bias_u,
            q if mask is None else mask.view(torch.uint8), out, t, h,
            math.log2(math.e) / math.sqrt(hd),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            bd.stride(0), bd.stride(1), bd.stride(2),
            0 if mask is None else mask.stride(0),
            HD=hd, BLOCK_M=block_m, BLOCK_N=block_n,
            HAS_MASK=mask is not None, num_warps=num_warps,
            num_stages=num_stages)
    with _LAUNCH_COUNT_LOCK:
        rel_attention_cuda.launches += 1
    return out


# launches of the kernel; a served model may run it from several threads
rel_attention_cuda.launches = 0
_LAUNCH_COUNT_LOCK = threading.Lock()
