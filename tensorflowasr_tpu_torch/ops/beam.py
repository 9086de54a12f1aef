"""CTC prefix beam search with static shapes, batched on the device.

Counterpart of ``tensorflowasr_tpu/ops/beam.py`` (the classic prefix beam
search of Hannun et al. 2014, the role of the reference's C++
``ctc_decoders``), with the same state, candidates, merge and results:

- beams are [B, W, L] prefix buffers + lengths, with log probabilities
  split into blank-ending ``p_b`` and non-blank-ending ``p_nb``;
- per frame, the vocabulary is pruned to the top-K tokens (``prune_k``),
  giving W stay-candidates + W*K extension-candidates;
- duplicate prefixes are merged by a 64-bit rolling hash (two 32-bit lanes,
  held in int64 and masked after every multiply-add): sort by hash ->
  segment logsumexp -> keep the first occurrence -> top-W;
- optional shallow fusion: a dense token-bigram ``lm_logp[prev, c]`` or an
  order-2..4 backoff n-gram (``utils/ngram_lm.py::DeviceNGramLM``), added
  with weight ``lm_weight`` on every extension.

JAX's ``vmap`` over the batch is a leading batch axis on every state tensor,
and its ``lax.scan`` a Python loop over the frames that keeps a row's new
state only where ``t < lengths``. The loop holds no host sync: no
``.item()``, no boolean indexing, no data-dependent shape; the segment
reductions run over a fixed ``n_cand`` segments a row. Orders are JAX's:
ties in the vocabulary's top-K and the beams' top-W go to the lower index
(stable descending sorts, as ``lax.top_k``), and the final order is a stable
argsort.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from tensorflowasr_tpu_torch.utils.ngram_lm import score_candidates

NEG_INF = -1.0e30
_P1 = 2654435761
_P2 = 40503
_M32 = 0xFFFFFFFF


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
    return torch.where(m <= NEG_INF / 2, NEG_INF, out)


def _segment_logsumexp(vals: torch.Tensor, seg: torch.Tensor, num: int
                       ) -> torch.Tensor:
    """Per-segment logsumexp of ``vals`` [B, N] grouped by ``seg`` [B, N]
    ids in [0, num) of each row; returns [B, num]."""
    b = vals.shape[0]
    row = num * torch.arange(b, device=seg.device)[:, None]
    flat = (seg + row).reshape(-1)
    m = torch.full((b * num,), NEG_INF, dtype=vals.dtype, device=vals.device)
    m = m.scatter_reduce(0, flat, vals.reshape(-1), "amax")
    m = torch.where(m <= NEG_INF / 2, NEG_INF, m)
    shifted = torch.exp(vals.reshape(-1) - m[flat])
    s = torch.zeros_like(m).index_add_(0, flat, shifted)
    out = m + torch.log(s.clamp_min(1e-37))
    return torch.where(m <= NEG_INF / 2, NEG_INF, out).reshape(b, num)


class BeamState(NamedTuple):
    prefixes: torch.Tensor    # [B, W, L] int64 (pad 0 beyond len)
    lengths: torch.Tensor     # [B, W] int64
    last: torch.Tensor        # [B, W] int64 last token (-1 for empty)
    ctx: torch.Tensor         # [B, W, C] int64 last C tokens (BOS-padded),
    #                           the (order-1)-gram context for n-gram fusion
    h1: torch.Tensor          # [B, W] int64 rolling hash lane 1 (uint32)
    h2: torch.Tensor          # [B, W] int64 rolling hash lane 2 (uint32)
    p_b: torch.Tensor         # [B, W] log p(prefix, ends in blank)
    p_nb: torch.Tensor        # [B, W] log p(prefix, ends in non-blank)


def _init_state(batch: int, beam_width: int, max_len: int, device,
                ctx_len: int = 1, bos: int = 0) -> BeamState:
    b, w, l = batch, beam_width, max_len

    def full(shape, value, dtype=torch.int64):
        return torch.full(shape, value, dtype=dtype, device=device)

    first = torch.arange(w, device=device) == 0
    return BeamState(
        prefixes=full((b, w, l), 0),
        lengths=full((b, w), 0),
        last=full((b, w), -1),
        ctx=full((b, w, ctx_len), bos),
        h1=full((b, w), 17),
        h2=full((b, w), 29),
        p_b=torch.where(first, 0.0, NEG_INF).expand(b, w).contiguous(),
        p_nb=full((b, w), NEG_INF, torch.float32),
    )


def _sort_desc(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending along the last axis, ties to the lower index (the order
    of ``jax.lax.top_k``)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)


def _step(state: BeamState, logp_t: torch.Tensor, blank_id: int,
          prune_k: int, max_len: int, lm_logp: Optional[torch.Tensor],
          lm_weight: float, ngram_lm=None) -> BeamState:
    """One frame: ``logp_t`` [B, V] log probabilities."""
    b, w, l = state.prefixes.shape
    dev = logp_t.device
    ptot = _logaddexp(state.p_b, state.p_nb)                     # [B, W]

    top_lp, top_ids = _sort_desc(logp_t)
    top_lp, top_ids = top_lp[:, :prune_k], top_ids[:, :prune_k]  # [B, K]
    lp_blank = logp_t[:, blank_id:blank_id + 1]                  # [B, 1]
    lp_last = torch.where(
        state.last >= 0,
        torch.gather(logp_t, 1, state.last.clamp_min(0)), NEG_INF)

    # ---- stay candidates (one per beam, same prefix) ----------------------
    stay_pb = ptot + lp_blank
    stay_pnb = state.p_nb + lp_last

    # ---- extension candidates [B, W, K] -----------------------------------
    ids = top_ids[:, None, :].expand(b, w, prune_k)
    same_as_last = ids == state.last[..., None]
    base = torch.where(same_as_last, state.p_b[..., None], ptot[..., None])
    ext_pnb = base + top_lp[:, None, :]
    if ngram_lm is not None:
        ext_pnb = ext_pnb + score_candidates(ngram_lm, state.ctx,
                                             ids) * lm_weight
    elif lm_logp is not None:
        prev = state.last.clamp_min(0)                           # 0 for empty
        ext_pnb = ext_pnb + lm_logp[prev[..., None], ids] * lm_weight
    # the blank "extension" is the stay candidate's job; dead beams cannot
    # extend; saturated prefixes cannot grow
    dead = (ids == blank_id) | (ptot[..., None] <= NEG_INF / 2) \
        | (state.lengths >= max_len)[..., None]
    ext_pnb = torch.where(dead, NEG_INF, ext_pnb)

    # candidate tensors: [B, W + W*K]
    n_cand = w + w * prune_k
    cand_pb = torch.cat([stay_pb, torch.full((b, w * prune_k), NEG_INF,
                                             device=dev)], 1)
    cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(b, -1)], 1)
    # prefix identity: hash of the (possibly extended) prefix
    ext_h1 = (state.h1[..., None] * _P1 + ids + 1) & _M32
    ext_h2 = (state.h2[..., None] * _P2 + ids + 1) & _M32
    cand_h1 = torch.cat([state.h1, ext_h1.reshape(b, -1)], 1)
    cand_h2 = torch.cat([state.h2, ext_h2.reshape(b, -1)], 1)
    # source beam + extension token, to rebuild the beams after the top-W
    arange = torch.arange(w * prune_k, device=dev)
    src = torch.cat([arange[:w], arange // prune_k])              # [N]
    ext_tok = torch.cat([torch.full((b, w), -1, dtype=torch.int64,
                                    device=dev), ids.reshape(b, -1)], 1)

    # ---- merge duplicates by hash ------------------------------------------
    # one stable sort on (h1 - 2^31) * 2^32 + h2, which orders as
    # jnp.lexsort((h2, h1)) does and fits in int64
    key = (cand_h1 - 2 ** 31) * 2 ** 32 + cand_h2
    key_s, order = torch.sort(key, dim=1, stable=True)
    pb_s = torch.gather(cand_pb, 1, order)
    pnb_s = torch.gather(cand_pnb, 1, order)
    newseg = torch.cat([torch.ones((b, 1), dtype=torch.int64, device=dev),
                        (key_s[:, 1:] != key_s[:, :-1]).to(torch.int64)], 1)
    seg = torch.cumsum(newseg, 1) - 1                             # [B, N]
    pb_m = _segment_logsumexp(pb_s, seg, n_cand)
    pnb_m = _segment_logsumexp(pnb_s, seg, n_cand)
    first = newseg == 1
    pb_u = torch.where(first, torch.gather(pb_m, 1, seg), NEG_INF)
    pnb_u = torch.where(first, torch.gather(pnb_m, 1, seg), NEG_INF)
    ptot_u = _logaddexp(pb_u, pnb_u)

    # ---- top-W beams -------------------------------------------------------
    top_pos = _sort_desc(ptot_u)[1][:, :w]
    sel = torch.gather(order, 1, top_pos)                         # candidate
    sel_src = src[sel]
    sel_tok = torch.gather(ext_tok, 1, sel)
    sel_pb = torch.gather(pb_u, 1, top_pos)
    sel_pnb = torch.gather(pnb_u, 1, top_pos)

    # ---- rebuild beam arrays ----------------------------------------------
    base_pref = torch.gather(state.prefixes, 1,
                             sel_src[..., None].expand(b, w, l))
    base_len = torch.gather(state.lengths, 1, sel_src)
    extend = sel_tok >= 0
    pos = base_len.clamp_max(l - 1)
    onehot = (torch.arange(l, device=dev) == pos[..., None]) \
        & extend[..., None]
    new_pref = torch.where(onehot, sel_tok[..., None], base_pref)
    new_len = base_len + extend.to(torch.int64)
    new_last = torch.where(extend, sel_tok,
                           torch.gather(state.last, 1, sel_src))
    c = state.ctx.shape[-1]
    base_ctx = torch.gather(state.ctx, 1, sel_src[..., None].expand(b, w, c))
    shifted = torch.cat([base_ctx[..., 1:], sel_tok[..., None]], -1)
    new_ctx = torch.where(extend[..., None], shifted, base_ctx)
    # a selected candidate's hash is its prefix's: the source beam's for a
    # stay, the extended one for an extension
    new_h1 = torch.gather(cand_h1, 1, sel)
    new_h2 = torch.gather(cand_h2, 1, sel)
    return BeamState(new_pref, new_len, new_last, new_ctx, new_h1, new_h2,
                     sel_pb, sel_pnb)


def ctc_beam_search_decode(
        logits: torch.Tensor,
        lengths: torch.Tensor,
        blank_id: int,
        beam_width: int = 8,
        prune_k: int = 8,
        max_len: int = 0,
        lm_logp: Optional[torch.Tensor] = None,
        lm_weight: float = 0.3,
        ngram_lm=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched CTC prefix beam search.

    Args:
      logits: [B, T, V] raw logits (log-softmaxed internally, in f32).
      lengths: [B] valid frames (a tensor on the logits' device).
      blank_id: CTC blank index.
      beam_width: number of beams kept.
      prune_k: per-frame vocabulary pruning.
      max_len: prefix capacity; 0 -> T.
      lm_logp: optional [V, V] token-bigram log probs for shallow fusion.
      lm_weight: LM interpolation weight.
      ngram_lm: optional ``utils.ngram_lm.DeviceNGramLM`` (``lm_pack``) on
        the logits' device, an order-2..4 backoff LM; takes precedence over
        ``lm_logp``.

    Returns:
      (prefixes [B, W, max_len] int32, lengths [B, W] int32,
       scores [B, W] total log prob), beams sorted best-first.
    """
    b, t, _ = logits.shape
    if max_len <= 0:
        max_len = t
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    ctx_len = max(ngram_lm.order - 1, 1) if ngram_lm is not None else 1
    bos = ngram_lm.bos if ngram_lm is not None else 0
    state = _init_state(b, beam_width, max_len, logits.device, ctx_len, bos)
    live = torch.arange(t, device=logits.device)[None, :] \
        < lengths.to(logits.device)[:, None]                      # [B, T]
    for i in range(t):
        new = _step(state, logp[:, i], blank_id, prune_k, max_len,
                    lm_logp, lm_weight, ngram_lm)
        keep = live[:, i]
        state = BeamState(*(
            torch.where(keep.view((b,) + (1,) * (n.ndim - 1)), n, o)
            for n, o in zip(new, state)))
    score = _logaddexp(state.p_b, state.p_nb)
    order = torch.argsort(-score, dim=1, stable=True)
    prefixes = torch.gather(state.prefixes, 1,
                            order[..., None].expand(-1, -1, max_len))
    return (prefixes.to(torch.int32),
            torch.gather(state.lengths, 1, order).to(torch.int32),
            torch.gather(score, 1, order))
