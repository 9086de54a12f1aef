"""RNN-T (transducer) loss: the alpha recursion over the lattice's
anti-diagonals, in log space.

Counterpart of ``tensorflowasr_tpu/ops/rnnt.py``. The alpha recursion over
the (T, U+1) lattice runs one anti-diagonal at a time (T + U steps of
vectorised work, the wavefront the JAX ``lax.scan`` and warp-transducer's
kernels use), as a Python loop of tensor ops; gradients come from autograd
through the loop (its reverse is the beta recursion). Masked for padded
time and label lengths; no library kernel.

``rnnt_loss(logits [B, T, U+1, V], labels [B, U], logit_lengths [B],
label_lengths [B], blank)`` -> [B] negative log likelihood.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b), NEG_INF where both are (about) NEG_INF."""
    m = torch.maximum(a, b)
    out = m + torch.log(torch.exp(a - m) + torch.exp(b - m))
    return torch.where(m <= NEG_INF / 2, torch.full_like(out, NEG_INF), out)


def rnnt_loss(logits: torch.Tensor, labels: torch.Tensor,
              logit_lengths: torch.Tensor, label_lengths: torch.Tensor,
              blank: int = 0) -> torch.Tensor:
    """Per-example negative log likelihood of the transducer lattice.

    logits [B, T, U+1, V] (unnormalised joint outputs), labels [B, U]
    (padded past ``label_lengths``), logit_lengths [B] valid frames,
    label_lengths [B] valid labels. Returns [B]."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    b, t, u1, _ = logp.shape
    u = u1 - 1
    dev = logp.device
    logit_lengths = logit_lengths.to(device=dev, dtype=torch.long)
    label_lengths = label_lengths.to(device=dev, dtype=torch.long)

    lp_blank = logp[..., blank]                              # [B, T, U+1]
    lab = labels.to(device=dev, dtype=torch.long)
    lp_emit = torch.gather(
        logp[:, :, :u, :], 3,
        lab[:, None, :, None].expand(b, t, u, 1))[..., 0]    # [B, T, U]
    lp_emit = F.pad(lp_emit, (0, 1), value=NEG_INF)          # [B, T, U+1]

    # diagonal k holds alpha[t, u] with t + u = k, indexed by u in [0, U]
    u_idx = torch.arange(u1, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    neg = torch.full((b, u1), NEG_INF, device=dev)
    alpha = neg.clone()
    alpha[:, 0] = 0.0
    best = torch.full((b,), NEG_INF, device=dev)
    term_k = logit_lengths + label_lengths - 1
    lp_b_last = lp_blank[torch.arange(b, device=dev),
                         torch.clamp(logit_lengths - 1, 0, t - 1),
                         label_lengths]
    for k in range(1, t + u1):
        t_idx = k - u_idx                                    # [U+1]
        valid = ((t_idx >= 0) & (t_idx < t))[None, :] \
            & (u_idx[None, :] <= label_lengths[:, None]) \
            & (t_idx[None, :] < logit_lengths[:, None])
        # from (t-1, u) by a blank: the same u on diagonal k-1
        tm1 = torch.clamp(t_idx - 1, 0, t - 1)
        lp_b = lp_blank[rows, tm1[None, :], u_idx[None, :]]
        from_blank = torch.where((t_idx >= 1)[None, :], alpha + lp_b, neg)
        # from (t, u-1) by emitting label u-1: diagonal k-1 shifted
        tcl = torch.clamp(t_idx, 0, t - 1)
        um1 = torch.clamp(u_idx - 1, 0, u1 - 1)
        lp_e = lp_emit[rows, tcl[None, :], um1[None, :]]
        shifted = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        from_emit = torch.where((u_idx >= 1)[None, :], shifted + lp_e, neg)
        alpha = torch.where(valid, _logaddexp(from_blank, from_emit), neg)
        # each example's terminal cell (T_b - 1, U_b) and its last blank
        term = torch.gather(alpha, 1, label_lengths[:, None])[:, 0]
        best = torch.where(term_k == k, term + lp_b_last, best)
    # an example with one frame and no label ends on diagonal 0
    return -torch.where(term_k == 0, lp_blank[:, 0, 0], best)
