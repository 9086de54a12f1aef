"""Time the relative-position attention kernel (``ops/rel_attention.py``) on
one CUDA card at the E-Branchformer (L) decode shapes:

    python3 -m tensorflowasr_tpu_torch.kernels.sweep_rel_attention

B = 32 rows, 8 heads of 64, T' = 200 / 300 / 400 / 500 (the 8 / 12 / 16 /
20 s buckets), each row's keys masked past a length drawn from its bucket.
For each shape it checks the kernel against the plain composition in f32
(the largest error beside the bf16 plain composition's), then prints CUDA
event times (median and minimum of 20 samples of 10 calls, ms) of: the
kernel with its fixed tiles and with other tiles (``TILES`` swapped for
the timing); the plain composition it replaces, given the same position
scores; the ways to make the position scores: the [h, B T', hd] x
[h, hd, 2T'-1] product, also with its rows padded to a multiple of 8 as
the module makes it, and the broadcast
[B, h, T', hd] x [h, hd, 2T'-1] one that the plain path keeps. The bound
is the larger of the two products' FLOPs at 989 TFLOP/s and the bytes at
3.35 TB/s: q, k, v and o once, and of the position scores the [T', T']
band the queries need (``bd`` whole beside it).
Prints the card's name and power limit first.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

B, H, HD = 32, 8, 64
LENGTHS = (200, 300, 400, 500)
REPS, INNER = 20, 10
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
OTHER_TILES = ((64, 64, 4, 2), (128, 64, 8, 2), (128, 32, 4, 3),
               (128, 16, 4, 2), (256, 32, 8, 2))


def inputs(t: int, seed: int, device="cuda"):
    """q, k, v [B, t, H HD] ~ N(0, 1), bd [B, H, t, 2t - 1] ~ N(0, 8) (a
    view of an [H, B, t, 8k] buffer, as the module makes it), u ~ N(0,
    0.1) f32, the key mask of lengths drawn from (t - 100, t] with one row
    at t, and the lengths."""
    g = torch.Generator().manual_seed(seed)
    d = H * HD

    def normal(*shape, std=1.0):
        return (std * torch.randn(*shape, generator=g)).to(
            device, torch.bfloat16)

    q, k, v = (normal(B, t, d) for _ in range(3))
    n = 2 * t - 1
    bd = normal(H, B, t, n + (-n % 8), std=8.0)[..., :n].transpose(0, 1)
    u = (0.1 * torch.randn(H, HD, generator=g)).to(device)
    lengths = torch.randint(max(1, t - 99), t + 1, (B,), generator=g)
    lengths[0] = t
    mask = (torch.arange(t)[None] < lengths[:, None])[:, None, None]
    return q, k, v, bd, u, mask.to(device), lengths


def bound(q: torch.Tensor, bd: torch.Tensor) -> dict:
    """The kernel's work on these inputs (q [B, T', d], bd [B, h, T',
    2T'-1]): the two products' FLOPs, the bytes with the [T', T'] band of
    ``bd`` the queries read and with ``bd`` whole, and the bound in ms (the
    larger of the FLOPs at 989 TFLOP/s and the band's bytes at 3.35 TB/s)
    and what sets it."""
    b, t, d = q.shape
    flops = 4 * b * t * t * d
    qkvo = 4 * q.numel() * q.element_size()
    band = qkvo + b * bd.shape[1] * t * t * bd.element_size()
    whole = qkvo + bd.numel() * bd.element_size()
    by_ops, by_bytes = flops / PEAK_FLOPS, band / PEAK_BYTES
    return {"flops": flops, "band_bytes": band, "whole_bytes": whole,
            "bound_ms": max(by_ops, by_bytes) * 1e3,
            "bound_by": "operations" if by_ops > by_bytes else "bytes",
            "whole_ms": whole / PEAK_BYTES * 1e3}


def main() -> int:
    from tensorflowasr_tpu_torch.kernels.timing import card_line, cuda_times
    from tensorflowasr_tpu_torch.ops import rel_attention as ra

    card_line()

    def line(what, fn):
        ms = cuda_times(fn, REPS, INNER)
        print(f"  {what}: median {ms['median']:.4f} min {ms['min']:.4f} ms",
              flush=True)
        return ms["median"]

    for t in LENGTHS:
        q, k, v, bd, u, mask, _ = inputs(t, t)
        f32 = [x.float() for x in (q, k, v, bd)]
        want = ra.rel_attention_reference(*f32, u, mask)
        got = ra.rel_attention_cuda(q, k, v, bd, u, mask)
        plain = ra.rel_attention_reference(q, k, v, bd, u, mask)
        err = float((got.float() - want).abs().max())
        err_plain = float((plain.float() - want).abs().max())
        work = bound(q, bd)
        print(f"T'={t}: largest |entry| {float(want.abs().max()):.4f}, "
              f"error kernel {err:.3e}, plain bf16 {err_plain:.3e} "
              f"(ratio {err / err_plain:.3f}); {work['flops'] / 1e9:.2f} "
              f"GFLOP, {work['band_bytes'] / 1e6:.1f} MB with the band "
              f"({work['whole_bytes'] / 1e6:.1f} MB with bd whole): bound "
              f"{work['bound_ms']:.4f} ms by {work['bound_by']} "
              f"({work['whole_ms']:.4f} with bd whole)", flush=True)
        kernel = line(f"kernel tiles {ra.TILES}",
                      lambda: ra.rel_attention_cuda(q, k, v, bd, u, mask))
        print(f"  kernel at {100 * work['bound_ms'] / kernel:.1f} % of its "
              f"bound", flush=True)
        fixed = ra.TILES
        try:
            for tiles in OTHER_TILES:
                ra.TILES = tiles
                line(f"kernel tiles {tiles}",
                     lambda: ra.rel_attention_cuda(q, k, v, bd, u, mask))
        finally:
            ra.TILES = fixed
        line("plain composition", lambda: ra.rel_attention_reference(
            q, k, v, bd, u, mask))
        qv = q.view(B, t, H, HD)
        p = torch.randn(H, 2 * t - 1, HD, device=q.device,
                        dtype=q.dtype)
        line("position scores, [h, B T', hd] product", lambda: torch.matmul(
            qv.view(B * t, H, HD).transpose(0, 1), p.transpose(-1, -2)))
        line("position scores, [h, B T', hd] product, rows padded to 8k "
             "(the module's, with its pad)", lambda: torch.matmul(
                 qv.view(B * t, H, HD).transpose(0, 1), F.pad(
                     p, (0, 0, 0, -(2 * t - 1) % 8)).transpose(-1, -2)))
        line("position scores, broadcast product", lambda: torch.matmul(
            qv.transpose(1, 2), p.transpose(-1, -2)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
