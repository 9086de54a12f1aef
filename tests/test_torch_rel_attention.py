"""The relative-position attention kernel's algorithm (``ops/rel_attention.py``)
on the CPU: a plain PyTorch emulation of what each program of the kernel
does (query blocks, the loop over key blocks, the online softmax in log2
units, the skewed index into the position scores, masked keys never
loaded) against the plain composition in f32, at lengths that are no
multiple of a tile and with ragged key masks; the module's choice of path
and its counter; the wrapper's dispatch and its refusals. The kernel
itself runs only on the card (``tests/test_torch_kernels_cuda.py``)."""

from __future__ import annotations

import math

import pytest
import torch

from tensorflowasr_tpu_torch.models import layers
from tensorflowasr_tpu_torch.ops import rel_attention as ra
from tensorflowasr_tpu_torch.utils import telemetry

# f32 against f32: the online softmax (exp2 of log2-scaled scores, the sum
# rescaled block by block) rounds otherwise than torch.softmax, ~1e-7 of
# the largest entry; a wrong index or a lost rescale moves it by O(1)
F32_TOL = 1e-5
COUNTER = "ebranchformer.attention_kernel"


def emulate(q, k, v, bd, u, mask, block_m, block_n):
    """The kernel's algorithm, every (row, head) at once: for each block of
    ``block_m`` queries, loop over blocks of ``block_n`` keys as the kernel
    does, reading ``bd`` through its flat rows at the kernel's offset
    ``i (2T - 2) + (T - 1) + j``."""
    b, t, d = q.shape
    h, hd = u.shape
    heads = [x.view(b, t, h, hd).transpose(1, 2) for x in (q, k, v)]
    flat = bd.reshape(b, h, -1)
    keep = torch.ones(b, t, dtype=torch.bool) if mask is None \
        else mask.reshape(b, t)
    scale = math.log2(math.e) / math.sqrt(hd)
    out = torch.zeros(b, h, t, hd)
    for m0 in range(0, t, block_m):
        rows = torch.arange(m0, m0 + block_m)
        row_ok = rows < t
        qu = heads[0][:, :, rows.clamp(max=t - 1)] * row_ok[:, None] + u[
            None, :, None]
        m_i = torch.full((b, h, block_m), -math.inf)
        l_i = torch.zeros(b, h, block_m)
        acc = torch.zeros(b, h, block_m, hd)
        for n0 in range(0, t, block_n):
            keys = torch.arange(n0, n0 + block_n)
            key_ok = (keys < t)[None] & keep[:, keys.clamp(max=t - 1)]
            gate = key_ok[:, None, :, None]                  # [b, 1, n, 1]
            kb = torch.where(gate, heads[1][:, :, keys.clamp(max=t - 1)], 0)
            vb = torch.where(gate, heads[2][:, :, keys.clamp(max=t - 1)], 0)
            at = rows[:, None] * (2 * t - 2) + (t - 1) + keys[None]
            load = row_ok[:, None] & (keys < t)[None]
            pos = torch.where(load, flat[..., at.clamp(0, flat.shape[-1]
                                                       - 1)], 0)
            s = (qu @ kb.transpose(-1, -2) + pos) * scale
            s = torch.where(key_ok[:, None, None, :], s, -math.inf)
            m_new = torch.maximum(m_i, s.amax(-1))
            m_use = torch.where(m_new == -math.inf, 0.0, m_new)
            alpha = torch.exp2(m_i - m_use)
            p = torch.exp2(s - m_use[..., None])
            l_i = l_i * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vb
            m_i = m_new
        o = acc / l_i[..., None]
        out[:, :, rows[row_ok]] = o[:, :, row_ok]
    return out.transpose(1, 2).reshape(b, t, d)


def case(b, t, h, hd, lengths, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, t, h * hd, generator=g) for _ in range(3))
    bd = 4.0 * torch.randn(b, h, t, 2 * t - 1, generator=g)
    u = 0.3 * torch.randn(h, hd, generator=g)
    mask = None if lengths is None else layers.key_mask(
        torch.tensor(lengths), t)
    return q, k, v, bd, u, mask


def assert_close(got, want, tol=F32_TOL):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{err} > {tol} x {scale}"


@pytest.mark.parametrize("t,lengths,tile", [
    (37, [37, 1, 20], (16, 8)),          # a row of one key
    (37, [37, 36, 17], ra.TILES[:2]),   # the kernel's own tiles
    (70, [70, 1, 33], (32, 16)),
    (70, None, (16, 32)),                # no lengths: every key counts
    (101, [64, 101, 5], (64, 64)),       # keys past a whole tile masked
])
def test_the_kernels_algorithm_equals_the_plain_composition(t, lengths, tile):
    q, k, v, bd, u, mask = case(3, t, 2, 8, lengths, seed=t)
    want = ra.rel_attention_reference(q, k, v, bd, u, mask)
    assert_close(emulate(q, k, v, bd, u, mask, *tile), want)


def test_masked_keys_weigh_exactly_nothing_in_the_algorithm():
    """What the masked keys and their position scores hold cannot reach
    any query, bit for bit."""
    q, k, v, bd, u, mask = case(2, 29, 2, 8, [29, 11], seed=5)
    a = emulate(q, k, v, bd, u, mask, 16, 8)
    k[1, 11:], v[1, 11:] = 1e4, float("nan")
    for i in range(29):          # query i's scores against keys j >= 11
        bd[1, :, i, 11 - i + 28:] = float("nan")
    assert torch.equal(emulate(q, k, v, bd, u, mask, 16, 8), a)


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v, bd, u, mask = case(2, 9, 2, 8, [9, 4])
    before = ra.rel_attention_cuda.launches
    assert torch.equal(ra.rel_attention(q, k, v, bd, u, mask),
                       ra.rel_attention_reference(q, k, v, bd, u, mask))
    assert ra.rel_attention_cuda.launches == before


@pytest.mark.parametrize("what", ["dtype", "head_size", "bd", "mask"])
def test_the_kernels_wrapper_refuses_what_it_does_not_take(what):
    """Checked before anything reaches the card: f32, a head size of 24, a
    position-score tensor of the wrong shape, a mask that is not bool."""
    q, k, v, bd, u, mask = case(2, 9, 2, 8, [9, 4])
    q, k, v, bd = (x.to(torch.bfloat16) for x in (q, k, v, bd))
    if what == "dtype":
        q, k, v, bd = (x.float() for x in (q, k, v, bd))
    elif what == "head_size":
        q, k, v = (torch.zeros(2, 9, 48, dtype=torch.bfloat16)
                   for _ in range(3))
        bd, u = torch.zeros(2, 2, 9, 17, dtype=torch.bfloat16), \
            torch.zeros(2, 24)
    elif what == "bd":
        bd = bd[..., :-1]
    else:
        mask = mask.to(torch.uint8)
    with pytest.raises(ValueError):
        ra.rel_attention_cuda(q, k, v, bd, u, mask)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_the_module_takes_the_plain_path_on_the_cpu(mode):
    """On the CPU, in eval under ``no_grad`` and in training, the module
    runs the plain composition and records 0 a call; its output is the
    plain composition of its own projections."""
    attn = layers.RelPositionMultiHeadAttention(16, 2, dropout=0.1)
    with torch.no_grad():
        attn.pos_bias_u.normal_()
        attn.pos_bias_v.normal_()
    x = torch.randn(2, 7, 16)
    pos = torch.from_numpy(layers.rel_positional_encoding(7, 16))
    mask = layers.key_mask(torch.tensor([7, 3]), 7)
    telemetry.reset()
    if mode == "eval":
        attn.eval()
        with torch.no_grad():
            got = attn(x, pos, mask)
        h, hd = 2, 8
        q = attn.query(x)
        p = attn.pos(pos).view(-1, h, hd).transpose(0, 1)
        bd = torch.matmul((q.view(2, 7, h, hd) + attn.pos_bias_v)
                          .transpose(1, 2), p.transpose(-1, -2))
        want = attn.out(ra.rel_attention_reference(
            q, attn.key(x), attn.value(x), bd, attn.pos_bias_u, mask))
        assert torch.equal(got, want.detach())
    else:
        attn.train()
        layers.set_generator(attn, torch.Generator().manual_seed(0))
        attn(x, pos, mask).sum().backward()
        assert attn.pos_bias_u.grad is not None
    rec = telemetry.between(COUNTER)
    assert len(rec) == 1 and rec[0, 1] == 0.0
    telemetry.reset()
