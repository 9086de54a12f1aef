"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. These tests import no JAX, so they also run where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA card they skip.
"""

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch import testing
from tensorflowasr_tpu_torch.kernels import sweep_rel_attention as ra_sweep
from tensorflowasr_tpu_torch.models import layers
from tensorflowasr_tpu_torch.ops import frontend as fe
from tensorflowasr_tpu_torch.ops import log_mel_spectrogram as k1b
from tensorflowasr_tpu_torch.ops import power_spectrogram as k1
from tensorflowasr_tpu_torch.ops import rel_attention as ra
from tensorflowasr_tpu_torch.testing import (
    KERNEL_LOGMEL_TOL,
    MAIN_PATH,
    POWER_TOL,
)
from tensorflowasr_tpu_torch.utils import telemetry

# K1b's shapes, each in both paddings
SHAPES = [(8, 7 * 16000, 16000), (16, 2560 * 3, 16000), (3, 32077, 16000),
          (1, 7680, 16000), (2, 100, 16000), (4, 8000, 8000),
          (4, 4011, 8000), *((b, t, 16000) for b, t in MAIN_PATH)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    # the plain version's matmuls in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False


def _noise(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32) * 0.1).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("padding,b,t,sample_rate", [
    ("same", 8, 7 * 16000, 16000), ("valid", 16, 2560 * 3, 16000),
    ("same", 3, 32077, 16000),
    ("same", 1, 7680, 16000),        # one 0.48 s request chunk
    ("same", 2, 100, 16000),         # shorter than one frame
    ("valid", 2, 100, 16000),
    ("same", 4, 8000, 8000),         # hop 80, the 8 kHz VAD frontend
    ("valid", 4, 4011, 8000),
    *((padding, b, t, 16000) for b, t in MAIN_PATH
      for padding in ("same", "valid")),
])
def test_kernel_matches_plain_on_card(padding, b, t, sample_rate):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    # the plain version's matmul in full f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = fe.LogMelFrontendConfig(padding=padding, sample_rate=sample_rate)
    wav = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (b, t)).astype(np.float32) * 0.1).cuda()
    before = k1.power_spectrogram_cuda.launches
    got = fe.power_spectrogram(wav, cfg)
    want = fe.power_spectrogram_reference(wav, cfg)
    torch.cuda.synchronize()
    assert k1.power_spectrogram_cuda.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **POWER_TOL)


@pytest.mark.cuda
def test_kernel_takes_an_unaligned_view_on_card():
    """A wav whose first sample is not 16-byte aligned goes the 4-byte copy
    path and gives the same power."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = fe.LogMelFrontendConfig(padding="same")
    flat = torch.from_numpy(np.random.default_rng(8).standard_normal(
        2 * 16000 + 1).astype(np.float32) * 0.1).cuda()
    wav = flat[1:].view(2, 16000)
    assert wav.data_ptr() % 16 != 0 and wav.is_contiguous()
    got = fe.power_spectrogram(wav, cfg)
    want = fe.power_spectrogram(wav.clone(), cfg)
    plain = fe.power_spectrogram_reference(wav, cfg)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                               **POWER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["same", "valid"])
@pytest.mark.parametrize("b,t,sample_rate", SHAPES)
def test_log_mel_kernel_matches_plain_on_card(padding, b, t, sample_rate):
    """K1b (the fixed basis, banded) against its plain version, one FFT
    launch a call, and a row of zeros (every bin at amin: 'same' log-mel
    0)."""
    _card()
    cfg = fe.LogMelFrontendConfig(padding=padding, sample_rate=sample_rate)
    wav = _noise((b, t), seed=t)
    if padding == "same" and b > 1:
        wav[1] = 0.0
    want = fe.log_mel_spectrogram_reference(wav, cfg)
    sched, weights = fe._kernel_bands(cfg, wav.device)
    k1_before = k1.power_spectrogram_cuda.launches
    k1b_before = k1b.log_mel_spectrogram_cuda.launches
    got = k1b.log_mel_spectrogram_cuda(
        wav, fe._kernel_tables(cfg, wav.device), weights, cfg.n_mels,
        cfg.hop, fe._left_pad(t, cfg), sched=sched, same=padding == "same")
    torch.cuda.synchronize()
    assert k1b.log_mel_spectrogram_cuda.launches == k1b_before + 1
    assert k1.power_spectrogram_cuda.launches == k1_before + 1
    assert got.shape == (b, -(-t // cfg.hop), cfg.n_mels)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **KERNEL_LOGMEL_TOL)
    if padding == "same" and b > 1:
        assert float(got[1].abs().max()) == 0.0
    # the frontend's own dispatch
    np.testing.assert_allclose(fe.log_mel_spectrogram(wav, cfg).cpu().numpy(),
                               want.cpu().numpy(), **KERNEL_LOGMEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["same", "valid"])
@pytest.mark.parametrize("b,t,n_mels", [
    (8, 7 * 16000, 80), (3, 32077, 80), (2, 100, 80), (4, 8000, 20),
    (2, 16000, 40), (2, 16000, 200)])
def test_dense_mel_kernel_matches_plain_on_card(padding, b, t, n_mels):
    """K1b with a given [513, n_mels] matrix (K1, then the dense product
    kernel, in tiles of up to 128 bands) against its plain
    version, with a row of zeros."""
    _card()
    cfg = fe.LogMelFrontendConfig(padding=padding, n_mels=n_mels)
    wav = _noise((b, t), seed=t + 3)
    if b > 1:
        wav[1] = 0.0
    fb = fe._frontend_constants(cfg)[1]
    w = torch.from_numpy(fb + np.random.default_rng(n_mels).uniform(
        0, 2e-3, fb.shape).astype(np.float32)).cuda()
    want = fe.log_mel_spectrogram_reference(wav, cfg, w)
    k1_before = k1.power_spectrogram_cuda.launches
    k1b_before = k1b.log_mel_spectrogram_cuda.launches
    got = fe.log_mel_spectrogram(wav, cfg, mel_weights=w)
    torch.cuda.synchronize()
    assert k1b.log_mel_spectrogram_cuda.launches == k1b_before + 1
    assert k1.power_spectrogram_cuda.launches == k1_before + 1
    assert got.shape == (b, -(-t // cfg.hop), n_mels)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **KERNEL_LOGMEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["same", "valid"])
@pytest.mark.parametrize("b,t", [(4, 3 * 16000 + 77), (8, 2 * 16000),
                                 (8, 4 * 16000)])
def test_log_mel_kernel_with_given_weights_and_backward_on_card(padding, b,
                                                                t):
    """A trainable mel matrix (K1, then the dense product): the forward
    against the plain version, and the gradient of the autograd function
    against the plain version's autograd, within 1e-4 of its largest entry
    (both take the dB of a power computed two ways, K1 and the plain DFT,
    and the near-silent bins' logs carry their rounding); also at the
    CLI's buckets, B = 8 x 2 s and 4 s."""
    _card()
    cfg = fe.LogMelFrontendConfig(padding=padding)
    wav = _noise((b, t), seed=21)
    fb = fe._frontend_constants(cfg)[1]
    w0 = torch.from_numpy(fb + np.random.default_rng(22).uniform(
        0, 2e-3, fb.shape).astype(np.float32)).cuda()
    n_frames = -(-wav.shape[1] // cfg.hop)
    cot = _noise((b, n_frames, cfg.n_mels), seed=23)
    grads = []
    for fn in (fe.log_mel_spectrogram, fe.log_mel_spectrogram_reference):
        w = w0.clone().requires_grad_()
        out = fn(wav, cfg, mel_weights=w)
        (out * cot).sum().backward()
        grads.append((out.detach(), w.grad))
    torch.cuda.synchronize()
    (got, got_grad), (want, want_grad) = grads
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **KERNEL_LOGMEL_TOL)
    scale = float(want_grad.abs().max())
    np.testing.assert_allclose(got_grad.cpu().numpy(),
                               want_grad.cpu().numpy(), rtol=0,
                               atol=1e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["same", "valid"])
def test_log_mel_kernel_takes_unaligned_and_strided_wavs_on_card(padding):
    """A wav whose first sample is not 16-byte aligned goes the kernel's
    4-byte copy path; a strided view is made contiguous by the frontend.
    Both give the log-mel of a contiguous copy."""
    _card()
    cfg = fe.LogMelFrontendConfig(padding=padding)
    flat = _noise(2 * 16000 + 1, seed=24)
    unaligned = flat[1:].view(2, 16000)
    assert unaligned.data_ptr() % 16 != 0 and unaligned.is_contiguous()
    strided = _noise((16000, 2), seed=25).t()
    assert not strided.is_contiguous()
    for wav in (unaligned, strided):
        got = fe.log_mel_spectrogram(wav, cfg)
        want = fe.log_mel_spectrogram(wav.clone(memory_format=torch.
                                                contiguous_format), cfg)
        plain = fe.log_mel_spectrogram_reference(wav.contiguous(), cfg)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got.cpu().numpy(), plain.cpu().numpy(),
                                   **KERNEL_LOGMEL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["same", "valid"])
def test_log_mel_kernel_is_sync_free_and_graph_safe_on_card(padding):
    """No implicit host sync (``set_sync_debug_mode("error")``, as the
    chunk stream chains it) once the tables are on the card, and a CUDA
    graph of the call replays the eager result."""
    _card()
    cfg = fe.LogMelFrontendConfig(padding=padding)
    wav = _noise((2, 5120), seed=26)
    eager = fe.log_mel_spectrogram(wav, cfg)             # uploads the tables
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = fe.log_mel_spectrogram(wav, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fe.log_mel_spectrogram(wav, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fe.log_mel_spectrogram(wav, cfg)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(again, eager) and torch.equal(captured, eager)


def _largest_error(got, want):
    return float((got.float() - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("t", ra_sweep.LENGTHS)
def test_rel_attention_kernel_matches_plain_on_card(t):
    """The E-Branchformer (L) decode buckets (B = 32, 8 heads of 64, T' =
    200-500, ragged lengths): one launch a call; against the plain
    composition in f32 on the same bf16 inputs, the kernel's largest error
    at most 1.5x the bf16 plain composition's (the kernel keeps (q + u) k^T
    in f32 where the plain version rounds it to bf16, so it is expected at
    or under 1x); and what the masked keys, their values and their
    position scores hold leaves every row bit for bit alone."""
    _card()
    q, k, v, bd, u, mask, lengths = ra_sweep.inputs(t, seed=t)
    want = ra.rel_attention_reference(*(x.float() for x in (q, k, v, bd)),
                                      u, mask)
    plain = ra.rel_attention_reference(q, k, v, bd, u, mask)
    before = ra.rel_attention_cuda.launches
    got = ra.rel_attention_cuda(q, k, v, bd, u, mask)
    torch.cuda.synchronize()
    assert ra.rel_attention_cuda.launches == before + 1
    assert _largest_error(got, want) <= 1.5 * _largest_error(plain, want)
    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(2 * t - 1, device=q.device)[None] + i - (t - 1)
    k, v, bd = k.clone(), v.clone(), bd.clone()
    for r, n in enumerate(lengths.tolist()):
        k[r, n:], v[r, n:] = 1e4, float("nan")
        bd[r][:, (j >= n) | (j < 0)] = float("nan")
    again = ra.rel_attention_cuda(q, k, v, bd, u, mask)
    torch.cuda.synchronize()
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_rel_attention_module_takes_the_kernel_on_card():
    """``RelPositionMultiHeadAttention`` in bf16, eval, under ``no_grad``:
    one kernel launch and a 1 on the recorder's counter a call; with a
    gradient to record, the plain path and a 0. Against the same module in
    f32 on the CPU (the plain path), the kernel path's largest error at
    most 1.5x the bf16 plain path's. The f32 module on the card, in eval
    under ``no_grad``, raises: the kernel takes bf16 alone, and the module
    does not fall back."""
    _card()
    d, h, t = 512, 8, 300
    g = torch.Generator().manual_seed(3)
    mods = {dt: layers.RelPositionMultiHeadAttention(d, h, 0.1, dt)
            for dt in (torch.bfloat16, torch.float32)}
    with torch.no_grad():
        for name, w in mods[torch.bfloat16].state_dict().items():
            w.copy_(torch.randn(w.shape, generator=g) / (
                1.0 if name.startswith("pos_bias") else d ** 0.5))
        mods[torch.float32].load_state_dict(
            mods[torch.bfloat16].state_dict())
    for m in mods.values():
        m.eval()
    x = torch.randn(4, t, d, generator=g)
    pos = torch.from_numpy(layers.rel_positional_encoding(t, d))
    mask = layers.key_mask(torch.tensor([t, 250, 1, 123]), t)
    with torch.no_grad():
        want = mods[torch.float32](x, pos, mask).cuda()
    x, pos, mask = x.cuda(), pos.cuda(), mask.cuda()
    attn = mods[torch.bfloat16].cuda()
    telemetry.reset()
    before = ra.rel_attention_cuda.launches
    with torch.no_grad():
        fused = attn(x, pos, mask)
    plain = attn(x, pos, mask).detach()
    torch.cuda.synchronize()
    assert ra.rel_attention_cuda.launches == before + 1
    assert telemetry.between("ebranchformer.attention_kernel")[:, 1]\
        .tolist() == [1.0, 0.0]
    telemetry.reset()
    assert _largest_error(fused, want) <= 1.5 * _largest_error(plain, want)
    with torch.no_grad(), pytest.raises(ValueError):
        mods[torch.float32].cuda()(x, pos, mask)
    assert ra.rel_attention_cuda.launches == before + 1
    telemetry.reset()


@pytest.fixture(scope="module")
def ebranchformer_l():
    """The full-width bf16 E-Branchformer (L) with seeded weights, built
    once for the decode buckets."""
    _card()
    model = testing.ebranchformer_l()
    yield model
    del model
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("seconds", testing.EBF_BUCKETS)
def test_ebranchformer_predict_step_launches_the_kernel_once_a_block(
        ebranchformer_l, seconds):
    """The decode cell's predict step at each bucket (B = 32, ragged key
    masks) takes RA in every one of its 17 blocks, once a block, and
    decodes ids in range."""
    blocks = len(ebranchformer_l.encoder.blocks)
    wav, lengths = testing.ebf_batch(seconds, seed=seconds)
    before = ra.rel_attention_cuda.launches
    phone_ids, phone_lens, char_ids = testing.ebf_decode(ebranchformer_l,
                                                         wav, lengths)
    assert ra.rel_attention_cuda.launches - before == blocks == 17
    assert phone_ids.shape[0] == testing.EBF_B
    assert len(phone_lens) == testing.EBF_B
    assert 0 <= int(phone_ids.min())
    assert int(phone_ids.max()) < testing.N_PHONE
    assert 0 <= int(char_ids.min()) and int(char_ids.max()) < testing.N_CHAR
