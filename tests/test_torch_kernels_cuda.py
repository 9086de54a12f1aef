"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. These tests import no JAX, so they also run where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA card they skip.
"""

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch.ops import frontend as fe
from tensorflowasr_tpu_torch.ops import power_spectrogram as k1

# the Pallas kernel's own tolerance (tests/test_pallas_frontend.py)
POWER_TOL = dict(rtol=2e-4, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("padding,b,t,sample_rate", [
    ("same", 8, 7 * 16000, 16000), ("valid", 16, 2560 * 3, 16000),
    ("same", 3, 32077, 16000),
    ("same", 1, 7680, 16000),        # one 0.48 s request chunk
    ("same", 2, 100, 16000),         # shorter than one frame
    ("valid", 2, 100, 16000),
    ("same", 4, 8000, 8000),         # hop 80, the 8 kHz VAD frontend
    ("valid", 4, 4011, 8000),
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
