"""The port's log-mel frontend against ``tensorflowasr_tpu.ops.frontend``
(the XLA path) and ``pallas_frontend`` (the Pallas kernel, in interpret
mode as ``tests/test_pallas_frontend.py`` runs it), plus the K1 kernel
module's host side.

On the CPU the port's ``power_spectrogram`` runs its plain version; the
hand-written CUDA kernel runs only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops import frontend as jfe
from tensorflowasr_tpu.ops.pallas_frontend import (
    log_mel_spectrogram_pallas,
    power_spectrogram_pallas,
)
from tensorflowasr_tpu_torch.kernels import build
from tensorflowasr_tpu_torch.ops import frontend as tfe
from tensorflowasr_tpu_torch.ops import power_spectrogram as k1

torch.set_num_threads(2)

# the Pallas kernel's own tolerances (tests/test_pallas_frontend.py)
POWER_TOL = dict(rtol=2e-4, atol=2e-3)
LOGMEL_TOL = dict(rtol=1e-3, atol=5e-2)


def _wav(b=2, t=16000, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, t))
            .astype(np.float32) * 0.1)


def _cfgs(padding):
    return (jfe.LogMelFrontendConfig(padding=padding),
            tfe.LogMelFrontendConfig(padding=padding))


def test_numpy_constants_match():
    jcfg, tcfg = _cfgs("same")
    for got, want in zip(tfe._frontend_constants(tcfg),
                         jfe._frontend_constants(jcfg)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfe._padded_dft(tcfg),
                                  jfe._padded_dft(jcfg))
    np.testing.assert_array_equal(tfe.hann_window(400),
                                  jfe.hann_window(400))
    np.testing.assert_array_equal(
        tfe.mel_filterbank(8000, 512, 40, fmin=20.0, fmax=3800.0),
        jfe.mel_filterbank(8000, 512, 40, fmin=20.0, fmax=3800.0))
    for t, k, s in ((100, 1024, 160), (16077, 1024, 160), (7, 3, 2)):
        assert tfe._same_pad(t, k, s) == jfe._same_pad(t, k, s)


@pytest.mark.parametrize("padding,t", [
    ("same", 16000), ("same", 16077), ("valid", 2560 * 3), ("valid", 8011),
])
def test_power_spectrogram_matches_xla_and_pallas(padding, t):
    jcfg, tcfg = _cfgs(padding)
    wav = _wav(t=t, seed=t)
    xla = np.asarray(jfe.power_spectrogram(wav, jcfg))
    pallas = np.asarray(power_spectrogram_pallas(wav, jcfg, interpret=True,
                                                 tile_f=32))
    got = tfe.power_spectrogram(torch.from_numpy(wav), tcfg).numpy()
    assert got.shape == xla.shape == (2, -(-t // 160), 513)
    np.testing.assert_allclose(got, xla, **POWER_TOL)
    np.testing.assert_allclose(got, pallas, **POWER_TOL)


@pytest.mark.parametrize("padding", ["same", "valid"])
def test_log_mel_matches_xla_and_pallas(padding):
    jcfg, tcfg = _cfgs(padding)
    wav = _wav(seed=2)
    xla = np.asarray(jfe.log_mel_spectrogram(wav, jcfg))
    pallas = np.asarray(log_mel_spectrogram_pallas(wav, jcfg,
                                                   interpret=True))
    got = tfe.log_mel_spectrogram(torch.from_numpy(wav), tcfg).numpy()
    np.testing.assert_allclose(got, xla, **LOGMEL_TOL)
    np.testing.assert_allclose(got, pallas, **LOGMEL_TOL)


@pytest.mark.parametrize("padding", ["same", "valid"])
def test_spectrogram_feature_and_db(padding):
    jcfg, tcfg = _cfgs(padding)
    wav = _wav(seed=3, t=4000)
    want = np.asarray(jfe.spectrogram_feature(wav, jcfg))
    got = tfe.spectrogram_feature(torch.from_numpy(wav), tcfg).numpy()
    np.testing.assert_allclose(got, want, **LOGMEL_TOL)
    # the dB passes alone, on the same power (global per-example max,
    # floor at -80 for 'same'; plain log10 for 'valid')
    power = np.array(jfe.power_spectrogram(wav, jcfg))
    power[0, :3] = 0.0
    np.testing.assert_allclose(
        tfe.amplitude_to_db(torch.from_numpy(power)).numpy(),
        np.asarray(jfe.amplitude_to_db(power)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        tfe.chunk_amplitude_to_db(torch.from_numpy(power)).numpy(),
        np.asarray(jfe.chunk_amplitude_to_db(power)), rtol=1e-5, atol=1e-5)


def test_int16_input():
    pcm = (_wav(seed=4) * 20000).astype(np.int16)
    assert tfe.wav_to_float(torch.from_numpy(pcm)).dtype == torch.float32
    np.testing.assert_array_equal(
        tfe.wav_to_float(torch.from_numpy(pcm)).numpy(),
        np.asarray(jfe.wav_to_float(pcm)))
    f = torch.zeros(3)
    assert tfe.wav_to_float(f) is f
    jcfg, tcfg = _cfgs("same")
    want = np.asarray(jfe.log_mel_spectrogram(jfe.wav_to_float(pcm), jcfg))
    got = tfe.log_mel_spectrogram(tfe.wav_to_float(torch.from_numpy(pcm)),
                                  tcfg).numpy()
    np.testing.assert_allclose(got, want, **LOGMEL_TOL)


@pytest.mark.parametrize("padding,t", [("same", 16077), ("valid", 2560 * 3)])
def test_kernel_operand_layout(padding, t):
    """K1's DFT operand, read the way csrc/power_spectrogram.cu reads it
    (frames = C shifted hop rows of a slab, hop rows padded to hop_pad,
    re | im split, bins padded), reproduces the plain power spectrum."""
    _, cfg = _cfgs(padding)
    hop, n_freq = cfg.hop, cfg.n_freq
    op = k1.tile_dft(tfe._padded_dft(cfg), hop)     # [C*hop_pad, 2, nfp]
    hop_pad = -(-hop // k1.BLOCK_K) * k1.BLOCK_K
    n_chunks = op.shape[0] // hop_pad
    wav = _wav(b=1, t=t, seed=5)[0].astype(np.float64)
    lo = tfe._left_pad(t, cfg)
    n_frames = k1.num_frames(t, hop)
    rows = np.zeros((n_frames + n_chunks - 1, hop_pad))
    for r in range(rows.shape[0]):
        for c in range(hop):
            s = r * hop + c - lo
            if 0 <= s < t:
                rows[r, c] = wav[s]
    acc = sum(rows[r:r + n_frames] @ op[r * hop_pad:(r + 1) * hop_pad]
              .reshape(hop_pad, -1) for r in range(n_chunks))
    re, im = np.split(acc, 2, axis=1)
    got = (re * re + im * im)[:, :n_freq]
    want = tfe.power_spectrogram(torch.from_numpy(wav[None].astype(
        np.float32)), cfg).numpy()[0]
    np.testing.assert_allclose(got, want, **POWER_TOL)


def test_kernel_wrapper_refuses_cpu_tensors():
    _, cfg = _cfgs("same")
    wav = torch.zeros(1, 1600)
    dft = torch.from_numpy(k1.tile_dft(tfe._padded_dft(cfg), cfg.hop))
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.power_spectrogram_cuda(wav, dft, cfg.n_freq, cfg.hop, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        tfe.power_spectrogram(torch.zeros(1, 1600, device="meta"), cfg)
    assert k1.power_spectrogram_cuda.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
    # the library name follows the sources, so an edit rebuilds
    assert build.library_path("power_spectrogram").name.startswith(
        "libpower_spectrogram-")
