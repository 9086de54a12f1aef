"""The port's log-mel frontend against ``tensorflowasr_tpu.ops.frontend``
(the XLA path) and ``pallas_frontend`` (the Pallas kernel, in interpret
mode as ``tests/test_pallas_frontend.py`` runs it), plus the K1 kernel's
algorithm walked on the host with its own tables, and its launch rules.

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


# ---------------------------------------------------------------------------
# K1's algorithm, walked on the host with the kernel's own tables
# ---------------------------------------------------------------------------

def _complex(pairs):
    return (pairs[..., 0] + 1j * pairs[..., 1]).astype(np.complex64)


def _fft4(c0, c1, c2, c3):
    d0, d1, d2, d3 = c0 + c2, c0 - c2, c1 + c3, (c1 - c3) * np.complex64(-1j)
    return d0 + d2, d1 + d3, d0 - d2, d1 - d3


def _fft8(a):
    """csrc/power_spectrogram.cu::fft8, line by line, on 8 arrays."""
    h = np.float32(np.sqrt(0.5))
    b0, b1, b2, b3 = a[0] + a[4], a[1] + a[5], a[2] + a[6], a[3] + a[7]
    b4, b5, b6, b7 = a[0] - a[4], a[1] - a[5], a[2] - a[6], a[3] - a[7]
    b5 = (h * (b5.real + b5.imag) + 1j * (h * (b5.imag - b5.real)))
    b6 = b6.imag - 1j * b6.real
    b7 = (h * (b7.imag - b7.real) - 1j * (h * (b7.real + b7.imag)))
    out = [None] * 8
    out[0], out[2], out[4], out[6] = _fft4(b0, b1, b2, b3)
    out[1], out[3], out[5], out[7] = _fft4(b4, b5.astype(np.complex64),
                                           b6.astype(np.complex64),
                                           b7.astype(np.complex64))
    return out


def _kernel_fft512(z, tables):
    """The kernel's three radix-8 passes over one frame's packed samples
    z [512] complex64: 64 'threads' t, 8 values each, two exchanges through
    padded buffers. Unwritten buffer cells are NaN."""
    tw1, tw2 = _complex(tables["tw1"]), _complex(tables["tw2"])
    t = np.arange(k1.FRAME_THREADS)
    buf_a = np.full(k1.BUF_FLOAT2, np.nan + 0j, np.complex64)
    buf_b = np.full(k1.BUF_FLOAT2, np.nan + 0j, np.complex64)
    a = _fft8([z[t + 64 * j] for j in range(8)])
    for kk in range(8):
        buf_a[kk * k1.EX1_STRIDE + t] = a[kk] * tw1[kk, t]
    k1b, t2 = t >> 3, t & 7
    a = _fft8([buf_a[k1b * k1.EX1_STRIDE + t2 + 8 * j2] for j2 in range(8)])
    for k2 in range(8):
        buf_b[t2 * k1.EX2_STRIDE + 8 * k2 + k1b] = a[k2] * tw2[k2, t2]
    a = _fft8([buf_b[r * k1.EX2_STRIDE + t] for r in range(8)])
    for k3 in range(8):
        buf_a[t + 64 * k3] = a[k3]
    return buf_a[:512]


def _kernel_untangle(zbuf, tables):
    """Z [512] -> the 513 powers of the real transform, as the kernel's 64
    threads write them; every bin exactly once."""
    ut = _complex(tables["untangle"])
    t = np.arange(k1.FRAME_THREADS)
    row = np.full(513, np.nan, np.float32)
    written = np.zeros(513, np.int64)
    for i in range(4):
        k = t + 64 * i
        zk, zr = zbuf[k], zbuf[(512 - k) & 511]
        total, dif = zk + np.conj(zr), zk - np.conj(zr)
        rot = ut[k] * dif
        row[k] = 0.25 * np.abs(total + rot) ** 2
        row[512 - k] = 0.25 * np.abs(total - rot) ** 2
        np.add.at(written, k, 1)
        np.add.at(written, 512 - k, 1)
    z = zbuf[256]
    row[256] = 0.25 * np.abs(2 * z.real + ut[256] * (2j * z.imag)) ** 2
    written[256] += 1
    assert (written == 1).all()
    return row


def _kernel_emulation(wav, cfg, tile_frames):
    """power [B, F, 513] the way the kernel computes it: a zero-padded slab
    per tile of frames, window on the way out of the slab, pack, three
    radix-8 passes, untangle, square."""
    tables = k1.fft_tables(tfe.hann_window(cfg.n_fft))
    win = tables["window"]
    hop, n_fft = cfg.hop, cfg.n_fft
    b, t = wav.shape
    lo = tfe._left_pad(t, cfg)
    n_frames = k1.num_frames(t, hop)
    out = np.zeros((b, n_frames, 513), np.float32)
    for row in range(b):
        for f0 in range(0, n_frames, tile_frames):
            s0 = f0 * hop - lo
            s = s0 + np.arange((tile_frames - 1) * hop + n_fft)
            inside = (s >= 0) & (s < t)
            slab = np.where(inside, wav[row, np.clip(s, 0, t - 1)],
                            np.float32(0))
            for fl in range(min(tile_frames, n_frames - f0)):
                xw = slab[fl * hop:fl * hop + n_fft] * win
                z = (xw[0::2] + 1j * xw[1::2]).astype(np.complex64)
                out[row, f0 + fl] = _kernel_untangle(
                    _kernel_fft512(z, tables), tables)
    return out


def test_kernel_fft_passes_match_numpy_fft():
    tables = k1.fft_tables(tfe.hann_window(1024))
    rng = np.random.default_rng(7)
    z = (rng.standard_normal(512) + 1j * rng.standard_normal(512)
         ).astype(np.complex64)
    got = _kernel_fft512(z, tables)
    np.testing.assert_allclose(got, np.fft.fft(z.astype(np.complex128)),
                               rtol=0, atol=2e-4)
    x = rng.standard_normal(1024).astype(np.float32)
    zx = (x[0::2] + 1j * x[1::2]).astype(np.complex64)
    np.testing.assert_allclose(
        _kernel_untangle(_kernel_fft512(zx, tables), tables),
        np.abs(np.fft.rfft(x.astype(np.float64))) ** 2, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("padding,t,sample_rate,tile_frames", [
    ("same", 16077, 16000, 32), ("valid", 2560 * 3, 16000, 2),
    ("same", 100, 16000, 1), ("valid", 4011, 8000, 16),
])
def test_kernel_algorithm_matches_plain_xla_and_pallas(padding, t,
                                                       sample_rate,
                                                       tile_frames):
    """The kernel's passes, emulated with its host-built tables, against
    the plain version, the XLA path and the Pallas kernel."""
    jcfg = jfe.LogMelFrontendConfig(padding=padding, sample_rate=sample_rate)
    tcfg = tfe.LogMelFrontendConfig(padding=padding, sample_rate=sample_rate)
    wav = _wav(t=t, seed=t)
    got = _kernel_emulation(wav, tcfg, tile_frames)
    assert got.shape == (2, -(-t // tcfg.hop), 513)
    plain = tfe.power_spectrogram(torch.from_numpy(wav), tcfg).numpy()
    np.testing.assert_allclose(got, plain, **POWER_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jfe.power_spectrogram(wav, jcfg)), **POWER_TOL)
    np.testing.assert_allclose(
        got, np.asarray(power_spectrogram_pallas(wav, jcfg, interpret=True,
                                                 tile_f=32)), **POWER_TOL)


def test_kernel_tables():
    window = tfe.hann_window(1024)
    tables = k1.fft_tables(window)
    np.testing.assert_array_equal(tables["window"], window)
    assert {n: a.shape for n, a in tables.items()} == {
        "window": (1024,), "tw1": (8, 64, 2), "tw2": (8, 8, 2),
        "untangle": (257, 2)}
    assert all(a.dtype == np.float32 for a in tables.values())
    kk, tt = 5, 37
    np.testing.assert_allclose(_complex(tables["tw1"])[kk, tt],
                               np.exp(-2j * np.pi * kk * tt / 512), atol=1e-7)
    np.testing.assert_allclose(_complex(tables["tw2"])[3, 6],
                               np.exp(-2j * np.pi * 18 / 64), atol=1e-7)
    np.testing.assert_allclose(_complex(tables["untangle"])[[0, 256]],
                               [-1j, -1], atol=1e-7)
    flat = k1.pack_tables(window)
    assert flat.dtype == np.float32 and flat.shape == (2690,) \
        == (k1.TABLE_FLOATS,)
    np.testing.assert_array_equal(flat[:1024], window)
    np.testing.assert_array_equal(flat[-514:], tables["untangle"].reshape(-1))


def test_kernel_exchanges_avoid_bank_conflicts():
    """Every 8-byte shared-memory access of a half-warp (16 threads) in the
    two exchanges falls in 16 distinct bank pairs."""
    t = np.arange(k1.FRAME_THREADS)
    k1b, t2 = t >> 3, t & 7
    accesses = []
    for q in range(8):
        accesses += [q * k1.EX1_STRIDE + t,                   # ex. 1 write
                     k1b * k1.EX1_STRIDE + t2 + 8 * q,        # ex. 1 read
                     t2 * k1.EX2_STRIDE + 8 * q + k1b,        # ex. 2 write
                     q * k1.EX2_STRIDE + t,                   # ex. 2 read
                     t + 64 * q]                              # Z write
    for i in range(4):
        accesses += [t + 64 * i, (512 - (t + 64 * i)) & 511]  # untangle
    for addr in accesses:
        assert addr.max() < k1.BUF_FLOAT2
        for half in addr.reshape(-1, 16):
            assert len(set(half % 16)) == 16


@pytest.mark.parametrize("n_fft,match", [
    (1000, "power-of-two"), (400, "power-of-two"), (512, "built for n_fft"),
])
def test_kernel_refuses_other_n_fft(n_fft, match):
    with pytest.raises(ValueError, match=match):
        k1.pack_tables(tfe.hann_window(n_fft))
    with pytest.raises(ValueError, match=match):
        tfe._kernel_tables(tfe.LogMelFrontendConfig(n_fft=n_fft),
                           torch.device("cpu"))


@pytest.mark.parametrize("padding,b,t,want", [
    ("same", 128, 7 * 16000, k1.LaunchPlan(32, 4, True)),
    ("same", 1, 7680, k1.LaunchPlan(1, 1, True)),     # one 0.48 s request
    ("valid", 16, 2560 * 3, k1.LaunchPlan(2, 2, False)),   # lo = 1023
    ("same", 3, 32077, k1.LaunchPlan(2, 2, False)),   # ragged row stride
])
def test_kernel_launch_plan(padding, b, t, want):
    cfg = tfe.LogMelFrontendConfig(padding=padding)
    lo = tfe._left_pad(t, cfg)
    plan = k1.launch_plan(b, t, cfg.hop, lo, sm_count=132)
    assert plan == want
    assert plan.tile_frames % plan.groups == 0
    assert k1.smem_bytes(cfg.hop, plan.tile_frames, plan.groups) \
        <= k1.MAX_SMEM_BYTES
    # a misaligned base pointer always takes the 4-byte path
    assert not k1.launch_plan(b, t, cfg.hop, lo, 132,
                              base_aligned=False).vec16
    # a hop too long for the large tiles falls to one that fits
    long_hop = k1.launch_plan(128, 10 ** 6, 4000, 0, 132)
    assert k1.smem_bytes(4000, long_hop.tile_frames, long_hop.groups) \
        <= k1.MAX_SMEM_BYTES


def test_kernel_wrapper_refuses_cpu_tensors():
    _, cfg = _cfgs("same")
    wav = torch.zeros(1, 1600)
    tables = tfe._kernel_tables(cfg, torch.device("cpu"))
    assert tables.shape == (k1.TABLE_FLOATS,)
    with pytest.raises(ValueError, match="CUDA tensor"):
        k1.power_spectrogram_cuda(wav, tables, cfg.hop, 0)
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
