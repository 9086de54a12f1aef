"""The port's log-mel frontend against ``tensorflowasr_tpu.ops.frontend``
(the XLA path) and ``pallas_frontend`` (the Pallas kernel, in interpret
mode as ``tests/test_pallas_frontend.py`` runs it), plus the K1 kernel's
algorithm walked on the host with its own tables, its launch rules, and
K1b's epilogues (the 'same' max pass, the dB row, the banded mel product)
walked the same way with its band tables, and its dense product for a
given (trainable) mel matrix.

On the CPU the port's ``power_spectrogram`` and ``log_mel_spectrogram`` run
their plain versions; the hand-written CUDA kernels run only on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tensorflowasr_tpu.ops import frontend as jfe
from tensorflowasr_tpu.ops.pallas_frontend import (
    log_mel_spectrogram_pallas,
    power_spectrogram_pallas,
)
from tensorflowasr_tpu_torch.kernels import build
from tensorflowasr_tpu_torch.ops import frontend as tfe
from tensorflowasr_tpu_torch.ops import log_mel_spectrogram as k1b
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
    # K1b's staged mel weights count against the block's shared memory
    w_smem = k1b.mel_bands(tfe._frontend_constants(cfg)[1]).weights.size
    staged = k1.launch_plan(b, t, cfg.hop, lo, 132, w_smem=w_smem)
    assert staged == plan and k1.smem_bytes(
        cfg.hop, plan.tile_frames, plan.groups, w_smem) <= k1.MAX_SMEM_BYTES
    assert k1.smem_bytes(160, 32, 4, w_smem) \
        == k1.smem_bytes(160, 32, 4) + 4 * w_smem


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


# ---------------------------------------------------------------------------
# K1b: the log-mel epilogues, walked on the host with the kernel's tables
# ---------------------------------------------------------------------------

def _thread_bins(t):
    """The bins thread t of a frame holds after the untangle (its pw[9]):
    t + 64 i and 512 - (t + 64 i) for i < 4, and bin 256 on thread 0."""
    bins = []
    for i in range(4):
        bins += [t + 64 * i, 512 - (t + 64 * i)]
    return bins + ([256] if t == 0 else [])


def _row_max_pass(power, tile_frames, groups):
    """The max epilogue: each thread's running max over its bins of its
    group's frames of the block's tile, a max over each warp (32 threads),
    then one atomicMax a warp on the float's bits as uint32 into a zeroed
    [B] buffer, in whatever order the blocks come."""
    b, n_frames, _ = power.shape
    row_max = np.zeros(b, np.uint32)
    rng = np.random.default_rng(0)
    blocks = [(row, f0) for row in range(b)
              for f0 in range(0, n_frames, tile_frames)]
    for idx in rng.permutation(len(blocks)):
        row, f0 = blocks[idx]
        for warp in range(groups * 2):
            run = np.float32(0)
            for tid in range(32 * warp, 32 * warp + 32):
                g, t = tid // 64, tid % 64
                frames = [f0 + fl for fl in range(g, tile_frames, groups)
                          if f0 + fl < n_frames]
                if frames:
                    run = max(run, power[row, frames][:, _thread_bins(t)]
                              .max())
            bits = np.float32(run).view(np.uint32)
            row_max[row] = max(row_max[row], bits)
    return row_max.view(np.float32)


def _fma(a, b, c):
    """fmaf: the product and the sum rounded once to f32."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _band_sum(db, weights, k_lo, n):
    """One band as the kernel's band_sum sums it: term j on partial sum
    j mod 4, then (p0 + p1) + (p2 + p3)."""
    acc = [np.float32(0)] * 4
    for j in range(n):
        acc[j % 4] = _fma(db[k_lo + j], weights[j], acc[j % 4])
    return np.float32(np.float32(acc[0] + acc[1]) + np.float32(acc[2]
                                                               + acc[3]))


def _schedule_walk(db, bands, n_mels):
    """The mel bands of one dB row as the kernel forms them: slot by slot
    each of the 64 threads sums its piece (``_band_sum``), then a thread
    whose code is 2 m writes its sum to band m, one whose code is 2 m + 1
    its sum plus that of thread t ^ 16 (the second half). Every band is
    written exactly once."""
    sched = bands.schedule
    out = np.full(n_mels, np.nan, np.float32)
    for slot in range(sched.shape[0]):
        k_lo, n, off, code = sched[slot]
        acc = [_band_sum(db, bands.weights[off[t]:], k_lo[t], n[t])
               for t in range(64)]
        for t in range(64):
            if code[t] >= 0:
                m = code[t] >> 1
                assert np.isnan(out[m])
                out[m] = acc[t] + acc[t ^ 16] if code[t] & 1 else acc[t]
    assert not np.isnan(out).any()
    return out


def _log_mel_emulation(wav, cfg, tile_frames, groups, fb):
    """K1b as the kernel computes it: K1's FFT passes (the emulation
    above), for 'same' the max pass (kPowerMax), then per frame the dB
    (log2 times 10 log10(2), against the row's max) of each bin written
    into the frame's row by the 64 threads' bin map (every bin exactly
    once), and the bands formed by the schedule (``_schedule_walk``)."""
    power = _kernel_emulation(wav, cfg, tile_frames)
    bands = k1b.mel_bands(fb)
    n_mels = fb.shape[1]
    amin = np.float32(1e-10)
    scale, ref, floor = _db_terms(power, cfg, tile_frames, groups)
    out = np.zeros(power.shape[:2] + (n_mels,), np.float32)
    for row in range(power.shape[0]):
        for f in range(power.shape[1]):
            db = np.full(513, np.nan, np.float32)
            for t in range(64):
                for k in _thread_bins(t):
                    assert np.isnan(db[k])
                    db[k] = max(scale * np.log2(max(power[row, f, k], amin))
                                - ref[row], floor)
            assert not np.isnan(db).any()
            out[row, f] = _schedule_walk(db, bands, n_mels)
    return out


def _db_terms(power, cfg, tile_frames, groups):
    """The dB's scale, each row's reference level and the floor as the
    kernels take them: 'same' against the max pass's row max."""
    if cfg.padding == "same":
        scale = np.float32(10.0 * np.log10(2.0))
        peak = _row_max_pass(power, tile_frames, groups)
        ref = scale * np.log2(np.maximum(peak, np.float32(1e-10)))
        return scale, ref, np.float32(-cfg.dynamic_range_db)
    return (np.float32(np.log10(2.0)), np.zeros(power.shape[0], np.float32),
            np.float32(-np.inf))


def _dense_walk(db, w):
    """dense_mel_kernel's sums: rows [R, 513] of dB times a given [513,
    n_mels] matrix, each output one fmaf a term in the order of k (the
    steps' zero padding past bin 512 adds nothing)."""
    acc = np.zeros((db.shape[0], w.shape[1]), np.float32)
    for k in range(db.shape[1]):
        acc = (np.float64(db[:, k, None]) * np.float64(w[k])
               + np.float64(acc)).astype(np.float32)
    return acc


def _dense_emulation(wav, cfg, tile_frames, groups, w):
    """K1b with a given matrix: K1 writes the power (and for 'same' each
    row's max), then dense_mel_kernel takes the dB of each staged power
    and sums the product (``_dense_walk``)."""
    power = _kernel_emulation(wav, cfg, tile_frames)
    scale, ref, floor = _db_terms(power, cfg, tile_frames, groups)
    db = np.maximum(scale * np.log2(np.maximum(power, np.float32(1e-10)))
                    - ref[:, None, None], floor).astype(np.float32)
    b, n_frames, _ = power.shape
    return _dense_walk(db.reshape(b * n_frames, 513), w).reshape(
        b, n_frames, w.shape[1])


def _pieces(sched):
    """{band: [(slot, lane, k_lo, n, off, code)]} of a schedule."""
    out = {}
    for slot in range(sched.shape[0]):
        for lane in range(sched.shape[2]):
            k_lo, n, off, code = sched[slot, :, lane]
            if n or code >= 0:
                m = code >> 1 if code >= 0 else sched[slot, 3, lane ^ 16] >> 1
                out.setdefault(m, []).append((slot, lane, k_lo, n, off, code))
    return out


@pytest.mark.parametrize("sample_rate,n_mels", [
    (16000, 80), (8000, 80), (16000, 20), (16000, 40)])
def test_mel_bands_are_the_exact_nonzero_ranges(sample_rate, n_mels):
    """The schedule covers each band's exact nonzero range once, in one
    piece or two halves on lanes l and l ^ 16 of one slot (the lower lane
    writes); the staged weights are the basis's nonzeros; the runs are an
    odd number of floats apart; and the warps' work is even."""
    fb = tfe.mel_filterbank(sample_rate, 1024, n_mels)
    np.testing.assert_array_equal(
        fb, jfe.mel_filterbank(sample_rate, 1024, n_mels))
    bands = k1b.mel_bands(fb)
    sched = bands.schedule
    assert sched.dtype == np.int32 and sched.shape[1:] == (4, 64)
    lo, hi = k1b.band_ranges(fb)
    pieces = _pieces(sched)
    assert sorted(pieces) == list(range(n_mels))
    covered = np.zeros(bands.weights.size, bool)
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        assert (lo[m], hi[m]) == (nz[0], nz[-1] + 1)
        got = pieces[m]
        if len(got) == 2:
            (s0, l0, k0, n0, _, c0), (s1, l1, k1_, n1, _, c1) = got
            assert s0 == s1 and l1 == l0 + 16 and l0 % 32 < 16
            assert (c0, c1) == (2 * m + 1, -1) and k1_ == k0 + n0
        else:
            assert len(got) == 1 and got[0][5] == 2 * m
        assert got[0][2] == lo[m] and sum(p[3] for p in got) == hi[m] - lo[m]
        for slot, lane, k_lo, n, off, code in got:
            at = off + np.arange(n)
            np.testing.assert_array_equal(bands.weights[at],
                                          fb[k_lo:k_lo + n, m])
            assert not covered[at].any()
            covered[at] = True
    assert not bands.weights[~covered].any()
    assert np.count_nonzero(bands.weights) == np.count_nonzero(fb)
    assert bands.weights.size <= k1b.W_SMEM_MAX
    # banks (4-byte words mod 32) the 32 threads of a warp read together at
    # term j of a slot: the weights' runs are an odd number of floats apart
    # within a slot, so those are distinct; the dB row's reads, at
    # k_lo + j, meet at most 2-way where the halving points let them
    def banks(s, w, row):
        k = sched[s, row, 32 * w:32 * w + 32]
        n = sched[s, 1, 32 * w:32 * w + 32]
        return [collections.Counter(int(k[i] + j) % 32 for i in range(32)
                                    if j < n[i]) for j in range(n.max())]
    for s in range(sched.shape[0]):
        for w in range(2):
            assert all(max(c.values()) == 1 for c in banks(s, w, 2))
            if (sample_rate, n_mels) == (16000, 80):
                assert all(max(c.values()) <= 2 for c in banks(s, w, 0))
    # a warp's longest pieces, summed over the slots
    warp_rows = [sum(int(sched[s, 1, 32 * w:32 * w + 32].max())
                     for s in range(sched.shape[0])) for w in range(2)]
    # ... against one whole band a thread (bands t, t + 64, ...)
    whole = [sum(max([hi[m] - lo[m] for m in range(n_mels)
                      if m // 64 == s and (m % 64) // 32 == w], default=0)
                 for s in range(-(-n_mels // 64))) for w in range(2)]
    assert max(warp_rows) <= max(whole)
    if (sample_rate, n_mels) == (16000, 80):
        # the shipped basis: 1001 nonzeros of 41,040, no bin in 3 bands;
        # the warps' rows 25 and 16, where one band a thread took 43 and 21
        assert np.count_nonzero(fb) == 1001
        assert (np.count_nonzero(fb, axis=1) <= 2).all()
        assert warp_rows == [25, 16]


@pytest.mark.parametrize("dense", [False, True])
def test_banded_sum_equals_dense_matmul(dense):
    """The kernel's schedule walk on random dB rows, and for a given dense
    matrix the dense kernel's walk, equals ``db @ fb`` to f32 rounding
    (rtol 1e-5, atol 1e-4 on sums of |db| <= 100 times weights <= 0.05):
    skipping exact zeros and halving bands change only the order of the
    terms."""
    fb = tfe.mel_filterbank(16000, 1024, 80)
    rng = np.random.default_rng(3)
    db = rng.uniform(-100, 0, (16, 513)).astype(np.float32)
    if dense:
        fb = fb + (rng.standard_normal(fb.shape) * 1e-3).astype(np.float32)
        got = _dense_walk(db, fb)
    else:
        bands = k1b.mel_bands(fb)
        got = np.array([_schedule_walk(row, bands, 80) for row in db])
    want = db.astype(np.float64) @ fb.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got, db @ fb, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("padding,t,tile_frames,groups", [
    ("same", 16077, 32, 4), ("same", 4000, 2, 2), ("same", 100, 1, 1),
    ("valid", 2560 * 3, 2, 2), ("valid", 4011, 16, 4),
])
def test_log_mel_epilogue_matches_xla_pallas_and_plain(padding, t,
                                                       tile_frames, groups):
    """K1b's two passes ('same': the max pass, then dB against it) and its
    dB row and band walk, emulated with the kernel's thread maps and band
    tables, against JAX's ``log_mel_spectrogram``, the Pallas kernel and
    the port's plain version, within LOGMEL_TOL. Row 1 is all zeros: every
    bin sits at amin, so 'same' gives dB 0 - 0 = 0 and log-mel 0, as
    ``amplitude_to_db`` does."""
    jcfg, tcfg = _cfgs(padding)
    wav = _wav(t=t, seed=t + 1)
    wav[1] = 0.0
    fb = tfe._frontend_constants(tcfg)[1]
    got = _log_mel_emulation(wav, tcfg, tile_frames, groups, fb)
    assert got.shape == (2, -(-t // 160), 80)
    plain = tfe.log_mel_spectrogram(torch.from_numpy(wav), tcfg).numpy()
    xla = np.asarray(jfe.log_mel_spectrogram(wav, jcfg))
    pallas = np.asarray(log_mel_spectrogram_pallas(wav, jcfg,
                                                   interpret=True))
    for want in (plain, xla, pallas):
        np.testing.assert_allclose(got, want, **LOGMEL_TOL)
    if padding == "same":
        np.testing.assert_array_equal(got[1], 0.0)
        np.testing.assert_array_equal(xla[1], 0.0)
        # the max pass gives the row's largest power, whatever the order
        power = _kernel_emulation(wav, tcfg, tile_frames)
        np.testing.assert_array_equal(
            _row_max_pass(power, tile_frames, groups), power.max(axis=(1, 2)))
    else:
        np.testing.assert_allclose(
            got[1], np.broadcast_to(np.log10(1e-10) * fb.sum(0), got[1].shape),
            rtol=1e-6)


def _trainable_basis(seed=5):
    fb = tfe.mel_filterbank(16000, 1024, 80)
    rng = np.random.default_rng(seed)
    return (fb + rng.uniform(0, 2e-3, fb.shape)).astype(np.float32)


@pytest.mark.parametrize("padding", ["same", "valid"])
def test_log_mel_with_trainable_weights_matches_xla_and_pallas(padding):
    """A given mel matrix (the trainable ``freq2mel``, dense after a step)
    replaces the Slaney basis on every path."""
    jcfg, tcfg = _cfgs(padding)
    wav = _wav(seed=11)
    w = _trainable_basis()
    xla = np.asarray(jfe.log_mel_spectrogram(wav, jcfg, jnp.asarray(w)))
    pallas = np.asarray(log_mel_spectrogram_pallas(
        wav, jcfg, mel_weights=jnp.asarray(w), interpret=True))
    got = tfe.log_mel_spectrogram(torch.from_numpy(wav), tcfg,
                                  mel_weights=torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, xla, **LOGMEL_TOL)
    np.testing.assert_allclose(got, pallas, **LOGMEL_TOL)
    assert np.abs(got - tfe.log_mel_spectrogram(
        torch.from_numpy(wav), tcfg).numpy()).max() > 0.1


@pytest.mark.parametrize("padding,t,tile_frames,groups", [
    ("same", 16077, 32, 4), ("same", 4000, 2, 2), ("valid", 4011, 16, 4),
])
def test_dense_mel_kernel_matches_xla_and_pallas(padding, t, tile_frames,
                                                 groups):
    """K1b with a given (trainable) matrix, emulated: K1's power and row
    max, then the dense kernel's dB and product, against JAX's
    ``log_mel_spectrogram`` and the Pallas kernel with the same
    ``mel_weights`` and the port's plain version, within LOGMEL_TOL. Row 1
    is all zeros: log-mel 0 for 'same', log10(1e-10) times each column's
    sum for 'valid'."""
    jcfg, tcfg = _cfgs(padding)
    wav = _wav(t=t, seed=t + 2)
    wav[1] = 0.0
    w = _trainable_basis(seed=7)
    got = _dense_emulation(wav, tcfg, tile_frames, groups, w)
    assert got.shape == (2, -(-t // 160), 80)
    xla = np.asarray(jfe.log_mel_spectrogram(wav, jcfg, jnp.asarray(w)))
    pallas = np.asarray(log_mel_spectrogram_pallas(
        wav, jcfg, mel_weights=jnp.asarray(w), interpret=True))
    plain = tfe.log_mel_spectrogram(torch.from_numpy(wav), tcfg,
                                    mel_weights=torch.from_numpy(w)).numpy()
    for want in (plain, xla, pallas):
        np.testing.assert_allclose(got, want, **LOGMEL_TOL)
    if padding == "same":
        np.testing.assert_array_equal(got[1], 0.0)
    else:
        np.testing.assert_allclose(
            got[1], np.broadcast_to(np.log10(1e-10) * w.sum(0), got[1].shape),
            rtol=1e-5)


@pytest.mark.parametrize("padding", ["same", "valid"])
def test_mel_weight_gradient_matches_jax(padding):
    """The gradient of sum(log-mel * cotangent) with respect to the mel
    matrix, on a noise wav (the dB's 1 / power makes near-silent frames
    amplify rounding), against ``jax.grad`` of JAX's function: within 1e-5
    of the gradient's largest entry for 'same', 5e-5 for 'valid', whose
    left pad of 1023 zeros leaves its first frames near-silent (frame 0
    holds one sample, under the window's tail), so that the two
    frameworks' DFT rounding reaches the log unfloored (2.3e-5 seen)."""
    jcfg, tcfg = _cfgs(padding)
    wav = _wav(seed=12, t=8000)
    w = _trainable_basis(seed=6)
    n_frames = -(-8000 // 160)
    cot = np.random.default_rng(13).standard_normal(
        (2, n_frames, 80)).astype(np.float32)

    def f(weights):
        return jnp.sum(jfe.log_mel_spectrogram(wav, jcfg, weights) * cot)

    want = np.asarray(jax.grad(f)(jnp.asarray(w)))
    weights = torch.from_numpy(w).requires_grad_()
    (tfe.log_mel_spectrogram(torch.from_numpy(wav), tcfg,
                             mel_weights=weights)
     * torch.from_numpy(cot)).sum().backward()
    got = weights.grad.numpy()
    assert got.shape == (513, 80) and np.abs(want).max() > 1.0
    rel = 1e-5 if padding == "same" else 5e-5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def test_log_mel_wrapper_refuses_cpu_tensors_and_other_devices():
    _, cfg = _cfgs("valid")
    wav = torch.zeros(1, 1600)
    tables = tfe._kernel_tables(cfg, torch.device("cpu"))
    sched, weights = tfe._kernel_bands(cfg, torch.device("cpu"))
    assert sched.dtype == torch.int32 and tuple(sched.shape) == (2, 4, 64)
    np.testing.assert_array_equal(
        weights.numpy(),
        k1b.mel_bands(tfe._frontend_constants(cfg)[1]).weights)
    for same in (False, True):
        with pytest.raises(ValueError, match="CUDA tensor"):
            k1b.log_mel_spectrogram_cuda(wav, tables, weights, 80, cfg.hop,
                                         0, sched=sched, same=same)
        with pytest.raises(ValueError, match="CUDA tensor"):
            k1b.log_mel_spectrogram_cuda(wav, tables, torch.zeros(513, 80),
                                         80, cfg.hop, 0, same=same)
    with pytest.raises(ValueError, match="unsupported device"):
        tfe.log_mel_spectrogram(torch.zeros(1, 1600, device="meta"), cfg)
    assert k1b.log_mel_spectrogram_cuda.launches == 0
    assert k1.power_spectrogram_cuda.launches == 0
