"""Operation and byte counts: the model FLOPs of a ConformerCTC step and the
log-mel kernel's (K1b's) operations and bytes.

Model FLOPs count 2 a multiply-add of every matrix product and convolution
at the padded shape the step runs (norms, activations, softmax and the
losses are left out, as MFU counts them); a train step is three forwards
(the backward's two products a forward product). The log-mel counts, a
frame of n_fft = 1024: the window (1024 multiplies), a split-radix real FFT
(16,390 FLOP), the squares (3 a bin), the dB (3 a bin) and the banded mel
product (2 a nonzero of the Slaney basis); its bytes are the f32 wav read
once, the f32 log-mel written once and the basis's nonzeros read once.
"""

from __future__ import annotations

import numpy as np

N_FFT = 1024
FFT_FLOP = 16390


def _block(t: int, d: int, k: int, enc_t: int = 0) -> int:
    """One Conformer block over t positions of width d (depthwise kernel
    k); ``enc_t`` > 0 makes it a translator block whose keys and values are
    the enc_t encoder frames."""
    ff = 2 * (2 * t * d * 4 * d + 2 * t * 4 * d * d)
    kv_t = enc_t or t
    attn = 2 * t * d * d * 2 + 2 * kv_t * d * d * 2 + 2 * 2 * t * kv_t * d
    conv = 2 * t * d * 2 * d + 2 * t * d * k + 2 * t * d * 2 * d \
        + 2 * t * 2 * d * d
    return ff + attn + conv


def encoder_frames(samples: int, hop: int = 160, rf: int = 4) -> int:
    mel = -(-samples // hop)
    return -(-(-(-mel // (rf // 2))) // 2)


def encoder(b: int, samples: int, m: dict) -> int:
    d, k = m["dmodel"], m["kernel_size"]
    hop = m["sample_rate"] * m["stride_ms"] // 1000
    mel = -(-samples // hop)
    t1, f1 = -(-mel // (m["reduction_factor"] // 2)), -(
        -m["num_feature_bins"] // 2)
    t2, f2 = -(-t1 // 2), -(-f1 // 2)
    sub = 2 * d * 9 * t1 * f1 + 2 * d * 9 * d * t2 * f2 + 2 * t2 * f2 * d * d
    return b * (sub + m["num_blocks"] * _block(t2, d, k))


def ctc_head(b: int, t: int, m: dict, n_phone: int) -> int:
    d = m["dmodel"]
    return b * (2 * t * d * d + m["ctcdecoder_num_blocks"] * _block(
        t, d, m["ctcdecoder_kernel_size"]) + 2 * t * d * n_phone)


def translator(b: int, u: int, enc_t: int, m: dict, n_char: int) -> int:
    d = m["dmodel"]
    return b * (m["translator_num_blocks"] * _block(
        u, d, m["translator_kernel_size"], enc_t) + 2 * u * d * n_char)


def predict(b: int, samples: int, m: dict, n_phone: int, n_char: int,
            translator_pad: int = 10) -> int:
    """``predict_step``: encoder, CTC head, translator on T' + pad ids."""
    t = encoder_frames(samples, m["sample_rate"] * m["stride_ms"] // 1000,
                       m["reduction_factor"])
    return encoder(b, samples, m) + ctc_head(b, t, m, n_phone) + translator(
        b, t + translator_pad, t, m, n_char)


def train(b: int, samples: int, phone_cap: int, m: dict, n_phone: int,
          n_char: int) -> int:
    """A train step: 3 x (encoder, CTC head, the translator on the label
    phones + 5 and on the T' decoded ids)."""
    t = encoder_frames(samples, m["sample_rate"] * m["stride_ms"] // 1000,
                       m["reduction_factor"])
    fwd = encoder(b, samples, m) + ctc_head(b, t, m, n_phone) + translator(
        b, phone_cap + 5, t, m, n_char) + translator(b, t, t, m, n_char)
    return 3 * fwd


def mel_nonzeros(sample_rate: int = 16000, n_mels: int = 80) -> int:
    from reference.frontend import mel_basis
    return int(np.count_nonzero(mel_basis(sample_rate, N_FFT, n_mels)))


def log_mel(b: int, samples: int, hop: int = 160, n_mels: int = 80,
            sample_rate: int = 16000) -> tuple:
    """(FLOP, bytes) of one log-mel call on [b, samples]."""
    frames = b * -(-samples // hop)
    bins = N_FFT // 2 + 1
    nnz = mel_nonzeros(sample_rate, n_mels)
    flop = frames * (N_FFT + FFT_FLOP + 3 * bins + 3 * bins + 2 * nnz)
    nbytes = 4 * b * samples + 4 * frames * n_mels + 4 * nnz
    return flop, nbytes
