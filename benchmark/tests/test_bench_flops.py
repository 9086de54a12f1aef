"""The operation and byte counts against hand counts."""

import pytest

import tiny  # noqa: F401
from benchlib import flops


def test_block_by_hand():
    # t = 3 positions, d = 2, k = 4: FF 2 x (2*3*2*8 + 2*3*8*2) = 384;
    # attention 2*3*4*2 + 2*3*4*2 + 4*3*3*2 = 168; conv: pointwise 2*3*2*4,
    # depthwise 2*3*2*4, pointwise 2*3*2*4, pointwise 2*3*4*2 = 192
    assert flops._block(3, 2, 4) == 384 + 168 + 192


def test_translator_block_by_hand():
    # queries t = 1, keys and values from enc_t = 5: q, out 2 x 2*1*4;
    # k, v 2 x 2*5*4; scores and sum 4*1*5*2
    ff, conv = 128, 64
    assert flops._block(1, 2, 4, enc_t=5) == ff + 16 + 80 + 40 + conv


def test_encoder_frames():
    assert flops.encoder_frames(64000) == 100
    assert flops.encoder_frames(7680) == 12
    assert flops.encoder_frames(1) == 1


def test_train_is_three_forwards():
    m = dict(dmodel=4, num_blocks=1, kernel_size=2, sample_rate=16000,
             stride_ms=10, reduction_factor=4, num_feature_bins=8,
             ctcdecoder_num_blocks=1, ctcdecoder_kernel_size=2,
             translator_num_blocks=1, translator_kernel_size=2)
    t = flops.encoder_frames(6400)
    fwd = flops.encoder(2, 6400, m) + flops.ctc_head(2, t, m, 5) \
        + flops.translator(2, 9, t, m, 7) + flops.translator(2, t, t, m, 7)
    assert flops.train(2, 6400, 4, m, 5, 7) == 3 * fwd


def test_log_mel_matches_the_recorded_bound():
    """B = 128 x 7 s: 2.0155e9 FLOP and a 0.0301 ms bound at 67 TFLOP/s,
    the figures the port's bring-up reckoned for K1b."""
    flop, nbytes = flops.log_mel(128, 112000)
    assert flops.mel_nonzeros() == 1001
    assert flop == pytest.approx(2.0155e9, rel=1e-4)
    assert flop / 67e12 * 1e3 == pytest.approx(0.0301, abs=5e-5)
    assert nbytes == 4 * 128 * 112000 + 4 * 128 * 700 * 80 + 4 * 1001


def test_log_mel_by_hand():
    flop, nbytes = flops.log_mel(1, 320)           # 2 frames
    per_frame = 1024 + 16390 + 6 * 513 + 2 * 1001
    assert flop == 2 * per_frame
    assert nbytes == 4 * 320 + 4 * 2 * 80 + 4 * 1001
