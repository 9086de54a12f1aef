"""Model FLOPs of an E-Branchformer CTC's predict step, counted as
``benchlib/flops.py`` counts a Conformer's: 2 a multiply-add of every
matrix product and convolution at the padded shape the step runs (norms,
activations, the gate's product, softmax and the shift are left out).

An E-Branchformer block over t positions of width d (``block``), a batch
of b rows:

- two macaron FFNs, d -> U -> d: 2 x (2 t d U + 2 t U d) a row;
- attention: the q, k, v and output projections (4 x 2 t d^2 a row), the
  position projection of the 2t - 1 positions (2 (2t - 1) d^2, once a
  batch: the positions are the batch's), the content scores (2 t t d), the
  position scores before the shift (2 t (2t - 1) d) and the weighted sum
  of the values (2 t t d) a row;
- cgMLP: d -> C (2 t d C), the depthwise conv over C / 2 channels of
  kernel k_c (2 t (C / 2) k_c), C / 2 -> d (2 t (C / 2) d) a row;
- merge: the depthwise conv over 2d channels of kernel k_m (2 t 2d k_m)
  and 2d -> d (2 t 2d d) a row.

The front is the Conformer's conv subsampling; the heads are the Conformer
family's (``flops.ctc_head``, ``flops.translator``).
"""

from __future__ import annotations

from benchlib import flops


def block(b: int, t: int, m: dict) -> int:
    """One E-Branchformer block over a batch of b rows of t positions."""
    d, u, c = m["dmodel"], m["linear_units"], m["cgmlp_linear_units"]
    p = 2 * t - 1
    ffn = 2 * (2 * t * d * u + 2 * t * u * d)
    attn = 4 * 2 * t * d * d + 2 * t * t * d + 2 * t * p * d + 2 * t * t * d
    cgmlp = 2 * t * d * c + 2 * t * (c // 2) * m["cgmlp_conv_kernel"] \
        + 2 * t * (c // 2) * d
    merge = 2 * t * 2 * d * m["merge_conv_kernel"] + 2 * t * 2 * d * d
    return b * (ffn + attn + cgmlp + merge) + 2 * p * d * d


def front(b: int, samples: int, m: dict) -> int:
    """The conv subsampling: two 3x3 convs (strides (rf / 2, 2), (2, 2))
    and the Dense of the flattened frequency x channels."""
    d = m["dmodel"]
    hop = m["sample_rate"] * m["stride_ms"] // 1000
    mel = -(-samples // hop)
    t1, f1 = -(-mel // (m["reduction_factor"] // 2)), -(
        -m["num_feature_bins"] // 2)
    t2, f2 = -(-t1 // 2), -(-f1 // 2)
    return b * (2 * d * 9 * t1 * f1 + 2 * d * 9 * d * t2 * f2
                + 2 * t2 * f2 * d * d)


def frames(samples: int, m: dict) -> int:
    return flops.encoder_frames(samples,
                                m["sample_rate"] * m["stride_ms"] // 1000,
                                m["reduction_factor"])


def encoder(b: int, samples: int, m: dict) -> int:
    return front(b, samples, m) + m["num_blocks"] * block(
        b, frames(samples, m), m)


def predict(b: int, samples: int, m: dict, n_phone: int, n_char: int,
            translator_pad: int = 10) -> int:
    """``predict_step``: encoder, CTC head, translator on T' + pad ids."""
    t = frames(samples, m)
    return encoder(b, samples, m) + flops.ctc_head(b, t, m, n_phone) \
        + flops.translator(b, t + translator_pad, t, m, n_char)
