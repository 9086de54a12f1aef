"""Greedy CTC decoding in the port against ``tensorflowasr_tpu.ops.ctc``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops import ctc as jctc
from tensorflowasr_tpu_torch.ops import ctc as tctc

BLANK = 5

# repeats, blanks between repeats, a row of blanks only, a row whose valid
# length cuts a run, length 0
IDS = np.array([
    [1, 1, 5, 1, 2, 2, 5, 5, 3, 3],
    [5, 5, 5, 5, 5, 5, 5, 5, 5, 5],
    [4, 4, 4, 2, 2, 1, 0, 0, 0, 0],
    [0, 1, 0, 1, 5, 0, 5, 0, 2, 2],
    [3, 3, 3, 3, 3, 3, 3, 3, 3, 3],
], np.int32)
LENGTHS = np.array([10, 10, 4, 9, 0], np.int32)


def _both(jfn, tfn, *args, **kw):
    want = [np.asarray(a) for a in jfn(*map(jnp.asarray, args), **kw)]
    got = [a.numpy() for a in tfn(*map(torch.from_numpy, args), **kw)]
    return want, got


def test_collapse_and_remove_blank():
    want, got = _both(jctc.collapse_and_remove_blank,
                      tctc.collapse_and_remove_blank, IDS, LENGTHS,
                      blank_id=BLANK)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][0, :4], [1, 1, 2, 3])
    np.testing.assert_array_equal(got[1], [4, 0, 2, 7, 0])


def test_merge_repeated():
    want, got = _both(jctc.merge_repeated, tctc.merge_repeated, IDS, LENGTHS)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pad_id", [0, 7])
def test_compact_kept_is_stable(pad_id):
    keep = IDS % 2 == 1
    want, got = _both(jctc.compact_kept, tctc.compact_kept, IDS, keep,
                      pad_id=pad_id)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_ctc_greedy_decode_with_ties():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 12, BLANK + 1)).astype(np.float32)
    # exact ties go to the first index in both frameworks
    logits[0, :3] = 0.0
    logits[1, 4, 2] = logits[1, 4, 4] = 9.0
    lengths = np.array([12, 7, 1, 11], np.int32)
    want, got = _both(jctc.ctc_greedy_decode, tctc.ctc_greedy_decode,
                      logits, lengths, blank_id=BLANK)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
