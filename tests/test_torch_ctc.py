"""The CTC loss and greedy CTC decoding in the port against
``tensorflowasr_tpu.ops.ctc``."""

import jax
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


def _ctc_case(seed=0):
    """Ragged lengths, blank last; row 2 is infeasible (3 frames for 5
    labels), row 3 has an empty label, row 4 repeats a label (needs a blank
    between)."""
    rng = np.random.default_rng(seed)
    b, t, v, l = 5, 20, BLANK + 1, 6
    logits = (rng.standard_normal((b, t, v)) * 3).astype(np.float32)
    labels = rng.integers(0, BLANK, (b, l)).astype(np.int32)
    labels[4, :3] = [2, 2, 1]
    logit_lengths = np.array([20, 15, 3, 20, 11], np.int32)
    label_lengths = np.array([6, 4, 5, 0, 3], np.int32)
    return logits, logit_lengths, labels, label_lengths


@pytest.mark.parametrize("prob_floor", [0.0, 1e-7, 1e-2])
def test_ctc_loss_value_and_gradient_match_jax(prob_floor):
    logits, logit_lengths, labels, label_lengths = _ctc_case()

    def jloss(x):
        return jctc.ctc_loss(x, jnp.asarray(logit_lengths),
                             jnp.asarray(labels), jnp.asarray(label_lengths),
                             blank_id=BLANK, prob_floor=prob_floor)

    want = np.asarray(jloss(jnp.asarray(logits)))
    want_grad = np.asarray(jax.grad(lambda x: jloss(x).sum())(
        jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    got = tctc.ctc_loss(x, torch.from_numpy(logit_lengths),
                        torch.from_numpy(labels),
                        torch.from_numpy(label_lengths), blank_id=BLANK,
                        prob_floor=prob_floor)
    got.sum().backward()
    assert got.shape == (5,) and got.dtype == torch.float32
    # f32 log-space recursions over 20 frames in two orders of summation:
    # losses up to ~60, measured difference ~2e-5
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0, atol=1e-4)
    # the infeasible row: loss 0 and gradient 0, in both
    assert got[2].item() == 0.0 and want[2] == 0.0
    assert torch.count_nonzero(x.grad[2]) == 0
    assert np.count_nonzero(want_grad[2]) == 0
    # frames past an example's length get no gradient
    assert torch.count_nonzero(x.grad[1, 15:]) == 0
    assert got[3].item() > 0          # the empty label: all-blank path


def test_ctc_loss_floor_caps_a_confidently_wrong_frame():
    """One frame that puts all its mass on a wrong class costs ~16.1 with
    the 1e-7 floor (-log 1e-7) where the clean CTC charges the full logit
    gap."""
    logits = np.zeros((1, 1, BLANK + 1), np.float32)
    logits[0, 0, 0] = 60.0
    args = (torch.tensor([1]), torch.tensor([[3]]), torch.tensor([1]))
    clean = tctc.ctc_loss(torch.from_numpy(logits), *args, blank_id=BLANK)
    floored = tctc.ctc_loss(torch.from_numpy(logits), *args, blank_id=BLANK,
                            prob_floor=1e-7)
    assert clean.item() == pytest.approx(60.0, abs=1e-3)
    assert floored.item() == pytest.approx(-np.log(1e-7), abs=1e-3)


def test_ctc_loss_without_zero_infinity_keeps_the_infeasible_row():
    logits, logit_lengths, labels, label_lengths = _ctc_case(seed=1)
    got = tctc.ctc_loss(torch.from_numpy(logits),
                        torch.from_numpy(logit_lengths),
                        torch.from_numpy(labels),
                        torch.from_numpy(label_lengths), blank_id=BLANK,
                        zero_infinity=False)
    assert torch.isinf(got[2]) and torch.isfinite(got[[0, 1, 3, 4]]).all()
