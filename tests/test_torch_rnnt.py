"""The port's ``rnnt_loss`` against the full-lattice numpy reference of
``tests/test_rnnt.py`` and against the JAX package's, loss and gradient,
on numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops.rnnt import rnnt_loss as jax_rnnt_loss
from tensorflowasr_tpu_torch.ops.rnnt import rnnt_loss
from tests.test_rnnt import np_rnnt_loss


def _case(seed, b, t, u, v, t_lens, u_lens):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, u + 1, v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    return (logits, labels, np.asarray(t_lens, np.int32),
            np.asarray(u_lens, np.int32))


def _port(logits, labels, t_lens, u_lens, blank=0):
    return rnnt_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                     torch.from_numpy(t_lens), torch.from_numpy(u_lens),
                     blank=blank)


def test_rnnt_matches_numpy():
    logits, labels, t_lens, u_lens = _case(0, 3, 6, 4, 5, [6, 5, 3],
                                           [4, 2, 3])
    got = _port(logits, labels, t_lens, u_lens).numpy()
    for i in range(3):
        want = np_rnnt_loss(logits[i], labels[i], int(t_lens[i]),
                            int(u_lens[i]), 0)
        # f32 log-space sums against a float64 DP
        np.testing.assert_allclose(got[i], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("blank", [0, 4])
def test_rnnt_loss_and_gradient_match_jax(blank):
    logits, labels, t_lens, u_lens = _case(1, 4, 7, 5, 6, [7, 4, 1, 6],
                                           [5, 2, 0, 3])
    labels[labels == blank] = 1        # no label is the blank

    def total(lg):
        return jnp.sum(jax_rnnt_loss(lg, jnp.asarray(labels),
                                     jnp.asarray(t_lens),
                                     jnp.asarray(u_lens), blank=blank)
                       * jnp.arange(1.0, 5.0))

    want_loss = np.asarray(jax_rnnt_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(t_lens),
        jnp.asarray(u_lens), blank=blank))
    want_grad = np.asarray(jax.grad(total)(jnp.asarray(logits)))
    x = torch.from_numpy(logits).requires_grad_()
    loss = rnnt_loss(x, torch.from_numpy(labels), torch.from_numpy(t_lens),
                     torch.from_numpy(u_lens), blank=blank)
    (loss * torch.arange(1.0, 5.0)).sum().backward()
    # the same f32 recursion; sums in another order (1e-6 seen)
    np.testing.assert_allclose(loss.detach().numpy(), want_loss, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())


def test_rnnt_gradient_finite_and_nonzero():
    logits, labels, _, _ = _case(1, 2, 5, 3, 4, [5, 4], [3, 2])
    x = torch.from_numpy(logits).requires_grad_()
    loss = rnnt_loss(x, torch.from_numpy(labels), torch.tensor([5, 4]),
                     torch.tensor([3, 2]))
    loss.sum().backward()
    g = x.grad.numpy()
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0
    # the padded frames of example 1 (t >= 4) receive no gradient
    assert np.abs(g[1, 4:]).sum() < 1e-5


def test_rnnt_perfect_alignment_low_loss():
    t, u, v, blank = 4, 2, 3, 0
    labels = np.asarray([[1, 2]], np.int32)
    logits = np.full((1, t, u + 1, v), -20.0, np.float32)
    logits[0, 0, 0, 1] = 20.0
    logits[0, 0, 1, 2] = 20.0
    for i in range(t):
        logits[0, i, 2, blank] = 20.0
    loss = float(_port(logits, labels, np.asarray([t], np.int32),
                       np.asarray([u], np.int32), blank=blank)[0])
    assert loss < 0.01, loss
