"""Each PyTorch Conformer layer against its flax counterpart.

Weights are drawn from a numpy seed in the flax layout and moved by
``models/convert.py``; inputs are numpy arrays handed to both. f32
throughout, so the outputs agree to summation order (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen

from tensorflowasr_tpu.models import layers as jl
from tensorflowasr_tpu_torch.models import layers as tl
from tensorflowasr_tpu_torch.models.convert import flatten, to_torch_names

torch.set_num_threads(2)

D, HEADS, HEAD_SIZE = 32, 2, 16


def randomize(shapes, seed, bias_scale=0.2):
    rng = np.random.default_rng(seed)

    def draw(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        scale = bias_scale if path[-1].key == "bias" else 0.2
        return (rng.standard_normal(x.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def check(flax_module, torch_module, *inputs, seed=0, atol=1e-5):
    """Same weights, same inputs -> same outputs."""
    shapes = jax.eval_shape(flax_module.init, jax.random.PRNGKey(0),
                            *inputs)
    variables = randomize(shapes, seed)
    want = np.asarray(jax.jit(flax_module.apply)(variables, *inputs))
    torch_module.load_state_dict(to_torch_names(flatten(variables)))
    with torch.no_grad():
        got = torch_module.eval()(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def x_of(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_glu():
    x = x_of(3, 5, 8)
    want = np.asarray(jl.glu(jnp.asarray(x)))
    got = tl.glu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,pads", [(8, (3, 4)), (7, (3, 3)), (32, (15, 16))])
def test_depthwise_conv1d(k, pads):
    # even K pads one more on the right (flax SAME); the kernel is applied
    # as a cross-correlation in both frameworks, so it is not flipped
    assert tl._same_pad(41, k, 1) == pads
    check(jl.DepthwiseConv1D(features=D, kernel_size=k),
          tl.DepthwiseConv1D(D, k), x_of(2, 41, D))


@pytest.mark.parametrize("t,f", [(37, 80), (38, 80), (41, 513), (1, 80)])
def test_conv_subsampling(t, f):
    """Odd T and odd F exercise the TF-style SAME pads (extra row on the
    bottom/right); F x C must merge with F major, as flax's reshape does."""
    check(jl.ConvSubsampling(odim=16, reduction_factor=4),
          tl.ConvSubsampling(16, f, 4), x_of(2, t, f, 1))


def test_ff_module():
    check(jl.FFModule(input_dim=D), tl.FFModule(D), x_of(2, 13, D))


def test_mhsa_module():
    # no mask and no positional encoding: every frame attends every frame
    check(jl.MHSAModule(head_size=HEAD_SIZE, num_heads=HEADS),
          tl.MHSAModule(D, HEAD_SIZE, HEADS), x_of(2, 13, D))


def test_conv_module():
    check(jl.ConvModule(input_dim=D, kernel_size=8),
          tl.ConvModule(D, 8), x_of(2, 13, D))


def test_conformer_block():
    check(jl.ConformerBlock(input_dim=D, head_size=HEAD_SIZE,
                            num_heads=HEADS, kernel_size=8),
          tl.ConformerBlock(D, 0.0, 0.5, HEAD_SIZE, HEADS, 8), x_of(2, 13, D))


def test_positional_encoding():
    np.testing.assert_array_equal(tl.positional_encoding(17, D),
                                  jl.positional_encoding(17, D))


def test_rmhsa_module():
    # PE is added before LN; the residual adds to the un-PE'd x; keys and
    # values both come from enc
    check(jl.RMHSAModule(head_size=HEAD_SIZE, num_heads=HEADS),
          tl.RMHSAModule(D, HEAD_SIZE, HEADS),
          x_of(2, 9, D), x_of(2, 13, D, seed=2))


def test_rblock():
    check(jl.RBlock(input_dim=D, head_size=HEAD_SIZE, num_heads=HEADS,
                    kernel_size=8),
          tl.RBlock(D, 0.0, 0.5, HEAD_SIZE, HEADS, 8),
          x_of(2, 9, D), x_of(2, 13, D, seed=2))


def test_norms_use_keras_epsilon():
    """LayerNorm and BatchNorm use 1e-3 (torch's default is 1e-5); inputs
    of small variance make the two epsilons visibly different."""
    x = x_of(2, 3, D) * 1e-2
    assert tl.LayerNorm(D).eps == 1e-3
    check(linen.LayerNorm(epsilon=1e-3), tl.LayerNorm(D), x)
    check(linen.BatchNorm(use_running_average=True, epsilon=1e-3),
          tl.BatchNorm(D), x)


def test_batchnorm_training_mode_raises():
    """Training-mode BatchNorm used to raise (inference-only port); it now
    normalizes with batch statistics. What still raises is a training-mode
    dropout that was given no generator to draw from."""
    bn = tl.BatchNorm(D).train()
    y = bn(torch.from_numpy(x_of(4, 6, D)) * 3 + 1)
    np.testing.assert_allclose(y.mean((0, 1)).detach().numpy(), 0, atol=1e-5)
    drop = tl.Dropout(0.5).train()
    with pytest.raises(RuntimeError, match="generator"):
        drop(torch.zeros(1, 2, D))


def check_training(flax_module, torch_module, *inputs, seed=0, atol=1e-5):
    """Training mode, dropout 0, same weights and inputs: the outputs, the
    gradient of sum(out * cotangent) with respect to the first input and the
    updated BatchNorm running statistics agree with flax
    (``mutable=["batch_stats"]``). f32; the difference is summation order.
    Batch statistics take the variance as E[x^2] - E[x]^2 in both
    frameworks, which loses digits where a channel's |mean| is many times its
    deviation; the biases are drawn small (0.02) so that the channels in
    front of the BatchNorm stay conditioned well enough for atol 1e-5."""
    shapes = jax.eval_shape(flax_module.init, jax.random.PRNGKey(0),
                            *inputs)
    variables = randomize(shapes, seed, bias_scale=0.02)
    cot = x_of(*inputs[0].shape[:-1], D, seed=9)

    def f(x):
        out, new = flax_module.apply(variables, x, *inputs[1:], True,
                                     mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, new["batch_stats"])

    (_, (want, want_stats)), want_grad = jax.jit(
        jax.value_and_grad(f, has_aux=True))(jnp.asarray(inputs[0]))
    torch_module.load_state_dict(to_torch_names(flatten(variables)))
    x = torch.from_numpy(inputs[0]).requires_grad_()
    got = torch_module.train()(x, *map(torch.from_numpy, inputs[1:]))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=0, atol=atol)
    stats = to_torch_names(flatten({"batch_stats": want_stats}))
    assert stats
    buffers = dict(torch_module.named_buffers())
    for name, value in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                   rtol=0, atol=atol, err_msg=name)
        # and they moved: the running statistics started elsewhere
        assert not np.allclose(
            value.numpy(),
            to_torch_names(flatten(variables))[name].numpy(), atol=1e-4)


def test_conv_module_training_matches_flax():
    # the first rows are "padding" (zeros): flax's BatchNorm counts them in
    # the batch statistics, and so does the port
    x = x_of(3, 13, D)
    x[1, 7:] = 0.0
    check_training(jl.ConvModule(input_dim=D, kernel_size=8),
                   tl.ConvModule(D, 8), x)


def test_conformer_block_training_matches_flax():
    check_training(jl.ConformerBlock(input_dim=D, head_size=HEAD_SIZE,
                                     num_heads=HEADS, kernel_size=8),
                   tl.ConformerBlock(D, 0.0, 0.5, HEAD_SIZE, HEADS, 8),
                   x_of(2, 13, D))


def test_rblock_training_matches_flax():
    check_training(jl.RBlock(input_dim=D, head_size=HEAD_SIZE,
                             num_heads=HEADS, kernel_size=8),
                   tl.RBlock(D, 0.0, 0.5, HEAD_SIZE, HEADS, 8),
                   x_of(2, 9, D), x_of(2, 13, D, seed=2))


def test_batchnorm_variance_is_biased_and_clipped():
    """The running variance takes the biased batch variance (torch's own
    batch_norm records the unbiased one), and a constant input, whose
    E[x^2] - E[x]^2 rounds below zero, gives variance 0 and finite output."""
    bn = tl.BatchNorm(D).train()
    x = torch.from_numpy(x_of(2, 5, D))
    bn(x)
    flat = x.reshape(-1, D)
    np.testing.assert_allclose(
        bn.running_var.numpy(),
        0.99 + 0.01 * flat.var(0, unbiased=False).numpy(), atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               0.01 * flat.mean(0).numpy(), atol=1e-6)
    out = bn(torch.full((2, 5, D), 1e3))
    assert torch.isfinite(out).all()


def test_dropout_is_identity_in_eval_and_at_rate_zero():
    x = torch.from_numpy(x_of(2, 7, D))
    assert tl.Dropout(0.3).eval()(x) is x
    assert tl.Dropout(0.0).train()(x) is x
    block = tl.ConformerBlock(D, 0.5, 0.5, HEAD_SIZE, HEADS, 8).eval()
    tl.init_weights_(block, torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(block(x), block(x))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    n = 200_000
    drop = tl.Dropout(rate).train()
    drop.generator = torch.Generator().manual_seed(3)
    y = drop(torch.ones(n))
    kept = y != 0
    # kept values are scaled by 1 / (1 - rate), exactly
    assert torch.all(y[kept] == 1.0 / (1.0 - rate))
    # the kept count is binomial(n, 1 - rate): within 3 sigma
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(int(kept.sum()) - n * (1 - rate)) < 3 * sigma


def test_dropout_mask_follows_the_generator_seed():
    block = tl.ConformerBlock(D, 0.3, 0.5, HEAD_SIZE, HEADS, 8).train()
    tl.init_weights_(block, torch.Generator().manual_seed(0))
    x = torch.from_numpy(x_of(2, 7, D))
    outs = []
    for seed in (5, 5, 6):
        tl.set_generator(block, torch.Generator().manual_seed(seed))
        with torch.no_grad():
            outs.append(block(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
