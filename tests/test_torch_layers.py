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


def randomize(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.standard_normal(x.shape) * 0.2).astype(np.float32)
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
          tl.ConformerBlock(D, 0.5, HEAD_SIZE, HEADS, 8), x_of(2, 13, D))


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
          tl.RBlock(D, 0.5, HEAD_SIZE, HEADS, 8),
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
    bn = tl.BatchNorm(D)
    with pytest.raises(NotImplementedError, match="not ported"):
        bn.train()(torch.zeros(1, 2, D))
