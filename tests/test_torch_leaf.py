"""The port's LEAF frontend (``mel_layer_type: leaf``) against the JAX
package's, from the same numpy-seeded weights: the host helpers, the filter
generators, PCEN, ``Leaf`` forward and gradients (with a length that is
not a whole number of hops, so the hand-made SAME padding of the strided
pooling is pinned), and a leaf ConformerCTC's outputs and train-step
gradients. f32 on both sides: values within 1e-5 of each output's (or
leaf's) largest entry unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import (
    BLANK,
    N_CHAR,
    N_PHONE,
    TINY,
    ZERO_GRADIENT,
    assert_leaves_close,
    make_batch,
    randomize,
    torch_leaves,
)
from tensorflowasr_tpu.models import conformer as jconf
from tensorflowasr_tpu.models import leaf as jleaf
from tensorflowasr_tpu.train import asr_trainer as jtrain
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.models import leaf as tleaf
from tensorflowasr_tpu_torch.train import asr_trainer as ttrain

torch.set_num_threads(2)

REL = 1e-5
# the whole model's gradients, as tests/test_torch_wav_model.py holds them
GRAD_REL = 5e-5
# LEAF's own gradients: PCEN's derivatives in delta and root are
# differences of nearly equal powers, and the preemphasis kernel's a sum of
# products over every sample that largely cancel, so f32 rounds them
# coarsely on both sides: a float64 run of the same Leaf puts the port and
# JAX alike 2e-5 to 4e-5 of a leaf's largest entry away (8e-5 seen between
# them, in the preemphasis kernel)
LEAF_GRAD_REL = 1e-4
# ... and inside the whole model, where PCEN's input is the trained
# encoder's gradient: 1.2e-4 (delta) and 2.4e-4 (root) seen
PCEN_GRAD_REL = 5e-4
PCEN_CANCELLING = ("pcen.delta", "pcen.root")
N_FILTERS = 16
SMALL = dict(TINY, num_blocks=1, translator_num_blocks=1, n_mels=N_FILTERS,
             mel_layer_type="leaf")


def close(got, want, rel=REL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


def perturbed(values, rng, scale=0.05):
    """Each LEAF parameter moved by a few per cent of itself (a random
    draw around 0 would clip every constraint, or make PCEN's base
    negative)."""
    return jax.tree.map(
        lambda x: (np.asarray(x) * (1 + scale * rng.standard_normal(
            np.shape(x)))).astype(np.float32), values)


def test_host_helpers_equal_jax():
    for args in ((40, 257, 16000, 30.0, 7800.0), (16, 257, 8000, 30.0,
                                                  3900.0)):
        np.testing.assert_array_equal(tleaf.linear_to_mel_weight_matrix(
            *args), jleaf.linear_to_mel_weight_matrix(*args))
    for args in ((80, 16000, 60.0, 7800.0), (16, 8000, 30.0, 3900.0)):
        np.testing.assert_array_equal(tleaf.gabor_params_from_mels(*args),
                                      jleaf.gabor_params_from_mels(*args))


def test_filters_match_jax():
    rng = np.random.default_rng(0)
    params = tleaf.gabor_params_from_mels(80, 16000, 60.0, 7800.0)
    # some centers and widths outside the constraint, on both sides
    params = (params * rng.uniform(0.5, 1.5, params.shape)).astype(
        np.float32)
    params[:3, 0] = [-0.1, 3.5, 1.0]
    params[3:5, 1] = [0.5, 200.0]
    want = np.array(jleaf.gabor_constraint(jnp.asarray(params), 401))
    got = tleaf.gabor_constraint(torch.from_numpy(params), 401)
    close(got, want, what="constraint")
    want_re, want_im = jleaf.gabor_filters_realimag(jnp.asarray(want), 401)
    got_re, got_im = tleaf.gabor_filters_realimag(torch.from_numpy(want),
                                                  401)
    close(got_re, want_re, what="real")
    close(got_im, want_im, what="imag")
    sigma = rng.uniform(0.0, 0.7, 16).astype(np.float32)
    close(tleaf.gaussian_lowpass_kernel(torch.from_numpy(sigma), 401),
          jleaf.gaussian_lowpass_kernel(jnp.asarray(sigma), 401),
          what="lowpass")


def test_pcen_forward_and_gradients_match_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(0.1, 2.0, (2, 20, 4)).astype(np.float32)
    jm = jleaf.PCEN(4)
    params = perturbed(jm.init(jax.random.PRNGKey(0), x)["params"], rng)
    params["alpha"][0] = 1.2          # clipped to 1 at call time
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def f(p, x):
        return jnp.sum(jm.apply({"params": p}, x) * cot)

    want = np.asarray(jm.apply({"params": params}, x))
    want_gp, want_gx = jax.grad(f, argnums=(0, 1))(params, x)
    tm = tleaf.PCEN(4)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    tx = torch.from_numpy(x).requires_grad_()
    got = tm(tx)
    close(got, want, what="pcen")
    (got * torch.from_numpy(cot)).sum().backward()
    close(tx.grad, want_gx, what="grad x")
    for k, p in tm.named_parameters():
        close(p.grad, want_gp[k], what=f"grad {k}")
    assert float(tm.alpha.grad[0]) == 0.0


@pytest.mark.parametrize("t", [3200, 3200 + 37], ids=["whole", "ragged"])
def test_leaf_forward_and_gradients_match_jax(t):
    rng = np.random.default_rng(2)
    jm = jleaf.Leaf(n_filters=N_FILTERS)
    wav = (rng.standard_normal((2, t)) * 0.1).astype(np.float32)
    params = perturbed(jm.init(jax.random.PRNGKey(0), wav)["params"], rng)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, wav))
    assert want.shape == (2, -(-t // 160), N_FILTERS)
    cot = rng.standard_normal(want.shape).astype(np.float32)
    want_grads = jax.jit(jax.grad(lambda p: jnp.sum(
        jm.apply({"params": p}, wav) * cot)))(params)

    tm = tleaf.Leaf(n_filters=N_FILTERS)
    state = convert.to_torch_names(convert.flatten(
        {"params": {"leaf": params}}))
    tm.load_state_dict({k[len("leaf."):]: v for k, v in state.items()})
    got = tm(torch.from_numpy(wav))
    close(got, want, what="leaf")
    (got * torch.from_numpy(cot)).sum().backward()
    grads = convert.to_torch_names(convert.flatten(
        {"params": {"leaf": jax.tree.map(np.asarray, want_grads)}}))
    for k, p in tm.named_parameters():
        w = grads[f"leaf.{k}"].numpy()
        assert np.abs(w).max() > 0, k
        close(p.grad, w, rel=LEAF_GRAD_REL, what=f"grad {k}")


def leaf_pair(seed):
    """(flax ConformerCTC with LEAF, variables, port model): the other
    leaves drawn as tests/test_torch_train.py draws them, LEAF's own
    perturbed around their initial values."""
    jcfg = jconf.ConformerConfig(**SMALL)
    jmodel = jconf.ConformerCTC(jcfg, N_PHONE, N_CHAR)
    wav, ids = jnp.zeros((1, 3200), jnp.float32), jnp.ones((1, 4), jnp.int32)
    variables = randomize(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                         wav, ids), seed)
    init = jleaf.Leaf(n_filters=N_FILTERS).init(jax.random.PRNGKey(0), wav)
    variables["params"]["encoder"]["mel_layer"]["leaf"] = perturbed(
        init["params"], np.random.default_rng(seed))
    tcfg = tconf.ConformerConfig(**SMALL)
    tmodel = tconf.ConformerCTC(tcfg, N_PHONE, N_CHAR)
    tmodel.load_state_dict(convert.convert_flax_variables(variables, tcfg))
    return jmodel, variables, tmodel


def test_leaf_conformer_ctc_matches_jax():
    jmodel, variables, tmodel = leaf_pair(seed=3)
    assert isinstance(tmodel.encoder.mel_layer.leaf, tleaf.Leaf)
    assert tmodel.encoder.mel_layer.out_features == N_FILTERS
    rng = np.random.default_rng(4)
    wav = (rng.standard_normal((2, 16000 + 123)) * 0.1).astype(np.float32)
    ids = rng.integers(1, BLANK, (2, 9)).astype(np.int32)
    want = jax.jit(lambda v, w, i: jmodel.apply(v, w, i))(variables, wav,
                                                          ids)
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(wav), torch.from_numpy(ids))
    for g, w, what in zip(got, want, ("enc", "ctc", "char")):
        close(g, w, what=what)
    flat = convert.flatten(jax.tree.map(np.asarray, variables))
    back = convert.to_flax_names(tmodel)
    assert set(back) == set(flat)
    assert "params/encoder/mel_layer/leaf/pcen/smooth" in back
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_leaf_loss_and_every_gradient_leaf_match_jax():
    jmodel, variables, tmodel = leaf_pair(seed=5)
    batch = make_batch(seed=6)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(params):
        return jtrain._loss_and_metrics(
            jmodel, params, variables["batch_stats"], jbatch,
            jax.random.PRNGKey(0), BLANK, True)

    (want_loss, _), want_grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(variables["params"])
    total, _ = ttrain.loss_and_metrics(
        tmodel.train(), {k: torch.from_numpy(v) for k, v in batch.items()},
        BLANK)
    total.backward()
    assert float(total.detach()) == pytest.approx(float(want_loss),
                                                  rel=1e-5)
    grads = {k: p.grad for k, p in tmodel.named_parameters()}
    want_grads = torch_leaves(want_grads)
    leaf_keys = [k for k in want_grads if ".leaf." in k]
    assert len(leaf_keys) == 9
    assert_leaves_close(grads, want_grads, GRAD_REL, "grad",
                        skip=ZERO_GRADIENT + PCEN_CANCELLING)
    for k in leaf_keys:
        if k.endswith(PCEN_CANCELLING):
            close(grads[k], want_grads[k].numpy(), rel=PCEN_GRAD_REL,
                  what=f"grad {k}")
