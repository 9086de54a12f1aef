"""The port's ``WavePickModel`` (``add_wav_info``) against the JAX
package's, from the same numpy-seeded weights: the stride factorisation,
the module's output and gradients, and ConformerCTC with ``add_wav_info``
offline and block-streaming, outputs and the train step's loss and every
gradient leaf. Values within 1e-5 of each output's (or leaf's) largest
entry (the whole model's gradients 5e-5): f32 on both sides, summation
order only."""

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
from tensorflowasr_tpu.models import wav_model as jwav
from tensorflowasr_tpu.train import asr_trainer as jtrain
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.models import wav_model as twav
from tensorflowasr_tpu_torch.train import asr_trainer as ttrain

torch.set_num_threads(2)

REL = 1e-5
# the whole model's gradients as tests/test_torch_block_stream.py and
# tests/test_torch_chunk_train.py hold them: f32 rounding noise of about
# 1e-5 of a leaf's largest entry (1.1e-5 and 1.4e-5 seen here, in a
# layer-norm bias and a pointwise conv of the CTC decoder)
GRAD_REL = 5e-5
STREAM = dict(streaming=True, streaming_bucket=0.5)      # 7680 samples
SMALL = dict(TINY, num_blocks=1, translator_num_blocks=1)


def both_models(seed, **kw):
    """(flax ConformerCTC, its numpy-seeded variables, the port's model
    with those weights); the init input is one streaming chunk long."""
    jmodel = jconf.ConformerCTC(jconf.ConformerConfig(**SMALL, **kw),
                                N_PHONE, N_CHAR)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 7680), jnp.float32),
                            jnp.ones((1, 4), jnp.int32))
    variables = randomize(shapes, seed)
    tcfg = tconf.ConformerConfig(**SMALL, **kw)
    tmodel = tconf.ConformerCTC(tcfg, N_PHONE, N_CHAR)
    tmodel.load_state_dict(convert.convert_flax_variables(variables, tcfg))
    return jmodel, variables, tmodel


def close(got, want, rel=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("num", [640, 160, 320, 960, 256, 1, 7, 30030,
                                 303, 2 ** 20])
def test_get_scales_matches_jax(num):
    got = twav.get_scales(num)
    assert got == jwav.get_scales(num)
    assert len(got) <= 4 and int(np.prod(got)) == num
    assert got == sorted(got, reverse=True)


@pytest.mark.parametrize("t", [640 * 25, 640 * 25 + 123],
                         ids=["whole", "ragged"])
def test_wav_pick_forward_and_gradients_match_jax(t):
    hop, dout = 640, 32
    jm = jwav.WavePickModel(dout=dout, hop_size=hop)
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, t)) * 0.1).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, t)))
    params = jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32),
        shapes["params"])
    want = np.asarray(jax.jit(jm.apply)({"params": params}, wav))
    assert want.shape == (2, -(-t // hop), dout)
    cot = rng.standard_normal(want.shape).astype(np.float32)
    want_grads = jax.jit(jax.grad(lambda p: jnp.sum(
        jm.apply({"params": p}, wav) * cot)))(params)

    tm = twav.WavePickModel(dout, hop).train()
    tm.load_state_dict(torch_leaves(params))
    assert [type(m).__name__ for m in tm.children()][:2] == \
        ["DepthwiseConv1D", "Conv1D"]
    got = tm(torch.from_numpy(wav))
    close(got.detach(), want, what="output")
    (got * torch.from_numpy(cot)).sum().backward()
    assert_leaves_close({k: p.grad for k, p in tm.named_parameters()},
                        torch_leaves(want_grads), REL, "grad")
    # [B, T, 1] is the same input
    close(tm(torch.from_numpy(wav)[..., None]).detach(), want, what="3-d")


@pytest.mark.parametrize("stream", [False, True], ids=["offline", "block"])
def test_conformer_ctc_with_wav_info_matches_jax(stream):
    kw = dict(add_wav_info=True, **(STREAM if stream else {}))
    jmodel, variables, tmodel = both_models(seed=3, **kw)
    assert "wav_layer" in variables["params"]["encoder"]
    assert isinstance(tmodel.encoder.wav_layer, twav.WavePickModel)
    assert isinstance(tmodel.encoder, tconf.StreamingConformerEncoder) \
        == stream
    rng = np.random.default_rng(4)
    t = 2 * 7680 if stream else 16000 + 123
    wav = (rng.standard_normal((2, t)) * 0.1).astype(np.float32)
    ids = rng.integers(1, BLANK, (2, 9)).astype(np.int32)
    want = jax.jit(lambda v, w, i: jmodel.apply(v, w, i))(variables, wav,
                                                          ids)
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(wav), torch.from_numpy(ids))
    for g, w, what in zip(got, want, ("enc", "ctc", "char")):
        close(g, w, what=what)
    # the converter reads the port's weights back unchanged
    flat = convert.flatten(jax.tree.map(np.asarray, variables))
    back = convert.to_flax_names(tmodel)
    assert set(back) == set(flat)
    assert any(k.startswith("params/encoder/wav_layer/res_") for k in back)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("stream", [False, True], ids=["offline", "block"])
def test_wav_info_loss_and_every_gradient_leaf_match_jax(stream):
    """The train step's loss, metrics and every gradient leaf in training
    mode (dropout 0), as tests/test_torch_train.py holds the plain
    model."""
    kw = dict(add_wav_info=True, **(STREAM if stream else {}))
    jmodel, variables, tmodel = both_models(seed=5, **kw)
    batch = make_batch(seed=6, t=2 * 7680)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(params):
        return jtrain._loss_and_metrics(
            jmodel, params, variables["batch_stats"], jbatch,
            jax.random.PRNGKey(0), BLANK, True)

    (want_loss, (want_metrics, _)), want_grads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(variables["params"])
    total, metrics = ttrain.loss_and_metrics(
        tmodel.train(), {k: torch.from_numpy(v) for k, v in batch.items()},
        BLANK)
    total.backward()
    assert float(total.detach()) == pytest.approx(float(want_loss),
                                                  rel=1e-5)
    for k, v in want_metrics.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-5,
                                                  abs=1e-6), k
    grads = {k: p.grad for k, p in tmodel.named_parameters()}
    want_grads = torch_leaves(want_grads)
    assert any(k.startswith("encoder.wav_layer.") for k in want_grads)
    assert_leaves_close(grads, want_grads, GRAD_REL, "grad",
                        skip=ZERO_GRADIENT)
    top = max(float(g.abs().max()) for g in want_grads.values())
    for k, g in grads.items():
        if k.endswith(ZERO_GRADIENT):
            assert float(g.abs().max()) < 1e-5 * top, k
