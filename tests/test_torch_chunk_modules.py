"""The port's chunk (SMLTA2) building blocks against the JAX package's, from
the same weights: the masks, ``feature_pick``, ``DepthwiseConv1D``'s
paddings, and ``ChunkMHSA``, ``ChunkConv``, ``ChunkBlock``, ``ChunkStack``
(both stack layouts), ``ChunkConvSubsampling``, ``ChunkFront`` and
``ContextHelper``, offline and in ``stream_call`` with their caches. f32,
values within 1e-5 of each leaf's largest entry, ids identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_chunk import N_PHONE, tiny_cfg
from tests.test_torch_chunk import (
    close,
    port_cfg,
    randomize,
    speech,
    t_,
)
from tensorflowasr_tpu.models import chunk_conformer as jcc
from tensorflowasr_tpu.models.layers import DepthwiseConv1D as JDepthwise
from tensorflowasr_tpu_torch.models import chunk_conformer as tcc
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.models.layers import DepthwiseConv1D

torch.set_num_threads(2)

SR = 16000


# ---------------------------------------------------------------------------
# Masks, feature_pick, depthwise padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,wf,wb", [(10, 3, 2), (12, 6, 0), (5, 6, 2),
                                     (9, 1, 3)])
def test_masks_match(t, wf, wb):
    close(tcc.chunk_band_mask(t, wf, wb), jcc.chunk_band_mask(t, wf, wb))
    rng = np.random.default_rng(t)
    fill = rng.integers(0, wf + 3, 5).astype(np.int32)
    skip = rng.integers(0, t, 5).astype(np.int32)
    valid = tcc.buffer_validity(wf, t, t_(fill), t_(skip))
    jvalid = jcc.buffer_validity(wf, t, jnp.asarray(fill), jnp.asarray(skip))
    close(valid, jvalid)
    close(tcc.stream_band_mask(wf, t, wf, wb, valid),
          jcc.stream_band_mask(wf, t, wf, wb, jvalid))


@pytest.mark.parametrize("max_out", [None, 8, 3])
def test_feature_pick_matches(max_out):
    rng = np.random.default_rng(1)
    b, t, d, v = 3, 11, 5, 7
    hidden = rng.standard_normal((b, t, d)).astype(np.float32)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    logits[1, :, v - 1] += 10.0            # a row that picks nothing
    got = tcc.feature_pick(t_(hidden), t_(logits), v - 1, max_out)
    want = jcc.feature_pick(jnp.asarray(hidden), jnp.asarray(logits), v - 1,
                            max_out)
    for g, w in zip(got, want):
        close(g, w, atol=0)


@pytest.mark.parametrize("padding,pad", [("SAME", None), ("CAUSAL", None),
                                         ("CAUSAL", (0, 0)),
                                         ("SAME", (2, 1))])
def test_depthwise_padding_matches(padding, pad):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    jmod = JDepthwise(6, 4, padding=padding)
    variables = randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                         jnp.asarray(x)), 4)
    tmod = DepthwiseConv1D(6, 4, padding=padding)
    tmod.load_state_dict(convert.chunk_to_torch_names(
        convert.flatten(variables)))
    close(tmod(t_(x), pad=pad), jmod.apply(variables, jnp.asarray(x),
                                           pad=pad))
    with pytest.raises(ValueError, match="SAME"):
        DepthwiseConv1D(6, 4, padding="VALID")


# ---------------------------------------------------------------------------
# Modules, offline and stream_call
# ---------------------------------------------------------------------------

def module_pair(jmod, tmod, *init_args, seed=5, method=None):
    kw = {} if method is None else {"method": method}
    shapes = jax.eval_shape(
        lambda k: jmod.init(k, *init_args, **kw), jax.random.PRNGKey(0))
    variables = randomize(shapes, seed)
    tmod.load_state_dict(convert.chunk_to_torch_names(
        convert.flatten(variables)))
    return variables, tmod.eval()


STACK = dict(dmodel=16, head_size=8, num_heads=2, kernel_size=4,
             dropout=0.0, win_front=6)


def stream_inputs(b, t, wf, k, d, kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, d)).astype(np.float32),
            rng.standard_normal((b, wf, kv)).astype(np.float32),
            rng.standard_normal((b, k - 1, d)).astype(np.float32),
            np.array([0, 3, 6], np.int32)[:b],
            np.array([2, 0, 1], np.int32)[:b])


@pytest.mark.parametrize("wb", [0, 2])
def test_chunk_mhsa_matches(wb):
    b, t, n_keep = 3, 5, 5 - wb
    jmod = jcc.ChunkMHSA(16, 8, 2, 0.0, 6, wb)
    x, kv, _, fill, skip = stream_inputs(b, t, 6, 4, 16, 32, seed=6)
    variables, tmod = module_pair(jmod, tcc.ChunkMHSA(16, 8, 2, 0.0, 6, wb),
                                  jnp.asarray(x))
    close(tmod(t_(x)), jmod.apply(variables, jnp.asarray(x)))
    t_valid = 3
    close(tmod(t_(x), torch.tensor(t_valid)),
          jmod.apply(variables, jnp.asarray(x), t_valid=jnp.asarray(t_valid)))

    valid = jcc.buffer_validity(6, t, jnp.asarray(fill), jnp.asarray(skip))
    keep = (np.arange(n_keep)[None] >= skip[:, None])[..., None]
    got = tmod.stream_call(t_(x), t_(kv), t_(np.asarray(valid)), t_(keep))
    want = jmod.apply(variables, jnp.asarray(x), jnp.asarray(kv), valid,
                      jnp.asarray(keep), method=jcc.ChunkMHSA.stream_call)
    close(got[0], want[0])
    close(got[1], want[1])             # the K/V ring, [B, wf, 2*H*hd]


def test_all_masked_query_is_uniform_not_nan():
    """fill 0 and skip past every input: a query with no valid key."""
    mha = tcc.StreamableMHA(8, 2, 4, 8)
    torch.nn.init.normal_(mha.value.weight)
    y = torch.randn(1, 3, 8)
    k, v = mha.project_kv(y)
    mask = torch.zeros(1, 1, 3, 3, dtype=torch.bool)
    out = mha.attend(y, k, v, mask)
    assert torch.isfinite(out).all()
    want = mha.out(v.mean(dim=1, keepdim=True).expand(-1, 3, -1, -1)
                   .reshape(1, 3, 8))
    close(out, want, atol=1e-6)


def test_win_back_assert_under_t_valid():
    mod = tcc.ChunkMHSA(16, 8, 2, 0.0, win_front=2, win_back=4)
    x = torch.randn(1, 6, 16)
    mod(x)                                           # no t_valid: fine
    with pytest.raises(ValueError, match="win_back <= win_front"):
        mod(x, torch.tensor(4))


def test_chunk_conv_matches():
    b, t, n_keep, k = 3, 5, 4, 4
    jmod = jcc.ChunkConv(16, k)
    x, _, cache, fill, skip = stream_inputs(b, t, 6, k, 16, 32, seed=7)
    variables, tmod = module_pair(jmod, tcc.ChunkConv(16, k),
                                  jnp.asarray(x))
    close(tmod(t_(x)), jmod.apply(variables, jnp.asarray(x)))
    valid = jcc.buffer_validity(k, t, jnp.asarray(fill), jnp.asarray(skip))
    keep = (np.arange(n_keep)[None] >= skip[:, None])[..., None]
    got = tmod.stream_call(t_(x), t_(cache), t_(np.asarray(valid)),
                           t_(keep))
    want = jmod.apply(variables, jnp.asarray(x), jnp.asarray(cache), valid,
                      jnp.asarray(keep), method=jcc.ChunkConv.stream_call)
    close(got[0], want[0])
    close(got[1], want[1])             # post-GLU ring, [B, k-1, d]


@pytest.mark.parametrize("wb", [0, 1])
def test_chunk_block_matches(wb):
    cfg = jcc.ChunkStackConfig(num_blocks=1, win_back=wb, **STACK)
    b, t = 3, 5
    x, kv, cache, fill, skip = stream_inputs(b, t, 6, 4, 16, 32, seed=8)
    jmod = jcc.ChunkBlock(cfg)
    variables, tmod = module_pair(jmod, tcc.ChunkBlock(
        tcc.ChunkStackConfig(**dataclasses.asdict(cfg))), jnp.asarray(x))
    close(tmod(t_(x)), jmod.apply(variables, jnp.asarray(x)))
    close(tmod(t_(x), torch.tensor(4)),
          jmod.apply(variables, jnp.asarray(x), t_valid=jnp.asarray(4)))
    got = tmod.stream_call(t_(x), t_(kv), t_(cache), t_(fill), t_(skip),
                           t - wb)
    want = jmod.apply(variables, jnp.asarray(x), jnp.asarray(kv),
                      jnp.asarray(cache), jnp.asarray(fill),
                      jnp.asarray(skip), t - wb,
                      method=jcc.ChunkBlock.stream_call)
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("scan", [False, True])
def test_chunk_stack_matches(scan):
    cfg = jcc.ChunkStackConfig(num_blocks=2, win_back=1, scan_layers=scan,
                               **STACK)
    b, t = 3, 6
    rng = np.random.default_rng(9)
    x = rng.standard_normal((b, t, 16)).astype(np.float32)
    jmod = jcc.ChunkStack(cfg)
    variables, tmod = module_pair(jmod, tcc.ChunkStack(
        tcc.ChunkStackConfig(**dataclasses.asdict(cfg))), jnp.asarray(x))
    close(tmod(t_(x)), jmod.apply(variables, jnp.asarray(x)))
    mha = rng.standard_normal((2, b, 6, 32)).astype(np.float32)
    cnn = rng.standard_normal((2, b, 3, 16)).astype(np.float32)
    fill = np.array([0, 2, 6], np.int32)
    skip = np.array([1, 0, 3], np.int32)
    got = tmod.stream_call(t_(x), t_(mha), t_(cnn), t_(fill), t_(skip))
    want = jmod.apply(variables, jnp.asarray(x), jnp.asarray(mha),
                      jnp.asarray(cnn), jnp.asarray(fill), jnp.asarray(skip),
                      method=jcc.ChunkStack.stream_call)
    for g, w in zip(got, want):
        close(g, w)
    caches = tmod.init_caches(b, "cpu")
    jcaches = jmod.apply(variables, b, method=jcc.ChunkStack.init_caches)
    for g, w in zip(caches, jcaches):
        close(g, w, atol=0)


def test_chunk_subsampling_matches():
    rng = np.random.default_rng(10)
    b, n_mels = 2, 20
    x = rng.standard_normal((b, 32, n_mels, 1)).astype(np.float32)
    jmod = jcc.ChunkConvSubsampling(16, 16, 4)
    variables, tmod = module_pair(
        jmod, tcc.ChunkConvSubsampling(16, n_mels, 16, 4), jnp.asarray(x))
    close(tmod(t_(x)), jmod.apply(variables, jnp.asarray(x)))
    cache = rng.standard_normal((b, 4, n_mels, 1)).astype(np.float32)
    got = tmod.stream_call(t_(x[:, :16]), t_(cache))
    want = jmod.apply(variables, jnp.asarray(x[:, :16]), jnp.asarray(cache),
                      method=jcc.ChunkConvSubsampling.stream_call)
    close(got[0], want[0])
    close(got[1], want[1])


@pytest.mark.parametrize("trainable", [False, True])
def test_chunk_front_matches(trainable):
    jcfg = dataclasses.replace(tiny_cfg(), mel_layer_trainable=trainable)
    cfg = port_cfg(jcfg)
    b, cs = 2, jcfg.chunk_samples
    wav = np.stack([speech(3 * cs / SR, seed=s) for s in (1, 2)])
    jmod = jcc.ChunkFront(jcfg)
    variables, tmod = module_pair(jmod, tcc.ChunkFront(cfg),
                                  jnp.asarray(wav))
    if trainable:
        assert "freq2mel" in variables["params"]
    close(tmod(t_(wav)), jmod.apply(variables, jnp.asarray(wav)))
    # a chunk after a chunk of history, from int16 PCM too
    pcm = (wav * 20000).astype(np.int16)
    sub = np.random.default_rng(3).standard_normal(
        (b, 4, 20, 1)).astype(np.float32)
    for chunk in (wav[:, cs:2 * cs], pcm[:, cs:2 * cs]):
        got = tmod.stream_call(t_(chunk), t_(wav[:, :cs]), t_(sub))
        want = jmod.apply(variables, jnp.asarray(chunk),
                          jnp.asarray(wav[:, :cs]), jnp.asarray(sub),
                          method=jcc.ChunkFront.stream_call)
        for g, w in zip(got, want):
            close(g, w, atol=2e-5)


def test_helper_phone_call_matches():
    cfg = jcc.ChunkStackConfig(num_blocks=1, **STACK)
    ids = np.array([[1, 4, 2, 0, 7]], np.int32)
    jmod = jcc.ContextHelper(cfg, N_PHONE)
    variables, tmod = module_pair(
        jmod, tcc.ContextHelper(tcc.ChunkStackConfig(
            **dataclasses.asdict(cfg)), N_PHONE),
        jnp.asarray(ids), method=jcc.ContextHelper.phone_call)
    got = tmod.phone_call(t_(ids))
    want = jmod.apply(variables, jnp.asarray(ids),
                      method=jcc.ContextHelper.phone_call)
    close(got[0], want[0])
    close(got[1], want[1])
