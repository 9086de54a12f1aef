"""The port's ChunkConformer (SMLTA2) against the JAX package's, from the
same weights, in both stack layouts (``scan_layers`` false and true):
``encode_to_phones``, ``predict`` and ``make_chunk_predict_step`` in both
decode-length modes, the three stream steps chunk by chunk with the caches
compared leaf by leaf, ``batched_stream_step`` with reset and advance masks
against the JAX package's vmapped step, the lookahead-everywhere config,
the converter's refusals and its inverse, and the config reader. f32,
values within 1e-5 of each leaf's largest entry, ids identical. The
modules one by one are in ``tests/test_torch_chunk_modules.py``."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_chunk import N_CHAR, N_PHONE, tiny_cfg, _lookahead_cfg
from tensorflowasr_tpu.models import chunk_conformer as jcc
from tensorflowasr_tpu.train.chunk_trainer import (
    make_chunk_predict_step as jax_predict_step,
)
from tensorflowasr_tpu_torch.models import chunk_conformer as tcc
from tensorflowasr_tpu_torch.models import convert
# gated two-tone segments at three loudness levels: frames that differ
# enough for a random-weight model to tell apart
from tensorflowasr_tpu_torch.serve.bench_chunk import tones as speech
from tensorflowasr_tpu_torch.train.chunk_trainer import (
    make_chunk_predict_step,
)

torch.set_num_threads(2)

SR = 16000
ATOL = 1e-5                # of the largest entry of the compared leaf
State = collections.namedtuple("State", "params batch_stats")


# ---------------------------------------------------------------------------
# Shared helpers (also used by tests/test_torch_chunk_serve.py)
# ---------------------------------------------------------------------------

def with_scan(cfg, scan: bool):
    """The JAX config with ``scan_layers`` set on every stack."""
    return dataclasses.replace(cfg, **{
        name: dataclasses.replace(getattr(cfg, name), scan_layers=scan)
        for name in ("encoder", "picker", "decoder", "helper")})


def port_cfg(jcfg) -> tcc.ChunkConformerConfig:
    """The port's config with the JAX config's fields."""
    ported = {f.name for f in dataclasses.fields(tcc.ChunkConformerConfig)}
    fields = {k: v for k, v in dataclasses.asdict(jcfg).items()
              if k in ported}
    for name in ("encoder", "picker", "decoder", "helper"):
        fields[name] = tcc.ChunkStackConfig(**fields[name])
    return tcc.ChunkConformerConfig(**fields)


def randomize(shapes, seed):
    """Fan-in scaled kernels, small biases and norm parameters, BatchNorm
    statistics away from (0, 1): an untrained model whose frames differ,
    with every leaf's mapping exercised."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        leaf, parent = path[-1].key, path[-2].key
        if leaf == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(
                np.float32)
        if leaf == "embedding":
            return rng.standard_normal(x.shape).astype(np.float32)
        if leaf == "kernel":
            # a scanned stack's leaves carry the layer axis first
            shape = x.shape[1:] if _stacked(path) else x.shape
            fan_in = (shape[0] if parent in ("query", "key", "value",
                                              "dw_conv")
                      else int(np.prod(shape[:-1])))
            # the 'valid' log-mel spans about 0.1, so the first conv gains
            # what training would give it
            gain = 10.0 if parent == "conv1" else 1.0
            return (gain * rng.standard_normal(x.shape)
                    / np.sqrt(fan_in)).astype(np.float32)
        if leaf == "freq2mel":
            return rng.uniform(0.0, 5e-4, x.shape).astype(np.float32)
        return (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _stacked(path) -> bool:
    return any(p.key == "block" for p in path)


def jfn(jmodel, method=None, *static):
    """``jmodel.apply(variables, *args, *static, method=method)``, jitted:
    far quicker than flax's eager apply over a stream of chunks."""
    kw = {} if method is None else {"method": method}
    return jax.jit(lambda v, *args: jmodel.apply(v, *args, *static, **kw))


def calibrate_blank(jmodel, variables, wav):
    """Move the picker's blank bias to the median margin of the blank logit
    over the other classes on ``wav``, so about half the frames are
    picked (a random picker keeps almost all or almost none)."""
    logits, _ = jfn(jmodel, jcc.ChunkConformer.encode_to_phones)(
        variables, jnp.asarray(wav))
    logits = np.asarray(logits, np.float64)
    blank = jmodel.num_phone_classes - 1
    margin = logits[..., blank] - np.max(logits[..., :blank], axis=-1)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    params["phone_picker"]["fully_connected"]["bias"][blank] -= np.float32(
        np.median(margin))
    return {**variables, "params": params}


def build_pair(jcfg, seed=3, n_phone=N_PHONE, n_char=N_CHAR, calib=None):
    """(flax model, its variables, the port's model with those weights).
    The JAX variables' shapes come from ``train_forward``'s init, as the JAX
    tests build them."""
    jmodel = jcc.ChunkConformer(jcfg, n_phone, n_char)
    shapes = jax.eval_shape(
        lambda k, w, p: jmodel.init(k, w, p, 8, False,
                                    method=jcc.ChunkConformer.train_forward),
        jax.random.PRNGKey(0), jnp.zeros((1, jcfg.chunk_samples)),
        jnp.ones((1, 4), jnp.int32))
    variables = randomize(shapes, seed)
    if calib is not None:
        variables = calibrate_blank(jmodel, variables, calib)
    cfg = port_cfg(jcfg)
    tmodel = tcc.ChunkConformer(cfg, n_phone, n_char)
    tmodel.load_state_dict(convert.convert_flax_variables(variables, cfg))
    return jmodel, variables, tmodel.eval()


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def close(got, want, atol=ATOL):
    """Ids equal; values within ``atol`` of the leaf's largest entry (or
    of 1, whichever is larger)."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1.0, float(np.abs(want).max(initial=0.0)))
        np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale)


def close_caches(got, want, atol=ATOL):
    assert sorted(got) == sorted(want)
    for k in want:
        close(got[k], want[k], atol)


def t_(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# The whole model, both stack layouts
# ---------------------------------------------------------------------------

N_CHUNKS = 6


@pytest.fixture(scope="module", params=[False, True],
                ids=["unrolled", "scan"])
def pair(request):
    jcfg = with_scan(tiny_cfg(), request.param)
    wav = np.stack([speech(N_CHUNKS * jcfg.chunk_samples / SR, seed=s)
                    for s in (21, 22)])
    jmodel, variables, tmodel = build_pair(jcfg, seed=1, calib=wav)
    return jmodel, variables, tmodel, jcfg, wav


def test_offline_and_predict_match(pair):
    jmodel, variables, tmodel, jcfg, wav = pair
    logits, hidden = tmodel.encode_to_phones(t_(wav))
    jlogits, jhidden = jfn(jmodel, jcc.ChunkConformer.encode_to_phones)(
        variables, jnp.asarray(wav))
    close(logits, jlogits)
    close(hidden, jhidden)
    kept = (np.argmax(to_np(logits), -1) != N_PHONE - 1).mean()
    assert 0.2 <= kept <= 0.8, kept
    close(tmodel(t_(wav))[0], jfn(jmodel)(variables, jnp.asarray(wav))[0])
    for max_pick in (None, 10):
        got = tmodel.predict(t_(wav), max_pick)
        want = jfn(jmodel, jcc.ChunkConformer.predict, max_pick)(
            variables, jnp.asarray(wav))
        for g, w in zip(got, want):
            close(g, w)


@pytest.mark.parametrize("mode", ["padded", "picked"])
def test_chunk_predict_step_identical_ids(pair, mode):
    jmodel, variables, tmodel, jcfg, wav = pair
    in_len = np.array([N_CHUNKS * jcfg.sub_length,
                       N_CHUNKS * jcfg.sub_length - 5], np.int32)
    got = make_chunk_predict_step(tmodel, txt_decode_length=mode)(
        t_(wav), t_(in_len))
    state = State(variables["params"], variables["batch_stats"])
    want = jax_predict_step(jmodel, None, mode)(
        state, jnp.asarray(wav), jnp.asarray(in_len))
    for g, w in zip(got, want):
        close(g, w)
    phones = {int(i) for row, n in zip(to_np(got[2]), to_np(got[3]))
              for i in row[:n]}
    assert len(phones) > 2, phones
    with pytest.raises(ValueError, match="txt_decode_length"):
        make_chunk_predict_step(tmodel, txt_decode_length="whole")


def test_picker_stream_step_matches(pair):
    jmodel, variables, tmodel, jcfg, wav = pair
    cs = jcfg.chunk_samples
    caches = tmodel.init_picker_caches(2)
    jcaches = jmodel.apply(variables, 2,
                           method=jcc.ChunkConformer.init_picker_caches)
    close_caches(caches, jcaches, atol=0)
    outs = []
    jstep = jfn(jmodel, jcc.ChunkConformer.picker_stream_step)
    with torch.no_grad():
        for i in range(N_CHUNKS):
            chunk = wav[:, i * cs:(i + 1) * cs]
            lg, hid, nf, caches = tmodel.picker_stream_step(t_(chunk), caches)
            jlg, jhid, jnf, jcaches = jstep(variables, jnp.asarray(chunk),
                                            jcaches)
            close(lg, jlg)
            close(hid, jhid)
            close(nf, jnf)
            close_caches(caches, jcaches)
            outs.append(to_np(lg))
    off, _ = tmodel.encode_to_phones(t_(wav))
    close(np.concatenate(outs, axis=1), off, atol=1e-4)


def test_decoder_stream_step_matches(pair):
    jmodel, variables, tmodel, jcfg, _ = pair
    b, s, total = 2, 3, 12
    picked = np.random.default_rng(4).standard_normal(
        (b, total, jcfg.dmodel)).astype(np.float32)
    caches = tmodel.init_decoder_caches(b)
    jcaches = jmodel.apply(variables, b,
                           method=jcc.ChunkConformer.init_decoder_caches)
    jstep = jfn(jmodel, jcc.ChunkConformer.decoder_stream_step)
    with torch.no_grad():
        for i in range(total // s):
            x = picked[:, i * s:(i + 1) * s]
            got = tmodel.decoder_stream_step(t_(x), caches)
            want = jstep(variables, jnp.asarray(x), jcaches)
            for g, w in zip(got[:3], want[:3]):
                close(g, w)
            caches, jcaches = got[3], want[3]
            close_caches(caches, jcaches)


def test_fused_stream_step_matches(pair):
    """Batch 1 against the JAX step, caches after every chunk; then the two
    streams as one batch of 2 against two JAX streams."""
    jmodel, variables, tmodel, jcfg, wav = pair
    cs = jcfg.chunk_samples
    jstep = jfn(jmodel, jcc.ChunkConformer.fused_stream_step)
    want_rows = []
    for s in range(2):
        jc = jmodel.apply(variables, 1,
                          method=jcc.ChunkConformer.init_stream_caches)
        tc = tmodel.init_stream_caches(1)
        rows = []
        for i in range(N_CHUNKS):
            chunk = wav[s:s + 1, i * cs:(i + 1) * cs]
            ph, ch, pv, nf, jc = jstep(variables, jnp.asarray(chunk), jc)
            with torch.no_grad():
                tph, tch, tpv, tnf, tc = tmodel.fused_stream_step(
                    t_(chunk), tc)
            close(tph[0], ph)
            close(tch[0], ch)
            close(tpv[0], pv)
            close(tnf, nf)
            close_caches(tc, jc)
            rows.append((to_np(ph), to_np(ch), to_np(pv), to_np(nf)))
        want_rows.append(rows)
    chars = [r[1] for rows in want_rows for r in rows]
    assert len(set(np.concatenate(chars).tolist()) - {-1}) > 2
    tc = tmodel.init_stream_caches(2)
    for i in range(N_CHUNKS):
        with torch.no_grad():
            out = tmodel.fused_stream_step(t_(wav[:, i * cs:(i + 1) * cs]),
                                           tc)
        tc = out[4]
        for s in range(2):
            for g, w in zip(out[:4], want_rows[s][i]):
                close(g[s], w.reshape(g[s].shape))


def jax_pool_to_port(caches):
    """JAX pool leaves [S, ..., 1, ...] -> the port's layout: per-layer
    rings [S, L, 1, ...] -> [L, S, ...], the others [S, 1, ...] -> [S,
    ...]."""
    out = {}
    for k, v in caches.items():
        v = np.asarray(v)
        if k.endswith(("_mha", "_cnn")):
            out[k] = np.moveaxis(v[:, :, 0], 0, 1)
        else:
            out[k] = v[:, 0]
    return out


def test_batched_stream_step_reset_advance_matches(pair):
    jmodel, variables, tmodel, jcfg, wav = pair
    cs, n_slots = jcfg.chunk_samples, 3
    rng = np.random.default_rng(5)
    jstep = jfn(jmodel, jcc.ChunkConformer.batched_stream_step)
    jc = jmodel.apply(variables, n_slots,
                      method=jcc.ChunkConformer.init_multi_stream_caches)
    tc = tmodel.init_multi_stream_caches(n_slots)
    close_caches(tc, jax_pool_to_port(jc), atol=0)
    plan = [([0, 0, 0], [1, 1, 0]), ([0, 0, 0], [1, 1, 1]),
            ([0, 1, 0], [1, 1, 0]), ([1, 0, 0], [1, 0, 1]),
            ([0, 0, 0], [1, 1, 1])]
    for i, (reset, adv) in enumerate(plan):
        chunks = np.stack([wav[s % 2, ((i + s) % N_CHUNKS) * cs:
                               ((i + s) % N_CHUNKS + 1) * cs]
                           for s in range(n_slots)])
        chunks[2] += 0.01 * rng.standard_normal(cs).astype(np.float32)
        reset, adv = np.array(reset, bool), np.array(adv, bool)
        ph, ch, pv, nf, jc = jstep(variables, jnp.asarray(chunks), jc,
                                   jnp.asarray(reset), jnp.asarray(adv))
        with torch.no_grad():
            tph, tch, tpv, tnf, tc = tmodel.batched_stream_step(
                t_(chunks), tc, t_(reset), t_(adv))
        close(tph[adv], np.asarray(ph)[adv])
        close(tch[adv], np.asarray(ch)[adv])
        close(tpv[adv], np.asarray(pv)[adv])
        close(tnf[adv], np.asarray(nf)[adv, 0])
        close_caches(tc, jax_pool_to_port(jc))


# ---------------------------------------------------------------------------
# Lookahead on every stack: streaming == offline in the port
# ---------------------------------------------------------------------------

def test_lookahead_everywhere_streaming_equals_offline():
    jcfg = _lookahead_cfg()
    n_chunks, cs = 6, jcfg.chunk_samples
    wav = np.stack([speech(n_chunks * cs / SR, seed=s) for s in (31, 32)])
    jmodel, variables, tmodel = build_pair(jcfg, seed=1, calib=wav)
    off_logits, off_hidden = tmodel.encode_to_phones(t_(wav))
    t = jcfg.sub_length
    caches = tmodel.init_picker_caches(2)
    jcaches = jmodel.apply(variables, 2,
                           method=jcc.ChunkConformer.init_picker_caches)
    finals = []
    jstep = jfn(jmodel, jcc.ChunkConformer.picker_stream_step)
    with torch.no_grad():
        for i in range(n_chunks):
            chunk = wav[:, i * cs:(i + 1) * cs]
            lg, _, nf, caches = tmodel.picker_stream_step(t_(chunk), caches)
            *_, jcaches = jstep(variables, jnp.asarray(chunk), jcaches)
            close_caches(caches, jcaches)
            n = int(nf[0])
            if n > 0:
                finals.append(to_np(lg)[:, t - n:])
    stream = np.concatenate(finals, axis=1)
    delay = jcfg.encoder.lookahead + jcfg.picker.lookahead
    assert stream.shape[1] == n_chunks * t - delay
    close(stream, to_np(off_logits)[:, :stream.shape[1]], atol=1e-4)

    # helper + multi-block decoder lookahead
    b, s, total = 2, 3, 18
    picked = np.random.default_rng(8).standard_normal(
        (b, total, jcfg.dmodel)).astype(np.float32)
    with torch.no_grad():
        off = tmodel.decoder(tmodel.helper(t_(picked)))[0]
        caches = tmodel.init_decoder_caches(b)
        finals = []
        for i in range(total // s):
            lg, _, nf, caches = tmodel.decoder_stream_step(
                t_(picked[:, i * s:(i + 1) * s]), caches)
            n = int(nf[0])
            if n > 0:
                finals.append(to_np(lg)[:, s - n:])
    stream = np.concatenate(finals, axis=1)
    delay = jcfg.helper.lookahead + jcfg.decoder.lookahead
    assert stream.shape[1] == total - delay
    close(stream, to_np(off)[:, :total - delay], atol=1e-4)

    # the fused step with every ring: ids and caches as JAX's
    jc = jmodel.apply(variables, 1,
                      method=jcc.ChunkConformer.init_stream_caches)
    tc = tmodel.init_stream_caches(1)
    jstep = jfn(jmodel, jcc.ChunkConformer.fused_stream_step)
    for i in range(4):
        chunk = wav[:1, i * cs:(i + 1) * cs]
        want = jstep(variables, jnp.asarray(chunk), jc)
        with torch.no_grad():
            got = tmodel.fused_stream_step(t_(chunk), tc)
        for g, w in zip(got[:3], want[:3]):
            close(g[0], w)
        close(got[3], want[3])
        tc, jc = got[4], want[4]
        close_caches(tc, jc)


# ---------------------------------------------------------------------------
# Converter and refusals
# ---------------------------------------------------------------------------

def test_to_flax_names_inverts_the_converter(pair):
    """The port's weights written back under flax names are the JAX
    variables, leaf for leaf, in the fixture's stack layout."""
    _, variables, tmodel, jcfg, _ = pair
    want = convert.flatten(variables)
    got = convert.to_flax_names(tmodel, jcfg.encoder.scan_layers)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name], arr, err_msg=name)


def test_converter_refuses_missing_and_extra_keys():
    jcfg = tiny_cfg()
    jmodel = jcc.ChunkConformer(jcfg, N_PHONE, N_CHAR)
    shapes = jax.eval_shape(
        lambda k, w, p: jmodel.init(k, w, p, 8, False,
                                    method=jcc.ChunkConformer.train_forward),
        jax.random.PRNGKey(0), jnp.zeros((1, jcfg.chunk_samples)),
        jnp.ones((1, 4), jnp.int32))
    flat = convert.flatten(randomize(shapes, 1))
    cfg = port_cfg(jcfg)
    state = convert.convert_flat(flat, cfg)
    assert convert.num_classes(state) == (N_PHONE, N_CHAR)
    missing = dict(flat)
    del missing["params/helper/sample_helper/embedding"]
    with pytest.raises(KeyError, match="missing"):
        convert.convert_flat(missing, cfg)
    extra = dict(flat)
    extra["params/encoder/block_2/ln/scale"] = np.ones(16, np.float32)
    with pytest.raises(KeyError, match="unused"):
        convert.convert_flat(extra, cfg)
    both = dict(flat)
    both["params/encoder/block/ln/scale"] = np.ones((2, 16), np.float32)
    with pytest.raises(KeyError, match="both stack layouts"):
        convert.convert_flat(both, cfg)
    # a scanned checkpoint does not fit an unrolled model of other depth
    deeper = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, num_blocks=3))
    with pytest.raises(KeyError, match="missing"):
        convert.convert_flat(flat, deeper)


def test_unported_options_raise():
    """Training-mode SpecAugment needs a generator; the stream step takes
    whole chunks only. (Training with ``t_valid`` and SpecAugment are tested
    against the JAX package in ``tests/test_torch_chunk_train.py``;
    ``fused_decoder: true`` in ``tests/test_torch_chunk_fused.py``.)"""
    cfg = port_cfg(tiny_cfg())
    model = tcc.ChunkConformer(dataclasses.replace(cfg, spec_augment=True),
                               N_PHONE, N_CHAR).train()
    with pytest.raises(RuntimeError, match="generator"):
        model.front(torch.zeros(1, cfg.chunk_samples))
    conv = tcc.ChunkConv(16, 4).train()
    assert conv(torch.zeros(1, 5, 16), torch.tensor(3)).shape == (1, 5, 16)
    with pytest.raises(ValueError, match="chunks of exactly"):
        model.eval().picker_stream_step(torch.zeros(1, 100),
                                        model.init_picker_caches(1))


def test_config_from_user_config():
    from tensorflowasr_tpu.utils.config import UserConfig as JConfig
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    want = jcc.ChunkConformerConfig.from_user_config(
        JConfig("configs/am_data.yml", "configs/chunk_conformerS.yml"))
    got = tcc.ChunkConformerConfig.from_user_config(
        UserConfig("configs/am_data.yml", "configs/chunk_conformerS.yml"),
        "bfloat16")
    assert got == dataclasses.replace(port_cfg(want), dtype_str="bfloat16")
    assert (got.chunk_samples, got.sub_length, got.hop) == (2560, 4, 160)
    assert (got.encoder.num_blocks, got.encoder.scan_layers,
            got.decoder.lookahead) == (15, True, 8)
