"""The port's fused chunk decoder phase (``fused_decoder: true``) at the tiny
config of ``tests/test_chunk_fused_decoder.py``: against the port's own
sequential micro-steps (ids identical, caches within rtol 2e-4 / atol 2e-5,
as that file holds the JAX package's two paths), over a slot pool with
reset and advance masks, and against the JAX package's fused phase on the
same weights (ids identical, caches within 1e-5 of each leaf's largest
entry); its helpers ``left_compact_idx``, ``ring_append_dyn`` and
``dyn_band_mask`` against the JAX package's on seeded inputs, all-False and
all-True masks and a ring of width 0; and the refusal of helper
lookahead."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_chunk_fused_decoder import N_CHAR, N_PHONE, tiny_cfg
from tests.test_torch_chunk import (
    SR,
    build_pair,
    close_caches,
    jfn,
    port_cfg,
    speech,
    t_,
    to_np,
)
from tensorflowasr_tpu.models import chunk_conformer as jcc
from tensorflowasr_tpu_torch.models import chunk_conformer as tcc

torch.set_num_threads(2)

N_CHUNKS = 8
SEQ_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module", params=[2, 0], ids=["dec_wb2", "dec_wb0"])
def models(request):
    """(JAX fused model, variables, port sequential model, port fused model,
    two streams of N_CHUNKS chunks) with one set of calibrated weights."""
    jcfg = tiny_cfg(True, request.param)
    cs = jcfg.chunk_samples
    wav = np.stack([speech(N_CHUNKS * cs / SR, seed=s) for s in (31, 32)])
    jmodel, variables, fused = build_pair(jcfg, seed=2, n_phone=N_PHONE,
                                          n_char=N_CHAR, calib=wav)
    seq = tcc.ChunkConformer(port_cfg(tiny_cfg(False, request.param)),
                             N_PHONE, N_CHAR)
    seq.load_state_dict(fused.state_dict())
    assert fused.cfg.fused_decoder and not seq.cfg.fused_decoder
    return jmodel, variables, seq.eval(), fused, wav


def stream(model, wav, chunks=N_CHUNKS):
    """The fused_stream_step outputs chunk by chunk over B = len(wav)
    streams, and the last caches."""
    cs = model.cfg.chunk_samples
    caches = model.init_stream_caches(wav.shape[0])
    outs = []
    with torch.no_grad():
        for i in range(chunks):
            *ids, caches = model.fused_stream_step(
                t_(wav[:, i * cs:(i + 1) * cs]), caches)
            outs.append([to_np(x) for x in ids])
    return outs, caches


def test_fused_matches_sequential(models):
    """Two streams in one batch: every id identical, every cache leaf
    allclose; some chunks keep some of their frames and not others, and
    final chars are emitted."""
    _, _, seq, fused, wav = models
    outs_s, caches_s = stream(seq, wav)
    outs_f, caches_f = stream(fused, wav)
    kept = []
    for i, (a, b) in enumerate(zip(outs_s, outs_f)):
        for name, x, y in zip(("phone", "char", "prov", "n_final"), a, b):
            np.testing.assert_array_equal(x, y, err_msg=f"{name} chunk {i}")
        kept.extend((a[0] != N_PHONE - 1).sum(axis=1).tolist())
    t = seq.cfg.sub_length
    chars = np.concatenate([o[1] for o in outs_s])
    assert any(0 < k < t for k in kept) and (chars >= 0).sum() > 4, \
        (kept, chars)
    assert sorted(caches_s) == sorted(caches_f)
    for k in caches_s:
        np.testing.assert_allclose(to_np(caches_f[k]).astype(np.float32),
                                   to_np(caches_s[k]).astype(np.float32),
                                   err_msg=k, **SEQ_TOL)


def test_fused_matches_jax_fused(models):
    """One stream against the JAX package's fused phase chunk by chunk: ids
    identical, caches within 1e-5 of each leaf's largest entry."""
    jmodel, variables, _, fused, wav = models
    cs = fused.cfg.chunk_samples
    jstep = jfn(jmodel, jcc.ChunkConformer.fused_stream_step)
    jc = jmodel.apply(variables, 1,
                      method=jcc.ChunkConformer.init_stream_caches)
    tc = fused.init_stream_caches(1)
    emitted = 0
    for i in range(N_CHUNKS):
        chunk = wav[:1, i * cs:(i + 1) * cs]
        ph, ch, pv, nf, jc = jstep(variables, jnp.asarray(chunk), jc)
        with torch.no_grad():
            tph, tch, tpv, tnf, tc = fused.fused_stream_step(t_(chunk), tc)
        for got, want in ((tph[0], ph), (tch[0], ch), (tpv[0], pv),
                          (tnf, nf)):
            np.testing.assert_array_equal(to_np(got), np.asarray(want))
        close_caches(tc, jc)
        emitted += int((np.asarray(ch) >= 0).sum())
    assert emitted > 2


def test_fused_pool_reset_advance(models):
    """``batched_stream_step`` over 3 slots with reset and advance masks,
    the fused model against the sequential one: the advancing slots' ids
    identical and every cache leaf allclose after each tick."""
    _, _, seq, fused, wav = models
    cs, n_slots = seq.cfg.chunk_samples, 3
    rng = np.random.default_rng(5)
    pools = [m.init_multi_stream_caches(n_slots) for m in (seq, fused)]
    plan = [([0, 0, 0], [1, 1, 0]), ([0, 0, 0], [1, 1, 1]),
            ([0, 1, 0], [1, 1, 0]), ([1, 0, 0], [1, 0, 1]),
            ([0, 0, 0], [0, 0, 0]), ([0, 0, 1], [1, 1, 1])]
    for i, (reset, adv) in enumerate(plan):
        chunks = np.stack([wav[s % 2, ((i + s) % N_CHUNKS) * cs:
                               ((i + s) % N_CHUNKS + 1) * cs]
                           for s in range(n_slots)])
        chunks[2] += 0.01 * rng.standard_normal(cs).astype(np.float32)
        reset, adv = np.array(reset, bool), np.array(adv, bool)
        outs = []
        for j, model in enumerate((seq, fused)):
            with torch.no_grad():
                *ids, pools[j] = model.batched_stream_step(
                    t_(chunks), pools[j], t_(reset), t_(adv))
            outs.append([to_np(x)[adv] for x in ids])
        for name, a, b in zip(("phone", "char", "prov", "n_final"), *outs):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} tick {i}")
        for k in pools[0]:
            np.testing.assert_allclose(to_np(pools[1][k]).astype(np.float32),
                                       to_np(pools[0][k]).astype(np.float32),
                                       err_msg=f"{k} tick {i}", **SEQ_TOL)


@pytest.mark.parametrize("case", ["seeded", "all_false", "all_true"])
def test_helpers_match_jax(case):
    rng = np.random.default_rng({"seeded": 0, "all_false": 1,
                                 "all_true": 2}[case])
    b, t, d = 4, 7, 3
    valid = {"seeded": rng.random((b, t)) < 0.5,
             "all_false": np.zeros((b, t), bool),
             "all_true": np.ones((b, t), bool)}[case]
    np.testing.assert_array_equal(
        to_np(tcc.left_compact_idx(t_(valid))),
        np.asarray(jcc.left_compact_idx(jnp.asarray(valid))))
    rows = rng.standard_normal((b, t, d)).astype(np.float32)
    m = valid.sum(axis=1).astype(np.int32)
    for r in (0, 2, 5, 9):
        ring = rng.standard_normal((b, r, d)).astype(np.float32)
        got = tcc.ring_append_dyn(t_(ring), t_(rows), t_(m))
        want = jcc.ring_append_dyn(jnp.asarray(ring), jnp.asarray(rows),
                                   jnp.asarray(m))
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
        fill = rng.integers(0, r + 3, (b,)).astype(np.int32)
        for wf, wb in ((3, 0), (2, 1), (6, 4)):
            np.testing.assert_array_equal(
                to_np(tcc.dyn_band_mask(t_(fill), r, t_(valid), wf, wb)),
                np.asarray(jcc.dyn_band_mask(jnp.asarray(fill), r,
                                             jnp.asarray(valid), wf, wb)))


def test_helper_lookahead_raises():
    cfg = port_cfg(tiny_cfg(True))
    cfg = dataclasses.replace(cfg, helper=dataclasses.replace(
        cfg.helper, win_back=1))
    model = tcc.ChunkConformer(cfg, N_PHONE, N_CHAR).eval()
    with torch.no_grad(), pytest.raises(ValueError, match="helper win_back"):
        model.fused_stream_step(torch.zeros(1, cfg.chunk_samples),
                                model.init_stream_caches(1))
