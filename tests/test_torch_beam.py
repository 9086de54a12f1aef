"""The port's CTC prefix beam search (``tensorflowasr_tpu_torch/ops/beam.py``)
against JAX's ``ctc_beam_search_decode`` on seeded logits, without an LM,
with a dense bigram and with n-gram LMs of orders 2-4, against the dict
reference of ``tests/test_beam.py``, and ``make_beam_predict_step`` against
JAX's on a small ConformerCTC. The best prefix must be identical; every live
beam's prefix and score must agree (scores within 1e-5 relative) wherever
neighbouring beams are 1e-4 apart, so that a rounding-level reorder of
near-tied beams is not a failure."""

import collections
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops.beam import ctc_beam_search_decode as jbeam
from tensorflowasr_tpu.train.asr_trainer import (
    make_beam_predict_step as jmake_beam,
)
from tensorflowasr_tpu.utils import ngram_lm as jlm
from tensorflowasr_tpu_torch.ops.beam import NEG_INF
from tensorflowasr_tpu_torch.ops.beam import ctc_beam_search_decode as tbeam
from tensorflowasr_tpu_torch.train.asr_trainer import (
    make_beam_predict_step as tmake_beam,
)
from tensorflowasr_tpu_torch.utils import ngram_lm as tlm
from tests.test_torch_serve import SR, pair, speech

torch.set_num_threads(2)

B, T, V, W = 3, 40, 12, 6
BLANK = V - 1
SCORE_RTOL, APART = 1e-5, 1e-4
State = collections.namedtuple("State", "params batch_stats")


def np_prefix_beam_search(logp, blank, beam_width):
    """Classic dict-based CTC prefix beam search (Hannun 2014), as in
    ``tests/test_beam.py``."""
    T, V = logp.shape
    beams = {(): (0.0, NEG_INF)}                 # prefix -> (p_b, p_nb)

    def logadd(a, b):
        if a <= NEG_INF / 2:
            return b
        if b <= NEG_INF / 2:
            return a
        m = max(a, b)
        return m + np.log(np.exp(a - m) + np.exp(b - m))

    for t in range(T):
        new = {}

        def add(prefix, pb, pnb):
            opb, opnb = new.get(prefix, (NEG_INF, NEG_INF))
            new[prefix] = (logadd(opb, pb), logadd(opnb, pnb))

        for prefix, (p_b, p_nb) in beams.items():
            ptot = logadd(p_b, p_nb)
            # stay with blank
            add(prefix, ptot + logp[t, blank], NEG_INF)
            for c in range(V):
                if c == blank:
                    continue
                if prefix and prefix[-1] == c:
                    # repeat: extends only from blank-ending mass; stays
                    # from non-blank-ending mass
                    add(prefix, NEG_INF, p_nb + logp[t, c])
                    add(prefix + (c,), NEG_INF, p_b + logp[t, c])
                else:
                    add(prefix + (c,), NEG_INF, ptot + logp[t, c])
        beams = dict(sorted(new.items(),
                            key=lambda kv: -logadd(*kv[1]))[:beam_width])
    out = [(p, logadd(*v)) for p, v in beams.items()]
    out.sort(key=lambda x: -x[1])
    return out


def lm_corpus(seed=0, n=200):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, V - 1, size=rng.integers(3, 12))]
            for _ in range(n)]


def lm_args(kind):
    """(JAX kwargs, port kwargs) for one fusion setting."""
    if kind == "none":
        return {}, {}
    if kind == "bigram":
        big = np.pad(jlm.estimate_bigram_lm(lm_corpus(), V - 1),
                     ((0, 1), (0, 1)), constant_values=-20.0)
        return (dict(lm_logp=jnp.asarray(big), lm_weight=0.6),
                dict(lm_logp=torch.from_numpy(big), lm_weight=0.6))
    order = int(kind[-1])
    lm = tlm.train_ngram_lm(lm_corpus(), V, order=order)
    jhost = jlm.NGramLM(**{f: getattr(lm, f) for f in (
        "order", "vocab_size", "uni_logp", "key1", "key2", "val",
        "n_probe")})
    return (dict(ngram_lm=jlm.lm_pack(jhost), lm_weight=0.6),
            dict(ngram_lm=tlm.lm_pack(lm, "cpu"), lm_weight=0.6))


def assert_beams_agree(got, want):
    """Best prefix identical; each live beam (prefix, score) equal where the
    beams around it are ``APART`` apart."""
    (gp, gl, gs), (wp, wl, ws) = got, want
    assert gp.shape == wp.shape and gs.shape == ws.shape
    for b in range(gs.shape[0]):
        assert gp[b, 0, :gl[b, 0]].tolist() == wp[b, 0, :wl[b, 0]].tolist()
        live = ws[b] > NEG_INF / 2
        assert (gs[b] > NEG_INF / 2).tolist() == live.tolist()
        np.testing.assert_allclose(gs[b, live], ws[b, live],
                                   rtol=SCORE_RTOL, atol=0)
        gaps = np.abs(np.diff(ws[b]))
        for i in np.flatnonzero(live):
            near = [gaps[j] for j in (i - 1, i) if 0 <= j < len(gaps)]
            if min(near, default=1.0) >= APART * abs(ws[b, i]):
                assert gl[b, i] == wl[b, i]
                assert gp[b, i, :gl[b, i]].tolist() == \
                    wp[b, i, :wl[b, i]].tolist()


@pytest.mark.parametrize("prune_k", [V, 5])
@pytest.mark.parametrize("kind", ["none", "bigram", "ngram2", "ngram3",
                                  "ngram4"])
def test_beam_matches_jax(kind, prune_k):
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal((B, T, V)) * 2.0).astype(np.float32)
    lengths = np.asarray([T, 31, 17], np.int32)
    jkw, tkw = lm_args(kind)
    want = [np.asarray(a) for a in jbeam(
        jnp.asarray(logits), jnp.asarray(lengths), blank_id=BLANK,
        beam_width=W, prune_k=prune_k, **jkw)]
    got = [a.numpy() for a in tbeam(
        torch.from_numpy(logits), torch.from_numpy(lengths), blank_id=BLANK,
        beam_width=W, prune_k=prune_k, **tkw)]
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    assert_beams_agree(got, want)
    # the decode is not trivial: best prefixes of several tokens
    assert min(got[1][:, 0]) >= 3


def test_beam_matches_dict_reference():
    rng = np.random.default_rng(0)
    t, v, blank, w = 8, 5, 4, 6
    logits = rng.standard_normal((1, t, v)).astype(np.float32) * 2.0
    logp = torch.log_softmax(torch.from_numpy(logits[0]), -1).numpy()
    want = np_prefix_beam_search(logp, blank, w)
    prefixes, lengths, scores = tbeam(
        torch.from_numpy(logits), torch.tensor([t]), blank_id=blank,
        beam_width=w, prune_k=v)
    got = tuple(prefixes[0, 0, :int(lengths[0, 0])].tolist())
    assert got == want[0][0]
    for i in range(min(3, len(want))):
        np.testing.assert_allclose(float(scores[0, i]), want[i][1],
                                   rtol=1e-4)


def test_beam_respects_lengths():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((1, 10, 4)).astype(
        np.float32))
    p1, l1, s1 = tbeam(logits, torch.tensor([4]), blank_id=3, beam_width=4,
                       prune_k=4)
    p2, l2, s2 = tbeam(logits[:, :4], torch.tensor([4]), blank_id=3,
                       beam_width=4, prune_k=4)
    np.testing.assert_array_equal(s1.numpy(), s2.numpy())
    np.testing.assert_array_equal(l1.numpy(), l2.numpy())
    np.testing.assert_array_equal(p1[..., :4].numpy(), p2.numpy())


def test_make_beam_predict_step_matches_jax():
    """Encode, CTC logits, beam with an order-3 LM, the best beam padded
    with 10 zeros, translate, argmax: the port's step against JAX's on the
    same weights; phone ids, lengths and char ids identical."""
    n_phone, n_char = 11, 17
    jmodel, variables, tmodel = pair(n_phone, n_char, seed=11)
    lens_s = (1.5, 1.0, 1.2)
    wav = np.zeros((3, int(max(lens_s) * SR)), np.float32)
    for i, s in enumerate(lens_s):
        wav[i, :int(s * SR)] = speech(s, seed=20 + i)
    in_len = np.array([int(s * SR) // 640 for s in lens_s], np.int32)
    rng = np.random.default_rng(4)
    seqs = [[int(t) for t in rng.integers(0, n_phone - 1, size=8)]
            for _ in range(100)]
    lm = tlm.train_ngram_lm(seqs, n_phone, order=3)
    jhost = jlm.NGramLM(**{f: getattr(lm, f) for f in (
        "order", "vocab_size", "uni_logp", "key1", "key2", "val",
        "n_probe")})

    jstep = jmake_beam(jmodel, n_phone - 1, beam_width=8,
                       ngram_lm=jlm.lm_pack(jhost), lm_weight=0.5)
    want = [np.asarray(a) for a in jstep(
        State(variables["params"], variables["batch_stats"]),
        jnp.asarray(wav), jnp.asarray(in_len))]
    tstep = tmake_beam(tmodel, n_phone - 1, beam_width=8,
                       ngram_lm=tlm.lm_pack(lm, "cpu"), lm_weight=0.5)
    got = [a.numpy() for a in tstep(types.SimpleNamespace(model=tmodel),
                                    torch.from_numpy(wav),
                                    torch.from_numpy(in_len))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # the decodes are not trivial: several phones a row, lengths that vary
    assert min(got[1]) >= 3 and len(set(got[1].tolist())) == 3
