"""The port's n-gram LM (``tensorflowasr_tpu_torch/utils/ngram_lm.py``)
against the JAX package's on the same seeded corpora: the hash tables equal
element for element, ``.npz`` files written by each package load in the
other, the ARPA text byte for byte, perplexity, and ``score_candidates`` on
tensors against JAX's and against ``NGramLM.score`` (numpy). Tables and
ARPA text must be identical; scores are held to 1e-6 absolute (both sides
gather the same float32 table values and add them in the same order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.utils import ngram_lm as jlm
from tensorflowasr_tpu_torch.utils import ngram_lm as tlm

V = 12
ARRAYS = ("uni_logp", "key1", "key2", "val")
WORD_ARPA = """
\\data\\
ngram 1=4
ngram 2=3

\\1-grams:
-0.5\tab\t-0.3
-0.5\tcd\t-0.3
-0.8\tbad\t-0.2
-99\t<s>\t-0.3

\\2-grams:
-0.2\tab cd
-1.5\tcd ab
-0.9\tbad cd

\\end\\
"""


def corpus(seed=0, n=300, v=V - 1):
    """Token sequences over 0..v-1 with an order-2 rule and noise."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n):
        s = [int(rng.integers(0, v)), int(rng.integers(0, v))]
        for _ in range(int(rng.integers(0, 10))):
            s.append((2 * s[-2] + s[-1]) % v if rng.random() < 0.8
                     else int(rng.integers(0, v)))
        seqs.append(s)
    return seqs


def assert_same_lm(got, want):
    assert (got.order, got.vocab_size, got.n_probe) == \
        (want.order, want.vocab_size, want.n_probe)
    for name in ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.raw == want.raw


@pytest.mark.parametrize("order", [2, 3, 4])
def test_tables_equal_jax(order):
    seqs = corpus()
    assert_same_lm(tlm.train_ngram_lm(seqs, V, order=order, discount=0.7),
                   jlm.train_ngram_lm(seqs, V, order=order, discount=0.7))
    weighted = [(s, 0.1 + (i % 7) / 3.0) for i, s in enumerate(seqs[:80])]
    assert_same_lm(tlm.ngram_lm_from_weighted_sequences(weighted, V, order),
                   jlm.ngram_lm_from_weighted_sequences(weighted, V, order))


def test_bigram_table_equal_jax():
    seqs = corpus(seed=3)
    np.testing.assert_array_equal(tlm.estimate_bigram_lm(seqs, V, 0.3),
                                  jlm.estimate_bigram_lm(seqs, V, 0.3))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_loads_in_the_other_package(tmp_path, writer):
    seqs = corpus(seed=1)
    mods = {"jax": jlm, "port": tlm}
    reader = mods["port" if writer == "jax" else "jax"]
    path = str(tmp_path / "lm.npz")
    mods[writer].train_ngram_lm(seqs, V, order=3).save(path)
    loaded = reader.NGramLM.load(path)
    assert_same_lm(loaded, jlm.train_ngram_lm(seqs, V, order=3))
    assert loaded.perplexity(seqs[:40]) == \
        jlm.train_ngram_lm(seqs, V, order=3).perplexity(seqs[:40])


@pytest.mark.parametrize("order", [2, 4])
def test_arpa_byte_identical_and_read_back(tmp_path, order):
    seqs = corpus(seed=2)
    tokens = [f"t{i}" for i in range(V - 2)] + [" ", "<blank>"]
    jpath, tpath = tmp_path / "j.arpa", tmp_path / "t.arpa"
    jlm.train_ngram_lm(seqs, V, order=order).to_arpa(str(jpath), tokens)
    tlm.train_ngram_lm(seqs, V, order=order).to_arpa(str(tpath), tokens)
    assert tpath.read_bytes() == jpath.read_bytes()
    ids = {t: i for i, t in enumerate(tokens)}
    assert_same_lm(tlm.NGramLM.from_arpa(str(tpath), ids, V),
                   jlm.NGramLM.from_arpa(str(jpath), ids, V))


def test_word_arpa_unit_and_char_lms_equal_jax(tmp_path):
    path = str(tmp_path / "w.arpa")
    (tmp_path / "w.arpa").write_text(WORD_ARPA, encoding="utf-8")
    chars = {c: i for i, c in enumerate("abcd")}
    assert_same_lm(tlm.char_lm_from_word_arpa(path, chars, 5, order=2),
                   jlm.char_lm_from_word_arpa(path, chars, 5, order=2))

    def units(word):
        return None if word == "bad" else [chars[c] for c in word]

    for order in (2, 3):
        assert_same_lm(tlm.unit_lm_from_word_arpa(path, units, 5, order),
                       jlm.unit_lm_from_word_arpa(path, units, 5, order))


def test_perplexity_equal_jax():
    seqs, held = corpus(seed=4), corpus(seed=5, n=40)
    for order in (2, 3):
        got = tlm.train_ngram_lm(seqs, V, order=order).perplexity(held)
        assert got == jlm.train_ngram_lm(seqs, V, order=order).perplexity(held)
    assert tlm.train_ngram_lm(seqs, V, 3).perplexity(held) < \
        tlm.train_ngram_lm(seqs, V, 2).perplexity(held)


@pytest.mark.parametrize("order", [2, 3, 4])
def test_score_candidates_match_jax_and_numpy(order):
    lm = tlm.train_ngram_lm(corpus(seed=6), V, order=order)
    rng = np.random.default_rng(order)
    c = order - 1
    ctx = rng.integers(0, V, size=(5, 4, c)).astype(np.int32)
    # BOS-padded contexts: the start of a sentence and one token in
    ctx[0, :, :] = lm.bos
    ctx[1, :, :-1] = lm.bos
    cand = rng.integers(0, V, size=(5, 4, 7)).astype(np.int32)
    got = tlm.score_candidates(tlm.lm_pack(lm, "cpu"), torch.from_numpy(ctx),
                               torch.from_numpy(cand)).numpy()
    want = np.asarray(jlm.score_candidates(
        jlm.lm_pack(jlm.NGramLM(**{f: getattr(lm, f) for f in (
            "order", "vocab_size", "uni_logp", "key1", "key2", "val",
            "n_probe")})), jnp.asarray(ctx), jnp.asarray(cand)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    golden = np.asarray([[[lm.score([t for t in ctx[i, j] if t != lm.bos], k)
                           for k in cand[i, j]] for j in range(4)]
                         for i in range(5)], np.float32)
    np.testing.assert_allclose(got, golden, rtol=0, atol=1e-6)
    # the backoff chain is taken: some candidates are seen n-grams, some not
    assert len(np.unique(np.round(got, 4))) > 10


def test_hash_lanes_wrap_as_uint32_near_2_pow_32():
    """The lanes are uint32 that wrap on multiply, held in int64: a lane
    near 2^32 times the multiplier (about 2^63.3) overflows int64, and the
    mask keeps the low 32 bits, as numpy's Python-int hash does."""
    rng = np.random.default_rng(7)
    top = 2 ** 32
    for kind in ("p", "b"):
        for _ in range(50):
            toks = [int(x) for x in rng.integers(top - 2 ** 12, top - 1,
                                                 size=int(rng.integers(1, 5)))]
            got = tlm._hash_torch(kind, len(toks),
                                  [torch.tensor([t]) for t in toks])
            assert tuple(int(h) for h in got) == tlm._hash_tuple(kind, toks)
    # lanes chosen just below 2^32, extended by one token
    h1 = torch.tensor([top - 1, top - 2, top - 12345, 2 ** 31])
    h2 = torch.tensor([top - 1, top - 7, 2 ** 31 + 5, top - 99])
    n1, n2 = tlm._hash_extend(h1, h2, torch.tensor([0, 5, 11, 3]))
    for a, b, t, g1, g2 in zip(h1.tolist(), h2.tolist(), [0, 5, 11, 3],
                               n1.tolist(), n2.tolist()):
        assert g1 == (a * tlm._P1 + t + 1) % top
        assert g2 == (b * tlm._P2 + t + 3) % top
        assert 0 <= g1 < top and 0 <= g2 < top


def test_device_table_holds_the_numpy_keys():
    lm = tlm.train_ngram_lm(corpus(seed=8), V, order=3)
    dev = tlm.lm_pack(lm, "cpu")
    assert (dev.order, dev.n_probe, dev.bos) == (3, lm.n_probe, V)
    assert dev.key1.dtype == torch.int64
    np.testing.assert_array_equal(dev.key1.numpy(), lm.key1.astype(np.int64))
    np.testing.assert_array_equal(dev.key2.numpy(), lm.key2.astype(np.int64))
    # every stored entry is found by the device lookup at its value
    h = np.asarray([tlm._hash_tuple(k, t) for k, t in lm.raw])
    found, value = tlm.table_lookup(dev, torch.from_numpy(h[:, 0]),
                                    torch.from_numpy(h[:, 1]))
    assert bool(found.all())
    np.testing.assert_array_equal(
        value.numpy(), np.asarray(list(lm.raw.values()), np.float32))
