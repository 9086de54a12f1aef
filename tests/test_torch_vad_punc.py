"""The port's VAD and punctuation models against the JAX package's, at the
shipped widths (``configs/vad_model.yml``: dmodel 32, 80-sample frames;
``configs/punc_settings.yml``: 3 layers, d_model 64, 8 heads, dff 64,
pe_input 1024, bert 768), from the same weights on the same numpy inputs:
outputs within 1e-5 of each output's largest entry, parameter counts equal,
the converters' round trip bit for bit, and ``PuncDataLoader``'s targets,
windows and batches equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.data.punc_dataloader import (
    PuncDataLoader as JPuncDataLoader,
)
from tensorflowasr_tpu.models import punc as jpunc
from tensorflowasr_tpu.models import vad as jvad
from tensorflowasr_tpu.utils.text import TextFeaturizer as JTextFeaturizer
from tensorflowasr_tpu_torch.data.punc_dataloader import PuncDataLoader
from tensorflowasr_tpu_torch.models import convert, layers
from tensorflowasr_tpu_torch.models import punc as tpunc
from tensorflowasr_tpu_torch.models import vad as tvad
from tensorflowasr_tpu_torch.utils.text import TextFeaturizer

torch.set_num_threads(2)

VOCAB, N_PUNC = 300, 9                  # a synthetic char vocabulary


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def perturbed(variables, seed):
    """Every leaf moved by noise, so biases and norm scales map too (flax
    inits them to constants)."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x, np.float32)
        scale = 0.1 if x.ndim == 1 else 0.3 * np.abs(x).max()
        return (x + scale * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree.map(draw, jax.device_get(variables))


def vad_pair(name, seed, calibrate_on=None, **kw):
    """(flax model, variables, port model). With ``calibrate_on`` frames,
    the ``fc`` bias moves so that half of their logits are positive (a
    random VAD says one thing everywhere)."""
    jmodel = getattr(jvad, name)(**kw)
    variables = perturbed(jmodel.init(jax.random.PRNGKey(seed),
                                      jnp.zeros((1, 8, 80))), seed)
    if calibrate_on is not None:
        logits = jmodel.apply(variables, calibrate_on)[0]
        variables["params"]["fc"]["bias"] -= np.median(np.asarray(logits))
    tmodel = convert.load_flax_variables(getattr(tvad, name)(**kw),
                                         variables)
    return jmodel, variables, tmodel.eval()


def frames(b, n, seed):
    """Framed 8 kHz audio: tone bursts and quiet stretches."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, 80)) * 0.01
    t = np.arange(80) / 8000
    for i in range(b):
        for j in range(0, n, 10):
            if rng.random() < 0.5:
                f = rng.uniform(100, 3000)
                x[i, j:j + 10] += 0.5 * np.sin(2 * np.pi * f * (
                    t + j * 0.01))
    return x.astype(np.float32)


def n_params(tree):
    return sum(int(np.prod(p.shape)) for p in jax.tree.leaves(tree))


@pytest.mark.parametrize("name", ["OnlineVAD", "OfflineVAD"])
def test_vad_matches_jax(name):
    x = frames(2, 120, seed=4)
    jmodel, variables, tmodel = vad_pair(name, seed=3, calibrate_on=x,
                                         dmodel=32, frame_input=80)
    want_logits, want_masked = jax.jit(jmodel.apply)(variables, x)
    with torch.no_grad():
        got_logits, got_masked = tmodel(torch.from_numpy(x))
    assert rel_err(got_logits, want_logits) < 1e-5
    assert rel_err(got_masked, want_masked) < 1e-5
    # the logits decide something: both signs occur
    assert (np.asarray(want_logits) > 0).any() and \
        (np.asarray(want_logits) < 0).any()
    with torch.no_grad():
        np.testing.assert_array_equal(tmodel.infer(torch.from_numpy(x)),
                                      got_logits)
    # parameter counts equal JAX's (~80K at dmodel 32 for the online one)
    assert sum(p.numel() for p in tmodel.parameters()) == \
        n_params(variables) < 150_000


def test_online_vad_is_causal_offline_is_not():
    _, _, online = vad_pair("OnlineVAD", seed=5)
    _, _, offline = vad_pair("OfflineVAD", seed=5)
    x = torch.from_numpy(frames(1, 60, seed=6))
    x2 = x.clone()
    x2[:, 40:] = 0.0
    with torch.no_grad():
        a, b = online(x)[0], online(x2)[0]
        torch.testing.assert_close(a[:, :40], b[:, :40], rtol=0, atol=0)
        assert (a[:, 40:] - b[:, 40:]).abs().max() > 1e-3
        # the dilated convs reach 2 * (1 + 2 + 4 + 8) = 30 frames back
        c, d = offline(x)[0], offline(x2)[0]
        torch.testing.assert_close(c[:, :10], d[:, :10], rtol=0, atol=0)
        assert (c[:, 10:40] - d[:, 10:40]).abs().max() > 1e-3


def punc_pair(seed, cfg=None, vocab=VOCAB, n_punc=N_PUNC,
              calibrate_on=None):
    """(flax model, variables, port model). With ``calibrate_on`` ids, the
    class bias moves by each class's mean logit over them, so that the
    argmax varies (a random model picks one class everywhere)."""
    cfg = cfg or jpunc.PuncConfig()
    jmodel = jpunc.PuncTransformer(cfg, vocab, n_punc)
    variables = perturbed(jmodel.init(jax.random.PRNGKey(seed),
                                      jnp.ones((1, 8), jnp.int32)), seed)
    if calibrate_on is not None:
        logits = np.asarray(jmodel.apply(variables, calibrate_on)[0])
        variables["params"]["final_bd_layer"]["bias"] -= logits[
            calibrate_on != 0].mean(0)
    tcfg = tpunc.PuncConfig(**cfg.__dict__)
    tmodel = convert.load_flax_variables(
        tpunc.PuncTransformer(tcfg, vocab, n_punc), variables)
    return jmodel, variables, tmodel.eval()


def test_punc_matches_jax_with_pad_ids():
    rng = np.random.default_rng(8)
    ids = rng.integers(3, VOCAB, (3, 64)).astype(np.int32)
    ids[:, 0] = 1
    for row, n in enumerate((64, 40, 9)):          # <S> ... </S> then pad
        ids[row, n - 1] = 2
        ids[row, n:] = 0
    jmodel, variables, tmodel = punc_pair(seed=7, calibrate_on=ids)
    want_logits, want_bert = jax.jit(jmodel.apply)(variables, ids)
    with torch.no_grad():
        got_logits, got_bert = tmodel(torch.from_numpy(ids))
    assert rel_err(got_logits, want_logits) < 1e-5
    assert rel_err(got_bert, want_bert) < 1e-5
    classes = np.asarray(want_logits).argmax(-1)
    assert len(np.unique(classes)) > 2


def test_punc_mask_and_norm_traps():
    _, _, tmodel = punc_pair(seed=9)
    assert tmodel.enc_layer_0.ln1.eps == 1e-6
    assert layers.NORM_EPS == 1e-3
    rng = np.random.default_rng(10)
    ids = rng.integers(3, VOCAB, (1, 32))
    ids[0, 20:] = 0
    longer = ids.copy()
    longer[0, 20:] = 5                               # real chars, no pad
    with torch.no_grad():
        a = tmodel(torch.from_numpy(ids))[0][0, :20]
        b = tmodel(torch.from_numpy(longer))[0][0, :20]
    # the padded keys are masked out, real ones are not
    assert (a - b).abs().max() > 1e-3
    ids3 = ids.copy()
    ids3[0, 25] = 0                                  # still pad: no change
    with torch.no_grad():
        c = tmodel(torch.from_numpy(ids3))[0][0, :20]
    torch.testing.assert_close(a, c, rtol=0, atol=0)


@pytest.mark.parametrize("vocab,n_punc", [(5038, 33), (VOCAB, N_PUNC)])
def test_punc_param_count_equals_jax(vocab, n_punc):
    jmodel = jpunc.PuncTransformer(jpunc.PuncConfig(), vocab, n_punc)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.ones((1, 8), jnp.int32))
    tmodel = tpunc.PuncTransformer(tpunc.PuncConfig(), vocab, n_punc)
    n = sum(p.numel() for p in tmodel.parameters())
    assert n == n_params(shapes)
    if vocab == 5038:
        assert 400_000 < n < 1_200_000, n          # the reference's ~600K


@pytest.mark.parametrize("which", ["OnlineVAD", "OfflineVAD", "punc"])
def test_converter_round_trip_is_exact(which):
    if which == "punc":
        _, variables, tmodel = punc_pair(seed=11)
    else:
        _, variables, tmodel = vad_pair(which, seed=11)
    want = convert.flatten(variables)
    got = convert.to_flax_names(tmodel)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def test_converter_refuses_a_tree_that_does_not_fit():
    _, variables, _ = vad_pair("OnlineVAD", seed=1)
    with pytest.raises(KeyError, match="do not fit"):
        convert.load_flax_variables(tvad.OnlineVAD(dmodel=16), variables)
    with pytest.raises(KeyError, match="do not fit"):
        convert.load_flax_variables(tvad.OfflineVAD(), variables)


def test_seeded_init_is_keras():
    model = tpunc.PuncTransformer(tpunc.PuncConfig(), VOCAB, N_PUNC)
    layers.init_weights_(model, torch.Generator().manual_seed(0))
    assert model.embedding.weight.abs().max() <= 0.05
    q = model.enc_layer_0.mha.query.weight
    assert q.abs().max() <= (6 / 128) ** 0.5 and q.abs().max() > 0.15
    conv = model.cnn_0.weight                    # [out, in, k]: fans 3 x 64
    assert conv.abs().max() <= (6 / 384) ** 0.5
    assert model.cnn_0.bias.abs().max() == 0


@pytest.fixture()
def punc_vocab(tmp_path):
    chars = list("abcdefghij")
    (tmp_path / "chars.txt").write_text(
        "\n".join(["<S>", "</S>"] + chars), encoding="utf-8")
    lines = ["ab，cd。", "abc。", "fed，ab。", "ghij" * 20 + "。",
             "a，b，c！", "xyz。", "hij"]
    (tmp_path / "punc.list").write_text("\n".join(lines) + "\n",
                                        encoding="utf-8")
    return tmp_path, lines


def test_punc_dataloader_equals_jax(punc_vocab):
    tmp_path, lines = punc_vocab
    spec = {"vocabulary": str(tmp_path / "chars.txt"), "blank_at_zero": True}
    config = {"running_config": {
        "train_list": str(tmp_path / "punc.list"),
        "eval_list": str(tmp_path / "punc.list"),
        "batch_size": 5, "outdir": None}}
    tokens = ["，", "。", "！"]
    ours = PuncDataLoader(config, TextFeaturizer(spec), tokens, max_len=16)
    theirs = JPuncDataLoader(config, JTextFeaturizer(spec), tokens,
                             max_len=16)
    assert ours.num_punc_classes == theirs.num_punc_classes == 5
    for line in lines:
        assert ours.get_target(line) == theirs.get_target(line)
        got, want = ours.encode_windows(line), theirs.encode_windows(line)
        assert len(got) == len(want)
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    assert len(ours.encode_windows(lines[3])) == 6     # 80 chars / 14
    assert ours.encode_windows("xyz。") == []           # out of vocabulary
    for _ in range(3):
        got, want = ours.generate(True), theirs.generate(True)
        assert sorted(got) == sorted(want) == ["ids", "punc_labels"]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    assert (got["punc_labels"] >= 2).any()
