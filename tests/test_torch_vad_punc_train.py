"""The port's VAD and punctuation training against the JAX package's, on the
CPU, from the same weights and numpy inputs (``tests/test_vad_punc.py``
mirrored): the multi-resolution STFT loss (its framing, its value, its
gradient, and a zero, finite gradient at identical and silent inputs),
``streaming_reshape``, the VAD train step (Online and Offline, with and
without a fold) over three Adam steps, the eval metrics with F1,
``VADDataLoader``'s batches, the punctuation losses, its train step over
three Adam steps at dropout 0 with and without teacher features, dropout in
training, ``punc_recover_ids`` and ``GenericTrainer``'s fit, eval and
checkpoint loop. Values within 1e-5 of each output's (or leaf's) largest
entry unless said otherwise; the JAX side runs jitted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.data import vad_dataloader as jvdl
from tensorflowasr_tpu.models import punc as jpunc
from tensorflowasr_tpu.models import vad as jvad
from tensorflowasr_tpu.ops import stft_loss as jstft
from tensorflowasr_tpu.train import punc_trainer as jpt
from tensorflowasr_tpu.train import state as jstate
from tensorflowasr_tpu.train import vad_trainer as jvt
from tensorflowasr_tpu_torch.data import vad_dataloader as tvdl
from tensorflowasr_tpu_torch.models import convert, layers
from tensorflowasr_tpu_torch.models import punc as tpunc
from tensorflowasr_tpu_torch.models import vad as tvad
from tensorflowasr_tpu_torch.ops import stft_loss as tstft
from tensorflowasr_tpu_torch.train import punc_trainer as tpt
from tensorflowasr_tpu_torch.train import state as tstate
from tensorflowasr_tpu_torch.train import vad_trainer as tvt
from tensorflowasr_tpu_torch.train.base import GenericTrainer
from tensorflowasr_tpu_torch.utils.audio import write_wav

torch.set_num_threads(2)

RESOLUTIONS = [(600, 120, 1024), (250, 50, 512)]   # frame, hop, fft
T = 4003          # torch.stft would give 25 / 67 frames here, not 29 / 76


def t_(a):
    return torch.from_numpy(np.asarray(a))


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def flax_leaves(tree) -> dict:
    return convert.to_torch_names(convert.flatten(
        {"params": jax.tree.map(np.asarray, tree)}))


def assert_params_close(model, jparams, rel=1e-5, skip=()):
    want = flax_leaves(jparams)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith(skip):
            continue
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(),
                                   rtol=0, atol=rel * float(w.abs().max()),
                                   err_msg=k)


# The f32 gradients carry rounding noise: the port's own f32 gradient of the
# VAD loss differs from its float64 one by up to 4.4e-5 of a leaf's largest
# entry (OnlineVAD's audio_voice_mask kernel at the third step below, where
# the STFT loss's silent frames sit near the 1e-7 magnitude floor), and
# JAX's f32 gradient by as much the other way; so gradient leaves are held
# to GRAD_REL of their largest entry (5e-5 in tests/test_torch_chunk_train.py,
# whose model has no such floor). Adam with its
# usual epsilon of 1e-6 turns an entry whose gradient is within that noise
# of 0 into a step of +-lr on the noise's sign (three steps moved one entry
# of the VAD's audio_voice_mask kernel 4.2e-6 apart, 1.7e-5 of its leaf's
# largest entry); epsilon 1 keeps the steps proportional to the gradient,
# so the parameters are held to 1e-5 of each leaf's largest entry with no
# leaf left out. The update at 1e-6 is tested on given gradients in
# tests/test_torch_train.py.
GRAD_REL = 1e-4
ADAM = {"lr": 1e-2, "epsilon": 1.0}


def recording_grads(state) -> list:
    """Wraps ``state.optimizer.step`` to keep each step's gradients."""
    seen, real = [], state.optimizer.step

    def step():
        seen.append({k: p.grad.clone()
                     for k, p in state.model.named_parameters()})
        return real()
    state.optimizer.step = step
    return seen


def jax_step_with_grads(jmodel, loss_fn):
    """A jitted (state, batch) -> (state, loss, grads) applying
    ``loss_fn(params, batch)``'s gradient, as the JAX package's steps do."""
    @jax.jit
    def step(state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, batch)
        return state.apply_gradients(grads=grads), loss, grads
    return step


def assert_grads_close(got, jgrads, what):
    want = flax_leaves(jgrads)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_REL * float(w.abs().max()),
                                   err_msg=f"{what} {k}")


# -- the STFT loss ---------------------------------------------------------

@pytest.mark.parametrize("fl,hop,nfft", RESOLUTIONS)
def test_stft_magnitude_matches_jax_not_torch_stft(fl, hop, nfft):
    x = np.random.default_rng(0).standard_normal((2, T)).astype(np.float32)
    want = np.asarray(jax.jit(jstft.stft_magnitude, static_argnums=(1, 2, 3))(
        x, fl, hop, nfft))
    got = tstft.stft_magnitude(t_(x), fl, hop, nfft)
    assert got.shape == want.shape == (2, 1 + (T - fl) // hop, nfft // 2 + 1)
    assert rel_err(got, want) < 1e-5
    # torch.stft centres the short window in n_fft and frames by n_fft
    lib = torch.stft(t_(x), nfft, hop, win_length=fl,
                     window=torch.hann_window(fl), center=False,
                     return_complex=True).abs()
    assert lib.shape[-1] == 1 + (T - nfft) // hop < got.shape[1]


def test_multi_resolution_loss_and_gradient_match_jax():
    rng = np.random.default_rng(1)
    y = rng.standard_normal((2, T)).astype(np.float32)
    x = (y + 0.3 * rng.standard_normal((2, T))).astype(np.float32)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda x: jstft.multi_resolution_stft_loss(y, x)))(x)
    xt = t_(x).requires_grad_()
    got = tstft.multi_resolution_stft_loss(t_(y), xt)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    # a gradient through two libraries' FFTs: GRAD_REL, as below
    assert rel_err(xt.grad, want_g) < GRAD_REL


def test_loss_zero_and_gradient_finite_at_identical_and_silent_inputs():
    """The eps-guarded norm: identical spectra (all-silence windows) give a
    zero gradient, not 0 / 0."""
    rng = np.random.default_rng(2)
    x = t_(rng.standard_normal((2, 4000)).astype(np.float32))
    noisy = x + 0.5 * t_(rng.standard_normal((2, 4000)).astype(np.float32))
    assert float(tstft.multi_resolution_stft_loss(x, x)) < 1e-4
    assert float(tstft.multi_resolution_stft_loss(x, noisy)) > 1e-2
    for target in (x, torch.zeros(2, 4000)):
        pred = target.clone().requires_grad_()
        tstft.multi_resolution_stft_loss(target, pred).backward()
        assert bool(torch.isfinite(pred.grad).all())
        assert float(pred.grad.abs().max()) == 0.0
    want = jax.grad(lambda y: jstft.multi_resolution_stft_loss(
        jnp.zeros((2, 4000)), y))(jnp.zeros((2, 4000)))
    assert float(jnp.abs(want).max()) == 0.0


# -- VAD --------------------------------------------------------------------

def vad_batch(seed, b=3, n=40, f=80):
    """Voiced tone frames then quiet ones, labels to match; the target is
    the clean tone with silence after it, as the loader's is (the noisy
    input's peak-normalised clean signal). A target that were a scaled copy
    of the input would tie the two log magnitudes exactly in every bin at
    the 1e-7 floor, where |log y - log x| has a kink whose side each
    framework's rounding picks."""
    rng = np.random.default_rng(seed)
    t = np.arange(n * f) / 8000
    x = np.empty((b, n, f), np.float32)
    target = np.zeros((b, n, f), np.float32)
    labels = np.zeros((b, n, 1), np.float32)
    for i in range(b):
        cut = int(rng.integers(n // 4, 3 * n // 4))
        clean = np.zeros(n * f)
        clean[:cut * f] = 0.5 * np.sin(2 * np.pi * rng.uniform(150, 900)
                                       * t[:cut * f])
        x[i] = (clean + 0.01 * rng.standard_normal(n * f)).reshape(n, f)
        target[i] = (clean / np.abs(clean).max()).reshape(n, f)
        labels[i, :cut] = 1.0
    return {"x": x, "labels": labels, "wav_target": target}


def test_vad_losses_match_jax():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 40, 1)) * 3).astype(np.float32)
    labels = vad_batch(3)["labels"]
    for a, b in zip(tvt.vad_mask_loss(t_(labels), t_(logits)),
                    jvt.vad_mask_loss(jnp.asarray(labels),
                                      jnp.asarray(logits))):
        assert float(a) == pytest.approx(float(b), rel=1e-6)
    assert float(tvt.vad_accuracy(t_(labels), t_(logits))) == \
        pytest.approx(float(jvt.vad_accuracy(labels, logits)), abs=1e-7)


def test_streaming_reshape_folds_as_jax():
    batch = vad_batch(4, b=2, n=48)
    got = tvt.streaming_reshape(batch, 8, np.random.default_rng(7))
    want = jvt.streaming_reshape(batch, 8, np.random.default_rng(7))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    n = got["x"].shape[1]
    assert 48 % n == 0 and n >= 8 and got["x"].shape[0] == 2 * 48 // n
    # 11 frames has no divisor >= 8 but itself
    odd = {k: v[:, :11] for k, v in batch.items()}
    assert tvt.streaming_reshape(odd, 8, np.random.default_rng(0))[
        "x"].shape == (2, 11, 80)


def perturbed(variables, seed):
    """Every leaf moved by noise (flax inits biases and norm scales to
    constants), so no leaf starts at 0 and each is held against its own
    size, as in tests/test_torch_vad_punc.py."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x, np.float32)
        top = float(np.abs(x).max())
        scale = 0.3 * top if x.ndim > 1 and top > 0 else 0.1
        return (x + scale * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree.map(draw, jax.device_get(variables))


def vad_models(name, seed=0, dmodel=16):
    jmodel = getattr(jvad, name)(dmodel=dmodel, frame_input=80)
    variables = perturbed(jmodel.init(jax.random.PRNGKey(seed),
                                      jnp.zeros((1, 8, 80))), seed)
    tmodel = convert.load_flax_variables(
        getattr(tvad, name)(dmodel=dmodel, frame_input=80), variables)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "folded"])
@pytest.mark.parametrize("name", ["OnlineVAD", "OfflineVAD"])
def test_vad_three_adam_steps_match_jax(name, fold):
    """The loss over the configured batch (3), whatever the fold makes the
    array's first axis. At each step the metrics and every gradient leaf;
    after three steps the parameters. Once, the JAX package's own step
    takes the step rebuilt here."""
    jmodel, variables, tmodel = vad_models(name)
    jst = jstate.ASRTrainState.create(apply_fn=jmodel.apply,
                                      params=variables["params"],
                                      tx=jstate.make_optimizer(ADAM))

    def loss_fn(params, batch):
        logits, masked = jmodel.apply({"params": params}, batch["x"],
                                      training=True)
        one, zero = jvt.vad_mask_loss(batch["labels"], logits)
        stft = jstft.multi_resolution_stft_loss(batch["wav_target"], masked)
        return ((one + zero) * 10.0 + stft) / 3

    jstep = jax_step_with_grads(jmodel, loss_fn)
    tst = tstate.ASRTrainState(
        tmodel, tstate.make_optimizer(tmodel.parameters(), ADAM),
        torch.Generator().manual_seed(0))
    grads = recording_grads(tst)
    tstep = tvt.make_vad_train_step(tmodel, global_batch=3)
    rng, folded = np.random.default_rng(11), []
    for i in range(3):
        batch = vad_batch(20 + i)
        if fold:
            batch = tvt.streaming_reshape(batch, 8, rng)
            folded.append(batch["x"].shape[0] > 3)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        before = jst
        jst, jloss, jgrads = jstep(jst, jbatch)
        tst, tm = tstep(tst, {k: t_(v) for k, v in batch.items()})
        assert float(tm["train_loss"]) == pytest.approx(float(jloss),
                                                        rel=1e-5), i
        assert_grads_close(grads[i], jgrads, f"grad {i}")
        if i == 0 and name == "OnlineVAD" and not fold:
            real, jm = jvt.make_vad_train_step(
                jmodel, donate=False, global_batch=3)(before, jbatch)
            for a, b in zip(jax.tree.leaves(real.params),
                            jax.tree.leaves(jst.params)):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=0, atol=1e-7)
            assert set(tm) == set(jm)
            for k in jm:
                assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                     abs=1e-6), k
    assert tst.step == 3 and int(jst.step) == 3
    assert not fold or any(folded)
    assert_params_close(tmodel, jst.params)
    start = flax_leaves(variables["params"])
    assert max(float((p.detach() - start[k]).abs().max())
               for k, p in tmodel.named_parameters()) > 1e-3


def test_vad_global_batch_warning_and_divisor():
    _, _, tmodel = vad_models("OnlineVAD")
    with pytest.warns(UserWarning, match="global_batch"):
        step = tvt.make_vad_train_step(tmodel)
    batch = {k: t_(v) for k, v in vad_batch(1, b=2).items()}
    st = tstate.ASRTrainState(tmodel, tstate.make_optimizer(
        tmodel.parameters()), torch.Generator())
    _, m = step(st, batch)
    assert float(m["train_loss"]) == pytest.approx(
        float(m["vad_loss"] * 10 + m["wav_loss"]) / 2, rel=1e-6)


@pytest.mark.parametrize("name", ["OnlineVAD", "OfflineVAD"])
def test_vad_eval_metrics_match_jax(name):
    jmodel, variables, tmodel = vad_models(name, seed=3)
    batch = vad_batch(5)
    # the fc bias at the median logit, so the predictions are mixed
    logits = np.asarray(jmodel.apply(variables, batch["x"])[0])
    variables["params"]["fc"]["bias"] = variables["params"]["fc"]["bias"] \
        - np.median(logits)
    convert.load_flax_variables(tmodel, variables)
    jst = jstate.ASRTrainState.create(apply_fn=jmodel.apply,
                                      params=variables["params"],
                                      tx=jstate.make_optimizer({}))
    want = jvt.make_vad_eval_step(jmodel)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()})
    tst = tstate.ASRTrainState(tmodel, tstate.make_optimizer(
        tmodel.parameters()), torch.Generator())
    got = tvt.make_vad_eval_step(tmodel)(tst, {k: t_(v)
                                               for k, v in batch.items()})
    assert set(got) == set(want) == {"vad_loss", "wav_loss", "vad_acc", "f1"}
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    assert 0.05 < float(got["f1"]) < 0.95
    assert not tmodel.training


def vad_corpus(tmp_path, n=5):
    """8 kHz wavs: tones of 0.3-0.9 s between quiet stretches."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        sr = 8000
        quiet = 0.002 * rng.standard_normal(int(rng.uniform(0.1, 0.4) * sr))
        t = np.arange(int(rng.uniform(0.3, 0.9) * sr)) / sr
        tone = 0.6 * np.sin(2 * np.pi * rng.uniform(150, 900) * t)
        wav = np.concatenate([quiet, tone, quiet[::-1]]).astype(np.float32)
        p = tmp_path / f"v{i}.wav"
        write_wav(str(p), wav, sr)
        paths.append(str(p))
    (tmp_path / "vad.list").write_text("\n".join(paths), encoding="utf-8")
    return str(tmp_path / "vad.list")


@pytest.mark.parametrize("max_frames", [8000, 48000], ids=["crop", "pad"])
def test_vad_dataloader_batches_equal_jax(tmp_path, max_frames):
    lst = vad_corpus(tmp_path)
    config = {"speech_config": {"sample_rate": 8000, "frame_input": 80,
                                "max_frames": max_frames,
                                "voice_thread": 0.4},
              "running_config": {"train_list": lst, "eval_list": lst,
                                 "batch_size": 3},
              "augments_config": {"noise": {"active": False}}}
    got_dl, want_dl = tvdl.VADDataLoader(config), jvdl.VADDataLoader(config)
    for train in (True, True, True, False):
        got, want = got_dl.generate(train), want_dl.generate(train)
        assert got.keys() == want.keys() == {"x", "labels", "wav_target"}
        for k in got:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n = max_frames // 80
    assert got["x"].shape == (3, n, 80) and got["labels"].shape == (3, n, 1)
    assert 0 < got["labels"].mean() < 1
    assert got_dl.train_list == want_dl.train_list       # the shuffles too
    y = np.random.default_rng(1).standard_normal(4000).astype(np.float32)
    y[1000:2500] *= 0.001
    np.testing.assert_array_equal(tvdl.effects_split(y),
                                  jvdl.effects_split(y))
    with pytest.raises(ValueError, match="empty"):
        tvdl.VADDataLoader({**config, "running_config": {}}).generate(True)


# -- punctuation ------------------------------------------------------------

VOCAB, N_PUNC = 50, 6
SMALL_PUNC = dict(num_layers=2, d_model=32, embedding_dim=32, num_heads=4,
                  dff=32, pe_input=128, bert_dim=48)


def punc_batch(seed, b=3, t=20, feats=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, VOCAB, (b, t)).astype(np.int32)
    labels = rng.integers(1, N_PUNC, (b, t)).astype(np.int32)
    labels[rng.random((b, t)) < 0.6] = 1
    for row, n in enumerate((t, t - 6, t - 11)[:b]):
        ids[row, n:] = 0
        labels[row, n:] = 0
    out = {"ids": ids, "punc_labels": labels}
    if feats:
        f = rng.standard_normal((b, t, 48)).astype(np.float32)
        f[ids == 0] = -10.0
        out["bert_features"] = f
    return out


def test_punc_losses_match_jax():
    rng = np.random.default_rng(4)
    batch = punc_batch(4)
    logits = (rng.standard_normal((3, 20, N_PUNC)) * 2).astype(np.float32)
    labels = batch["punc_labels"]
    np.testing.assert_allclose(
        tpt.classes_loss(t_(labels), t_(logits)).numpy(),
        np.asarray(jpt.classes_loss(labels, logits)), rtol=1e-6)
    assert float(tpt.classes_acc(t_(labels), t_(logits))) == pytest.approx(
        float(jpt.classes_acc(labels, logits)), abs=1e-7)
    # unequal lengths (the prediction longer) and -10 pads in the teacher
    feats = batch["bert_features"][:, :17]
    pred = rng.standard_normal((3, 20, 48)).astype(np.float32)
    got = tpt.bert_feature_loss(t_(feats), t_(pred)).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jpt.bert_feature_loss(feats, pred)), rtol=1e-6)
    full = tpt.bert_feature_loss(t_(feats), t_(pred[:, :17])).numpy()
    np.testing.assert_array_equal(got, full)
    # a row whose teacher is all pad costs 0
    feats[2] = -10.0
    assert tpt.bert_feature_loss(t_(feats), t_(pred))[2] == 0.0


def punc_models(seed=0, dropout=0.0):
    jcfg = jpunc.PuncConfig(dropout=dropout, **SMALL_PUNC)
    jmodel = jpunc.PuncTransformer(jcfg, VOCAB, N_PUNC)
    variables = perturbed(jmodel.init(jax.random.PRNGKey(seed),
                                      jnp.ones((1, 8), jnp.int32)), seed)
    tmodel = convert.load_flax_variables(
        tpunc.PuncTransformer(tpunc.PuncConfig(dropout=dropout, **SMALL_PUNC),
                              VOCAB, N_PUNC), variables)
    return jmodel, variables, tmodel


# A key bias shifts every attention logit of a row alike, which the softmax
# ignores: its gradient is 0 in exact arithmetic and rounding noise in both
# frameworks, held against the largest gradient entry anywhere.
KEY_BIAS = ("mha.key.bias",)


@pytest.mark.parametrize("feats", [True, False], ids=["distill", "plain"])
def test_punc_three_adam_steps_match_jax(feats):
    """Dropout 0 (its masks cannot match). At each step the loss and every
    gradient leaf; after three steps the parameters; then the eval step.
    Once, the JAX package's own step takes the step rebuilt here."""
    jmodel, variables, tmodel = punc_models()
    jst = jstate.ASRTrainState.create(apply_fn=jmodel.apply,
                                      params=variables["params"],
                                      tx=jstate.make_optimizer(ADAM))

    def loss_fn(params, batch):
        logits, bert_out = jmodel.apply({"params": params}, batch["ids"],
                                        training=True,
                                        rngs={"dropout": jax.random.key(0)})
        bd = jpt.classes_loss(batch["punc_labels"], logits)
        fm = jpt.bert_feature_loss(batch["bert_features"], bert_out) \
            if "bert_features" in batch else jnp.zeros_like(bd)
        return jnp.mean(bd + 10.0 * fm)

    jstep = jax_step_with_grads(jmodel, loss_fn)
    gen = torch.Generator().manual_seed(0)
    layers.set_generator(tmodel, gen)
    tst = tstate.ASRTrainState(
        tmodel, tstate.make_optimizer(tmodel.parameters(), ADAM), gen)
    grads = recording_grads(tst)
    tstep = tpt.make_punc_train_step(tmodel)
    for i in range(3):
        batch = punc_batch(30 + i, feats=feats)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        before = jst
        jst, jloss, jgrads = jstep(jst, jbatch)
        tst, tm = tstep(tst, {k: t_(v) for k, v in batch.items()})
        assert float(tm["train_loss"]) == pytest.approx(float(jloss),
                                                        rel=1e-5), i
        assert (float(tm["feature_map_loss"]) > 0) == feats
        want = flax_leaves(jgrads)
        top = max(float(w.abs().max()) for w in want.values())
        for k in KEY_BIAS:
            for name in [n for n in want if n.endswith(k)]:
                assert float(grads[i][name].abs().max()) < 1e-5 * top
                grads[i][name] = want[name]
        assert_grads_close(grads[i], jgrads, f"grad {i}")
        if i == 0 and feats:
            real, jm = jpt.make_punc_train_step(jmodel, donate=False)(
                before, jbatch, jax.random.PRNGKey(0))
            for a, b in zip(jax.tree.leaves(real.params),
                            jax.tree.leaves(jst.params)):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=0, atol=1e-7)
            assert set(tm) == set(jm)
            for k in jm:
                assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                     abs=1e-6), k
    assert_params_close(tmodel, jst.params)
    start = flax_leaves(variables["params"])
    assert max(float((p.detach() - start[k]).abs().max())
               for k, p in tmodel.named_parameters()) > 1e-3

    batch = punc_batch(40, feats=feats)
    want = jpt.make_punc_eval_step(jmodel)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()})
    out = tpt.make_punc_eval_step(tmodel)(tst, {k: t_(v)
                                               for k, v in batch.items()})
    assert set(out) == set(want)
    for k in want:
        assert float(out[k]) == pytest.approx(float(want[k]), rel=1e-5), k
    assert not tmodel.training


def test_punc_dropout_is_active_in_training():
    """Dropout masks come from the state's generator: two train-mode passes
    differ, a generator reset repeats a pass, eval mode has none."""
    _, _, tmodel = punc_models(dropout=0.1)
    gen = torch.Generator().manual_seed(3)
    layers.set_generator(tmodel, gen)
    ids = t_(punc_batch(1)["ids"])
    tmodel.train()
    state = gen.get_state()
    with torch.no_grad():
        a = tmodel(ids)[0]
        b = tmodel(ids)[0]
        gen.set_state(state)
        c = tmodel(ids)[0]
    assert float((a - b).abs().max()) > 1e-3
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    tmodel.eval()
    torch.testing.assert_close(tmodel(ids)[0], tmodel(ids)[0], rtol=0,
                               atol=0)
    # the train step draws from it too: the same batch, two losses
    st = tstate.ASRTrainState(tmodel, tstate.make_optimizer(
        tmodel.parameters(), {"lr": 0.0}), gen)
    step = tpt.make_punc_train_step(tmodel)
    batch = {k: t_(v) for k, v in punc_batch(2).items()}
    losses = [float(step(st, batch)[1]["train_loss"]) for _ in range(2)]
    assert losses[0] != losses[1]


def test_punc_recover_ids_matches_jax():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((4, 30, N_PUNC)) * 3).astype(np.float32)
    logits[0, :, 1] += 40.0                       # "no punctuation" wins
    logits[1, :, 3] += 40.0                       # class 3 everywhere
    got = tpt.punc_recover_ids(t_(logits)).numpy()
    want = np.asarray(jpt.punc_recover_ids(logits))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert (got[0] == 0).all() and (got[1] == 3).all()
    assert set(np.unique(got[2:])) - {0} and (got[2:] == 0).any()
    np.testing.assert_array_equal(
        tpt.punc_recover_ids(t_(logits), 0.9).numpy(),
        np.asarray(jpt.punc_recover_ids(logits, 0.9)))


# -- GenericTrainer -----------------------------------------------------------

def test_generic_trainer_fits_evaluates_and_resumes(tmp_path):
    rc = {"log_interval_steps": 2, "save_interval_steps": 2,
          "eval_interval_steps": 2}

    def build():
        _, _, tmodel = vad_models("OnlineVAD", seed=1)
        st = tstate.ASRTrainState(
            tmodel, tstate.make_optimizer(tmodel.parameters(), {"lr": 1e-3}),
            torch.Generator())
        return GenericTrainer(st, tvt.make_vad_train_step(tmodel, 3),
                              tvt.make_vad_eval_step(tmodel),
                              str(tmp_path), running_config=rc)

    def batches(seed):
        while True:
            yield vad_batch(seed)

    trainer = build()
    assert trainer.device == torch.device("cpu")
    trainer.fit(batches(0), eval_iter=batches(1), total_steps=4)
    logged = [line for line in
              (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(logged) == 4 and '"split": "eval"' in logged[1]
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == [
        "ckpt_000000002.pt", "ckpt_000000004.pt"]
    resumed = build()
    assert resumed.restore() and resumed.state.step == 4
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(v, resumed.state.model.state_dict()[k]), k
    em = resumed.evaluate(batches(1), max_batches=2)
    assert set(em) == {"vad_loss", "wav_loss", "vad_acc", "f1"}
