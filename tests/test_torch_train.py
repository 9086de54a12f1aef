"""The port's training path against the JAX package's, on the CPU.

A tiny ConformerCTC (dmodel 32, 2 blocks, 2 x 16 heads, kernel 8) gets the
same weights in both frameworks (flax variables drawn from a numpy seed,
moved by ``models/convert.py``), the same numpy batch and dropout 0; losses,
metrics, every gradient leaf, the BatchNorm running statistics and the
parameters after three Adam steps are then compared. Dropout masks cannot
match across frameworks and have tests of their own
(``tests/test_torch_layers.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from tensorflowasr_tpu.models import conformer as jconf
from tensorflowasr_tpu.train import asr_trainer as jtrain
from tensorflowasr_tpu.train import state as jstate
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.train import asr_trainer as ttrain
from tensorflowasr_tpu_torch.train import state as tstate
from tensorflowasr_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowasr_tpu_torch.utils.audio import write_wav

torch.set_num_threads(2)

N_PHONE, N_CHAR, BLANK = 11, 17, 10
TINY = dict(dmodel=32, num_blocks=2, head_size=16, num_heads=2,
            kernel_size=8, ctcdecoder_num_blocks=1, ctcdecoder_kernel_size=8,
            translator_num_blocks=2, translator_kernel_size=8,
            dropout=0.0, ctcdecoder_dropout=0.0, translator_dropout=0.0)


def randomize(shapes, seed):
    """Every leaf from a numpy seed. Biases are drawn small (0.02): the
    batch-statistics variance E[x^2] - E[x]^2 loses digits where a channel's
    |mean| dwarfs its deviation, in both frameworks alike, and gradients
    through it would then differ by more than the tolerances below."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        scale = 0.02 if path[-1].key == "bias" else 0.2
        return (rng.standard_normal(x.shape) * scale).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def both_models(seed=7, **kw):
    jcfg = jconf.ConformerConfig(**TINY, **kw)
    jmodel = jconf.ConformerCTC(jcfg, N_PHONE, N_CHAR)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3200), jnp.float32),
                            jnp.ones((1, 4), jnp.int32))
    variables = randomize(shapes, seed)
    tcfg = tconf.ConformerConfig(**TINY, **kw)
    tmodel = tconf.ConformerCTC(tcfg, N_PHONE, N_CHAR)
    tmodel.load_state_dict(convert.convert_flax_variables(variables, tcfg))
    return jmodel, variables, tmodel


def make_batch(seed=0, b=3, t=9600, l=6, u=5):
    """Ragged phone and char lengths (zero padded), one short input."""
    rng = np.random.default_rng(seed)
    phones = rng.integers(1, BLANK, (b, l)).astype(np.int32)
    chars = rng.integers(1, N_CHAR, (b, u)).astype(np.int32)
    phone_length = np.array([l, l - 2, l - 1], np.int32)[:b]
    for i, n in enumerate(phone_length):
        phones[i, n:] = 0
    chars[1, u - 2:] = 0
    return {
        "wav": (rng.standard_normal((b, t)) * 0.1).astype(np.float32),
        "input_length": np.array([t // 640, t // 640 - 4, t // 640],
                                 np.int32)[:b],
        "phones": phones, "phone_length": phone_length, "chars": chars,
    }


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def torch_leaves(tree):
    """A flax params-shaped tree (parameters or gradients) -> torch names."""
    return convert.to_torch_names(convert.flatten(
        {"params": jax.tree.map(np.asarray, tree)}))


# Parameters whose gradient is zero in exact arithmetic: a bias in front of
# a BatchNorm's batch statistics is subtracted again with the batch mean,
# and a key bias shifts every attention logit of a row alike, which softmax
# ignores. Both frameworks compute rounding noise there (about 1e-6), and
# Adam's g / (|g| + eps) turns noise of that size into steps of up to lr.
ZERO_GRADIENT = ("dw_conv.bias", "dw_pw.bias", "key.bias")


def assert_leaves_close(got, want, rel, what, skip=()):
    """Each leaf within ``rel`` of the largest entry of its reference."""
    assert set(got) == set(want)
    for name in want:
        if name.endswith(skip):
            continue
        w = want[name].numpy()
        g = got[name].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=rel * np.abs(w).max(),
                                   err_msg=f"{what} {name}")


# -- losses and metrics -------------------------------------------------------

def _labels_logits(seed, b=4, u=7, v=N_CHAR):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, v, (b, u)).astype(np.int32)
    labels[0, 4:] = 0
    labels[2] = 0
    logits = (rng.standard_normal((b, u, v)) * 2).astype(np.float32)
    return labels, logits


def test_mask_loss_matches_jax():
    labels, logits = _labels_logits(0)
    want = np.asarray(jtrain.mask_loss(jnp.asarray(labels),
                                       jnp.asarray(logits)))
    got = ttrain.mask_loss(torch.from_numpy(labels),
                           torch.from_numpy(logits)).numpy()
    # values near 3; f32 sums in two orders
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t", [4, 7, 12], ids=["shorter", "equal", "longer"])
def test_ctc_acc_matches_jax(t):
    labels, _ = _labels_logits(1, v=BLANK)
    decoded = np.random.default_rng(2).integers(0, BLANK, (4, t)).astype(
        np.int32)
    decoded[:, :3] = labels[:, :3]
    want = float(jtrain.ctc_acc(jnp.asarray(labels), jnp.asarray(decoded)))
    got = float(ttrain.ctc_acc(torch.from_numpy(labels),
                               torch.from_numpy(decoded)))
    assert got == pytest.approx(want, abs=1e-6)


def test_translate_acc_matches_jax():
    labels, logits = _labels_logits(3)
    wide = np.concatenate([logits, logits[:, :3]], axis=1)   # width > U
    for i in range(4):
        for j in range(0, 7, 2):
            wide[i, j, labels[i, j]] = 50.0
    want = float(jtrain.translate_acc(jnp.asarray(labels), jnp.asarray(wide)))
    got = float(ttrain.translate_acc(torch.from_numpy(labels),
                                     torch.from_numpy(wide)))
    assert got == pytest.approx(want, abs=1e-6)
    assert 0.3 < got < 1.0


# -- the train step -----------------------------------------------------------

def test_loss_metrics_and_every_gradient_leaf_match_jax():
    jmodel, variables, tmodel = both_models()
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def f(params):
        return jtrain._loss_and_metrics(
            jmodel, params, variables["batch_stats"], jbatch,
            jax.random.PRNGKey(0), BLANK, True)

    # XLA's multi-threaded Eigen splits its sums by the host's core count,
    # so the reference gradients differ from host to host (one read 1.5x
    # the bound below on a pointwise conv's kernel); single-threaded they
    # are the same at any core count. The port's side runs on 2 threads.
    (want_loss, (want_metrics, want_stats)), want_grads = jax.jit(
        jax.value_and_grad(f, has_aux=True)).lower(variables["params"]) \
        .compile({"xla_cpu_multi_thread_eigen": False})(variables["params"])

    total, metrics = ttrain.loss_and_metrics(tmodel.train(), to_torch(batch),
                                             BLANK)
    total.backward()
    # f32 end to end: loss near 60, summation order only
    assert float(total.detach()) == pytest.approx(float(want_loss),
                                                  rel=1e-5)
    assert set(metrics) == set(want_metrics)
    for k, v in want_metrics.items():
        assert float(metrics[k]) == pytest.approx(float(v), rel=1e-5,
                                                  abs=1e-6), k
    grads = {k: p.grad for k, p in tmodel.named_parameters()}
    assert all(g is not None for g in grads.values())
    # each leaf to 1e-5 of its largest entry; the leaves that are zero in
    # exact arithmetic to 1e-5 of the largest gradient entry anywhere
    want_grads = torch_leaves(want_grads)
    assert_leaves_close(grads, want_grads, 1e-5, "grad", skip=ZERO_GRADIENT)
    top = max(float(g.abs().max()) for g in want_grads.values())
    noise = [k for k in grads if k.endswith(ZERO_GRADIENT)]
    assert len(noise) == 5 * 3       # five blocks, three such biases each
    for k in noise:
        assert float(grads[k].abs().max()) < 1e-5 * top, k
        assert float(want_grads[k].abs().max()) < 1e-5 * top, k
    stats = convert.to_torch_names(convert.flatten(
        {"batch_stats": jax.tree.map(np.asarray, want_stats)}))
    assert_leaves_close(dict(tmodel.named_buffers()), stats, 1e-5, "stat")


def test_three_adam_steps_match_jax():
    jmodel, variables, tmodel = both_models(seed=8)
    oc = {"lr": 1e-3}
    tx = jstate.make_optimizer(oc)
    jst = jstate.ASRTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"], tx=tx,
        batch_stats=variables["batch_stats"])
    jstep = jtrain.make_train_step(jmodel, tx, BLANK, donate=False)
    tst = tstate.ASRTrainState(
        tmodel, tstate.make_optimizer(tmodel.parameters(), oc),
        torch.Generator().manual_seed(0))
    tstep = ttrain.make_train_step(BLANK)
    for i in range(3):
        batch = make_batch(seed=10 + i)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(1))
        tst, tm = tstep(tst, to_torch(batch))
        assert float(tm["train_loss"]) == pytest.approx(
            float(jm["train_loss"]), rel=2e-5), i
    assert tst.step == 3 and int(jst.step) == 3
    # Adam's first steps move every weight by about lr = 1e-3, whatever the
    # gradient's size; each leaf is held to 1e-5 of its largest entry
    assert_leaves_close(dict(tmodel.named_parameters()),
                        torch_leaves(jst.params), 1e-5, "param",
                        skip=ZERO_GRADIENT)
    start = torch_leaves(variables["params"])
    moved = {k: float((p.detach() - start[k]).abs().max())
             for k, p in tmodel.named_parameters()}
    assert max(moved.values()) > 1e-3
    # the noise-driven leaves took at most three steps of size lr
    assert all(v <= 3.001e-3 for k, v in moved.items()
               if k.endswith(ZERO_GRADIENT))
    stats = convert.to_torch_names(convert.flatten(
        {"batch_stats": jax.tree.map(np.asarray, jst.batch_stats)}))
    buffers = dict(tmodel.named_buffers())
    assert_leaves_close(buffers, stats, 1e-5, "stat", skip=("running_mean",))
    # a running mean follows the noise-driven biases in front of it (by
    # 0.01 a step of what they moved, up to 3e-3 through a 32-wide kernel
    # of entries near 0.2); the variance is blind to such a shift
    for k in stats:
        if k.endswith("running_mean"):
            np.testing.assert_allclose(buffers[k].numpy(), stats[k].numpy(),
                                       rtol=0, atol=2e-4, err_msg=k)


def test_eval_step_matches_jax_and_leaves_the_state_alone():
    jmodel, variables, tmodel = both_models(seed=9)
    batch = make_batch(seed=4)
    jst = jstate.ASRTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        tx=jstate.make_optimizer(), batch_stats=variables["batch_stats"])
    want = jtrain.make_eval_step(jmodel, BLANK)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()})
    tst = tstate.ASRTrainState(
        tmodel.train(), tstate.make_optimizer(tmodel.parameters()),
        torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    got = ttrain.make_eval_step(BLANK)(tst, to_torch(batch))
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(float(v), rel=1e-5, abs=1e-6), k
    assert not tmodel.training and tst.step == 0
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, before[k]), k


# -- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("dmodel,warmup", [(144, 10000), (32, 7)])
def test_transformer_schedule_matches_jax(dmodel, warmup):
    want = jstate.transformer_schedule(dmodel, warmup)
    got = tstate.transformer_schedule(dmodel, warmup)
    for count in (0, 1, 2, warmup, 10 * warmup):
        assert got(count) == pytest.approx(
            float(want(jnp.asarray(count))), rel=1e-6), count
    assert got(0) == got(1)           # the count starts at 0: max(count, 1)
    assert got(warmup) > got(10 * warmup) and got(warmup) > got(2)


def _grad_sequence(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((4, 3)) * 10 ** rng.uniform(-3, 1)
                   ).astype(np.float32),
             "b": rng.standard_normal(3).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_warmup=True),
    dict(grad_clip_norm=0.5),
    dict(accum=2),
    dict(accum=3, grad_clip_norm=0.5, use_warmup=True),
], ids=["adam", "warmup", "clip", "accum2", "accum3_clip_warmup"])
def test_optimizer_matches_optax_on_given_gradients(kw):
    """Adam lr 1e-3 / 0.9 / 0.98 / 1e-6, the warmup schedule's count,
    global-norm clipping and MultiSteps accumulation (the mean of k
    micro-gradients, an update every k-th call, clipping on the mean): six
    calls with the same gradients."""
    kw = dict(kw)
    accum = kw.pop("accum", 1)
    oc = {"lr": 1e-3, "warmup_steps": 3, "grad_accum_steps": accum}
    params = {"w": np.full((4, 3), 0.5, np.float32),
              "b": np.zeros(3, np.float32)}
    tx = jstate.make_optimizer(oc, dmodel=32, **kw)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = tstate.make_optimizer(tparams.values(), oc, dmodel=32, **kw)
    for i, grads in enumerate(_grad_sequence(6)):
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            g = torch.from_numpy(grads[k])
            p.grad = g.clone() if p.grad is None else p.grad + g
        updated = opt.step()
        assert updated == ((i + 1) % accum == 0)
        for k in params:
            # a few f32 ulps of values up to 0.7
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), np.asarray(jparams[k]),
                rtol=1e-6, atol=1e-7, err_msg=f"call {i} {k}")
    assert opt.count == 6 // accum


def test_grad_accum_two_halves_equal_one_full_batch():
    """k = 2 over the two halves of a batch gives the update k = 1 gives on
    the whole batch (a per-example mean loss), and the first half alone
    updates nothing."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((8, 2)).astype(np.float32))

    def run(accum, pieces):
        lin = torch.nn.Linear(5, 2)
        with torch.no_grad():
            lin.weight.fill_(0.1)
            lin.bias.zero_()
        opt = tstate.make_optimizer(
            lin.parameters(), {"lr": 1e-2, "grad_accum_steps": accum})
        seen = []
        for _ in range(3):
            for xs, ys in pieces:
                ((lin(xs) - ys) ** 2).mean().backward()
                opt.step()
                seen.append(lin.weight.detach().clone())
        return seen

    full = run(1, [(x, y)])
    halves = run(2, [(x[:4], y[:4]), (x[4:], y[4:])])
    assert torch.equal(halves[0], torch.full((2, 5), 0.1))
    for i in range(3):
        torch.testing.assert_close(halves[2 * i + 1], full[i], rtol=0,
                                   atol=1e-6)


# -- trainer, checkpoints -----------------------------------------------------

def tiny_config(outdir, **model_kw):
    return {
        "model_config": {"dmodel": 32, "num_blocks": 2, "head_size": 8,
                         "num_heads": 2, "kernel_size": 8,
                         "ctcdecoder_num_blocks": 1,
                         "translator_num_blocks": 1, **model_kw},
        "speech_config": {}, "optimizer_config": {"lr": 5e-3},
        "running_config": {"outdir": str(outdir), "log_interval_steps": 2,
                           "save_interval_steps": 2,
                           "eval_interval_steps": 1000},
    }


def tone_batch():
    """The two utterances of ``tests/test_overfit.py``."""
    sr = 16000
    t = np.arange(sr) / sr
    wav = np.stack([
        0.5 * np.sin(2 * np.pi * 220 * t),
        0.5 * np.sin(2 * np.pi * 550 * t) * np.sign(np.sin(2 * np.pi * 3 * t)),
    ]).astype(np.float32)
    return {"wav": wav, "input_length": np.array([25, 25], np.int32),
            "phones": np.array([[1, 2, 3], [4, 5, 6]], np.int32),
            "phone_length": np.array([3, 3], np.int32),
            "chars": np.array([[2, 3, 1], [4, 5, 1]], np.int32),
            "char_length": np.array([3, 3], np.int32)}


def new_trainer(outdir, **model_kw):
    trainer = ttrain.CTCTrainer(tiny_config(outdir, **model_kw), 8, 10, 7,
                                device="cpu")
    trainer.init_state(seed=0)
    return trainer


def test_checkpoint_round_trip_resumes_the_same_run(tmp_path):
    """Dropout 0.1 is on: a run resumed from step 2 takes the step an
    uninterrupted run takes, bit for bit, because parameters, BatchNorm
    buffers, Adam moments, the step and the generator state all come back."""
    batch = tone_batch()
    straight = new_trainer(tmp_path / "a")
    b = straight._prepare_batch(batch)
    for _ in range(3):
        straight.train_step(straight.state, b)

    first = new_trainer(tmp_path / "b")
    for _ in range(2):
        first.train_step(first.state, b)
    first.save()
    resumed = new_trainer(tmp_path / "b")
    assert resumed.restore()
    assert resumed.state.step == 2 and resumed.state.optimizer.count == 2
    _, metrics = resumed.train_step(resumed.state, b)
    assert resumed.state.step == 3
    want = straight.state.model.state_dict()
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert torch.isfinite(metrics["train_loss"])
    assert not new_trainer(tmp_path / "empty").restore()


def test_train_step_marks_its_stages_and_takes_the_same_step(tmp_path):
    """A step built with ``mark`` reports its four stages in order and
    moves the state exactly as the unmarked step does."""
    plain, marked = new_trainer(tmp_path / "a"), new_trainer(tmp_path / "b")
    batch = plain._prepare_batch(tone_batch())
    stages = []
    step = ttrain.make_train_step(marked.blank_id, mark=stages.append)
    plain.train_step(plain.state, batch)
    step(marked.state, batch)
    assert stages == ["forward", "loss", "backward", "optimizer"]
    assert marked.state.step == 1 and marked.state.optimizer.count == 1
    want = plain.state.model.state_dict()
    for k, v in marked.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_checkpoint_manager_keeps_the_newest_and_writes_whole_files(tmp_path):
    trainer = new_trainer(tmp_path)
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    assert mgr.latest_step() is None
    assert mgr.restore_latest(trainer.state) is None
    for step in (1, 2, 5, 9, 10):
        mgr.save(step, trainer.state)
    assert mgr.all_steps() == [5, 9, 10] and mgr.latest_step() == 10
    assert sorted(os.listdir(tmp_path / "ck")) == [
        "ckpt_000000005.pt", "ckpt_000000009.pt", "ckpt_000000010.pt"]
    # a stray temporary file (a writer that died) is not a checkpoint
    (tmp_path / "ck" / "ckpt_000000011.pt.tmp.1").write_bytes(b"half")
    assert mgr.latest_step() == 10
    assert mgr.restore_latest(trainer.state) is trainer.state


def test_checkpoint_keeps_pending_micro_gradients(tmp_path):
    cfg = tiny_config(tmp_path)
    cfg["optimizer_config"]["grad_accum_steps"] = 2
    batch = tone_batch()

    def trainer():
        t = ttrain.CTCTrainer(cfg, 8, 10, 7, device="cpu")
        t.init_state(seed=0)
        return t

    straight = trainer()
    b = straight._prepare_batch(batch)
    for _ in range(2):
        straight.train_step(straight.state, b)
    first = trainer()
    first.train_step(first.state, b)          # half an update
    first.save()
    resumed = trainer()
    assert resumed.restore() and resumed.state.optimizer.mini_step == 1
    resumed.train_step(resumed.state, b)
    want = straight.state.model.state_dict()
    for k, v in resumed.state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_fit_logs_at_intervals_and_saves(tmp_path):
    trainer = new_trainer(tmp_path)
    batch = tone_batch()

    def batches():
        while True:
            yield batch

    trainer.fit(batches(), eval_iter=None, total_steps=5)
    lines = [json.loads(line) for line in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [2, 4]
    for m in lines:
        assert np.isfinite(m["train_loss"]) and "audio_seconds_per_s" in m
        assert {"ctc_loss", "translate_loss", "ctc_acc",
                "translate_acc"} <= set(m)
    assert trainer.checkpoint_manager.all_steps() == [2, 4]
    assert trainer.state.step == 5
    em = trainer.evaluate(iter([batch, batch]))
    assert np.isfinite(em["train_loss"])
    assert trainer.evaluate(iter([])) == {}


def test_trainer_requires_blank_last_and_a_card_for_cuda(tmp_path):
    with pytest.raises(ValueError, match="blank as the last class"):
        ttrain.CTCTrainer(tiny_config(tmp_path), 8, 10, 0, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.CTCTrainer(tiny_config(tmp_path), 8, 10, 7)


def test_overfit_two_utterances(tmp_path):
    """Port of ``tests/test_overfit.py``: the tiny model overfits two
    utterances until greedy CTC decodes them exactly IN EVAL MODE, which
    needs the loss, the decode, the optimizer and the BatchNorm running
    statistics (momentum 0.99: several hundred steps to catch up) to agree."""
    from tensorflowasr_tpu_torch.eval.testers import AMTester

    trainer = new_trainer(tmp_path, dropout=0.0)
    batch = tone_batch()
    b = trainer._prepare_batch(batch)
    for _ in range(600):
        _, metrics = trainer.train_step(trainer.state, b)
    assert float(metrics["ctc_acc"]) > 0.999
    result = AMTester(trainer, char_end_id=1).run(iter([batch]))
    assert result["phone_cer"] == 0.0 and result["phone_N"] == 6, result
    assert not trainer.state.model.training


# -- CLI ----------------------------------------------------------------------

def _sine(freq, seconds, sr=16000, amp=0.5):
    t = np.arange(int(seconds * sr)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.fixture()
def configs(tmp_path):
    """The synthetic corpus of ``tests/test_cli.py``."""
    sr = 16000
    lines = []
    texts = ["ni3 hao3", "shi4 jie4", "ni3 shi4", "hao3 jie4"]
    for i, txt in enumerate(texts):
        p = tmp_path / f"u{i}.wav"
        write_wav(str(p), _sine(200 + 40 * i, 1.0), sr)
        lines.append(f"{p}\t{txt}")
    (tmp_path / "train.list").write_text("\n".join(lines), encoding="utf-8")
    (tmp_path / "phones.txt").write_text(
        "\n".join(["n", "i3", "h", "ao3", "sh", "i4", "j", "ie4"]),
        encoding="utf-8")
    (tmp_path / "chars.txt").write_text(
        "\n".join(["<S>", "</S>", "ni3", "hao3", "shi4", "jie4"]),
        encoding="utf-8")
    (tmp_path / "p2p.map").write_text(
        "ni3\tn i3\nhao3\th ao3\nshi4\tsh i4\njie4\tj ie4\n",
        encoding="utf-8")
    data_cfg = {
        "speech_config": {
            "sample_rate": sr, "stride_ms": 10, "reduction_factor": 4,
            "wav_max_duration": 2, "train_list": str(tmp_path / "train.list"),
            "eval_list": str(tmp_path / "train.list"),
            "pinyin_map": str(tmp_path / "p2p.map"),
            "transcripts_are_pinyin": True,
        },
        "inp_config": {"vocabulary": str(tmp_path / "phones.txt"),
                       "blank_at_zero": False},
        "tar_config": {"vocabulary": str(tmp_path / "chars.txt"),
                       "blank_at_zero": False},
        "augments_config": None,
        "optimizer_config": {"lr": 0.003},
        "running_config": {"batch_size": 2, "log_interval_steps": 2,
                           "eval_interval_steps": 1000,
                           "save_interval_steps": 4,
                           "outdir": str(tmp_path / "logs")},
    }
    model_cfg = {
        "model_config": {
            "name": "OfflineConformerCTC", "dmodel": 32, "num_blocks": 1,
            "head_size": 8, "num_heads": 2, "kernel_size": 8,
            "ctcdecoder_num_blocks": 1, "translator_num_blocks": 1,
            "dropout": 0.0,
        }
    }
    dp, mp = tmp_path / "data.yml", tmp_path / "model.yml"
    dp.write_text(yaml.dump(data_cfg), encoding="utf-8")
    mp.write_text(yaml.dump(model_cfg), encoding="utf-8")
    return tmp_path, str(dp), str(mp), model_cfg


def test_train_eval_cli(configs, capsys):
    tmp_path, data_yml, model_yml, _ = configs
    from tensorflowasr_tpu_torch.cli.eval_am import main as eval_main
    from tensorflowasr_tpu_torch.cli.train_asr import main as train_main

    common = ["--data_config", data_yml, "--model_config", model_yml,
              "--compute_dtype", "float32", "--device", "cpu"]
    assert train_main(common + ["--total_steps", "4"]) == 0
    assert os.listdir(tmp_path / "logs" / "checkpoints") == [
        "ckpt_000000004.pt"]
    lines = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2
    assert np.isfinite(json.loads(lines[-1])["train_loss"])

    capsys.readouterr()
    assert eval_main(common + ["--max_batches", "2"]) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    result = json.loads(captured.out.strip().splitlines()[-1])
    assert {"phone_cer", "phone_ser", "char_cer", "char_ser", "phone_S",
            "phone_D", "phone_I", "phone_N"} <= set(result)
    assert result["phone_N"] == 16 and result["char_N"] == 8

    # a second call resumes from step 4 and goes on to step 6
    assert train_main(common + ["--total_steps", "2",
                                "--data_workers", "0"]) == 0
    lines = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["step"] == 6


def save_as_jax_checkpoint(jtrainer, model, step: int) -> None:
    """The port ``model``'s weights into the JAX trainer's state at
    ``step``, saved where the JAX package's CLIs restore from."""
    nested = {}
    for name, arr in convert.to_flax_names(model).items():
        node = nested
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    jtrainer.state = jtrainer.state.replace(
        params=nested["params"], batch_stats=nested["batch_stats"],
        step=jnp.asarray(step))
    jtrainer.save()


def test_eval_cli_scores_in_f32_as_jax(configs, capsys, monkeypatch):
    """``cli.eval_am`` without ``--compute_dtype`` builds its trainer in
    f32, as the JAX package's ``eval_am`` does (it builds ``CTCTrainer``
    without a dtype), and prints the JAX CLI's error rates on the same
    weights. The flag's default, bfloat16, is for training only."""
    from tensorflowasr_tpu.cli.eval_am import main as jax_eval_main
    from tensorflowasr_tpu.utils.config import UserConfig as JConfig
    from tensorflowasr_tpu_torch.cli import eval_am
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.cli.train_asr import main as train_main
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    tmp_path, data_yml, model_yml, model_cfg = configs
    common = ["--data_config", data_yml, "--model_config", model_yml,
              "--device", "cpu"]
    assert train_main(common + ["--compute_dtype", "float32",
                                "--total_steps", "4",
                                "--data_workers", "0"]) == 0
    built, real_setup = [], eval_am.offline_ctc_setup

    def setup(*args):
        dl, trainer, char_f = real_setup(*args)
        built.append(trainer.model_cfg.dtype_str)
        return dl, trainer, char_f

    monkeypatch.setattr(eval_am, "offline_ctc_setup", setup)
    capsys.readouterr()
    assert eval_am.main(common + ["--max_batches", "2"]) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    assert built == ["float32"]
    got = json.loads(captured.out.strip().splitlines()[-1])

    # the same weights through the JAX package's eval_am
    config = UserConfig(data_yml, model_yml)
    phone_f, char_f = build_featurizers(config)[:2]
    trainer = ttrain.CTCTrainer(config, phone_f.num_classes,
                                char_f.num_classes, phone_f.blank,
                                device="cpu")
    trainer.init_state()
    assert trainer.restore() and trainer.state.step == 4
    jax_model_yml = tmp_path / "jm.yml"
    jax_model_yml.write_text(yaml.dump({**model_cfg, "running_config": {
        "batch_size": 2, "outdir": str(tmp_path / "jax_logs")}}))
    jtrainer = jtrain.CTCTrainer(JConfig(data_yml, str(jax_model_yml)),
                                 phone_f.num_classes, char_f.num_classes,
                                 blank_id=phone_f.blank)
    jtrainer.init_state({"wav": np.zeros((1, 3200), np.float32),
                         "phones": np.ones((1, 4), np.int32)})
    save_as_jax_checkpoint(jtrainer, trainer.state.model, 4)
    assert jax_eval_main(["--data_config", data_yml, "--model_config",
                          str(jax_model_yml), "--max_batches", "2"]) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    want = json.loads(captured.out.strip().splitlines()[-1])
    assert got == want
    assert got["phone_N"] == 16 and got["char_N"] == 8


def test_cli_refuses_what_is_not_ported(configs, capsys):
    """Nothing these CLIs take is refused any more: ``--data_procs`` trains
    from worker processes (tests/test_torch_prefetch.py), ``--lm`` and
    ``--word_lm`` score with the beam and the LM (tests/test_torch_lm_cli.py
    holds them to JAX's)."""
    tmp_path, data_yml, model_yml, model_cfg = configs
    from tensorflowasr_tpu_torch.cli.eval_am import main as eval_main
    from tensorflowasr_tpu_torch.cli.train_asr import main as train_main
    from tensorflowasr_tpu_torch.cli.train_lm import main as train_lm

    common = ["--data_config", data_yml, "--model_config", model_yml,
              "--device", "cpu"]
    assert train_main(common + ["--data_procs", "2", "--total_steps", "1",
                                "--compute_dtype", "float32"]) == 0
    lm = str(tmp_path / "lm.npz")
    assert train_lm(["--data_config", data_yml, "--order", "2",
                     "--output", lm]) == 0
    words = tmp_path / "words.arpa"
    words.write_text("\\data\\\nngram 1=2\nngram 2=1\n\n\\1-grams:\n"
                     "-0.5\tni3\t-0.3\n-0.5\thao3\t-0.3\n\n\\2-grams:\n"
                     "-0.1\tni3 hao3\n\n\\end\\\n", encoding="utf-8")
    capsys.readouterr()
    for extra in (["--lm", lm], ["--word_lm", str(words)]):
        assert eval_main(common + extra + ["--max_batches", "1"]) == 0
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert result["phone_N"] == 8
    # the chunk model's vectorized decoder phase is ported: with it set,
    # the chunk model trains (a step, as far as this test goes)
    chunk = dict(model_cfg["model_config"], name="ChunkConformer",
                 fused_decoder=True)
    chunk_yml = tmp_path / "chunk.yml"
    chunk_yml.write_text(yaml.dump({"model_config": chunk}))
    assert train_main(["--data_config", data_yml, "--model_config",
                       str(chunk_yml), "--device", "cpu", "--total_steps",
                       "1", "--compute_dtype", "float32"]) == 0


def test_test_asr_cli_restores_the_trained_checkpoint(configs, capsys):
    """``cli.test_asr`` without ``--weights`` decodes with the checkpoint
    that ``cli.train_asr`` wrote: the ids the trainer's own predict step
    gives on the restored state."""
    tmp_path, data_yml, model_yml, _ = configs
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.cli.test_asr import main as test_main
    from tensorflowasr_tpu_torch.cli.train_asr import main as train_main
    from tensorflowasr_tpu_torch.utils.audio import SpeechFeaturizer
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    common = ["--data_config", data_yml, "--model_config", model_yml,
              "--compute_dtype", "float32", "--device", "cpu"]
    # the fixture saves every 4 steps
    assert train_main(common + ["--total_steps", "4",
                                "--data_workers", "0"]) == 0
    capsys.readouterr()
    wav_path = str(tmp_path / "u1.wav")
    assert test_main(common + ["--wav", wav_path]) == 0
    captured = capsys.readouterr()
    assert "random init" not in captured.err

    config = UserConfig(data_yml, model_yml)
    phone_f, char_f = build_featurizers(config)[:2]
    trainer = ttrain.CTCTrainer(config, phone_f.num_classes,
                                char_f.num_classes, phone_f.blank,
                                device="cpu", compute_dtype="float32")
    trainer.init_state()
    assert trainer.restore() and trainer.state.step == 4
    sf = SpeechFeaturizer(config["speech_config"])
    wav = sf.load_wav(wav_path)
    padded = sf.pad_signal(wav)
    padded = padded / np.abs(padded).max()
    in_len = len(wav) // (sf.hop_size * sf.reduction_factor)
    phone_ids, phone_lens, char_ids = trainer.predict_step(
        trainer.state, torch.from_numpy(padded[None].astype(np.float32)),
        torch.tensor([in_len], dtype=torch.int32))
    phones = phone_f.iextract(phone_ids[0, :int(phone_lens[0])].tolist())
    printed = next(line for line in captured.out.splitlines()
                   if line.startswith("phones:"))
    assert printed == "phones: " + " ".join(phones)
    chars = []
    for v in char_ids[0].tolist():
        if v in (0, char_f.endid()):
            break
        chars.append(char_f.iextract(v))
    assert f"chars : {''.join(chars)}" in captured.out


def test_cli_cuda_request_without_a_card_raises(configs):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, data_yml, model_yml, _ = configs
    from tensorflowasr_tpu_torch.cli.eval_am import main as eval_main
    from tensorflowasr_tpu_torch.cli.train_asr import main as train_main

    for main in (train_main, eval_main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--data_config", data_yml, "--model_config", model_yml])
