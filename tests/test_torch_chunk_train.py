"""The port's ChunkConformer (SMLTA2) training path against the JAX
package's, on the CPU: masked BatchNorm, the modules in training mode with
``t_valid``, ``train_forward``, the loss and metrics, three Adam steps of
``make_chunk_train_step`` in both stack layouts and both pick modes, the
eval step, SpecAugment in the chunk front, the chunk dataloader,
``ChunkTester``, and the CLIs (train, eval, then the test CLIs restoring
what training wrote).

The same weights go to both frameworks (``models/convert.py``), dropout is
0 wherever values are compared, and each value is held within 1e-5 of its
leaf's largest entry (ids identical), the gate of
``tests/test_torch_train.py``. Dropout masks cannot match across frameworks
and are not compared."""

import dataclasses
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_chunk import N_CHAR, N_PHONE, tiny_cfg
from tests.test_torch_chunk import (
    State,
    build_pair,
    close,
    port_cfg,
    randomize,
    t_,
    with_scan,
)
from tests.test_torch_chunk_modules import STACK, module_pair
from tests.test_torch_data import corpus, loader_config  # noqa: F401
from tests.test_torch_train import (
    ZERO_GRADIENT,
    assert_leaves_close,
    save_as_jax_checkpoint,
)
from tensorflowasr_tpu.models import chunk_conformer as jcc
from tensorflowasr_tpu.train import chunk_trainer as jct
from tensorflowasr_tpu.train import state as jstate
from tensorflowasr_tpu_torch.models import chunk_conformer as tcc
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.models.layers import BatchNorm, set_generator
from tensorflowasr_tpu_torch.ops import specaug as tspec
from tensorflowasr_tpu_torch.testing import tones
from tensorflowasr_tpu_torch.train import chunk_trainer as tct
from tensorflowasr_tpu_torch.train import state as tstate
from tensorflowasr_tpu_torch.utils.audio import write_wav

torch.set_num_threads(2)

SR = 16000
KEY = jax.random.PRNGKey(0)


def stats_of(variables):
    """The ``batch_stats`` of a flax variable dict, in torch names."""
    return convert.chunk_to_torch_names(convert.flatten(
        {"batch_stats": jax.tree.map(np.asarray, variables["batch_stats"])}))


def grads_of(grads):
    """A flax gradient tree (either stack layout) in torch names."""
    return convert.chunk_to_torch_names(convert.flatten(
        {"params": jax.tree.map(np.asarray, grads)}))


def buffers(module):
    return {k: v for k, v in module.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


# ---------------------------------------------------------------------------
# Masked BatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_shape", ["time", "rows", "none"])
def test_masked_batchnorm_matches_flax(mask_shape):
    """Output, input gradient and updated statistics against flax
    ``BatchNorm(mask=...)``; eval mode ignores the mask."""
    rng = np.random.default_rng(0)
    b, t, d = 3, 7, 6
    x = (rng.standard_normal((b, t, d)) + 0.3).astype(np.float32)
    cot = rng.standard_normal((b, t, d)).astype(np.float32)
    mask = {"time": (np.arange(t) < 4)[None, :, None],
            "rows": rng.random((b, t, 1)) < 0.6,
            "none": None}[mask_shape]
    jbn = fnn.BatchNorm(epsilon=1e-3, dtype=jnp.float32)
    variables = jbn.init(KEY, jnp.asarray(x), use_running_average=False)
    variables = randomize(variables, 1)

    def f(x):
        y, upd = jbn.apply(variables, x, use_running_average=False,
                           mask=None if mask is None else jnp.asarray(mask),
                           mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd)

    (_, (want_y, upd)), want_dx = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))

    tbn = BatchNorm(d)
    tbn.load_state_dict(convert.chunk_to_torch_names(
        convert.flatten(variables)))
    xt = t_(x).requires_grad_()
    y = tbn.train()(xt, None if mask is None else t_(mask))
    (y * t_(cot)).sum().backward()
    close(y, want_y)
    close(xt.grad, want_dx)
    assert_leaves_close(buffers(tbn), stats_of(upd), 1e-5, "stat")
    # eval: running statistics, mask or not
    with torch.no_grad():
        close(tbn.eval()(t_(x), t_(np.ones((1, t, 1), bool))),
              jbn.apply(upd | {"params": variables["params"]},
                        jnp.asarray(x), use_running_average=True))


def test_t_valid_equals_literal_width_in_training():
    """Port of ``tests/test_chunk.py::test_t_valid_equals_literal_width``
    in training mode: a decoder run at width t on a wider zero-padded
    buffer with ``t_valid = t`` gives the logits and BatchNorm statistics
    of a literally t-wide input."""
    cfg = port_cfg(tiny_cfg(dec_win_back=2))
    rng = np.random.default_rng(3)
    cap, t, d = 24, 9, cfg.decoder.dmodel
    x_full = rng.standard_normal((2, cap, d)).astype(np.float32)
    x_full[:, t:] = 0.0
    out = {}
    for name, x, t_valid in (("narrow", x_full[:, :t], None),
                             ("wide", x_full, torch.tensor(t))):
        dec = tcc.ChunkCTCDecoder(cfg.decoder, N_CHAR, d)
        tcc.init_weights_(dec, torch.Generator().manual_seed(1))
        dec.train()
        with torch.no_grad():
            logits, _ = dec(t_(x), t_valid)
        out[name] = logits[:, :t], buffers(dec)
    close(out["wide"][0], out["narrow"][0])
    assert_leaves_close(out["wide"][1], out["narrow"][1], 1e-5, "stat")
    moved = [k for k, v in out["wide"][1].items()
             if k.endswith("running_mean") and float(v.abs().max()) > 0]
    assert moved


# ---------------------------------------------------------------------------
# Modules in training mode with t_valid
# ---------------------------------------------------------------------------

def _train_pair(jmod, tmod, x, seed):
    variables, tmod = module_pair(jmod, tmod, jnp.asarray(x), seed=seed)
    return variables, tmod.train()


def _jax_train_grads(jmod, variables, x, t_valid, cot):
    def f(params, x):
        y, upd = jmod.apply({**variables, "params": params}, x,
                            training=True, t_valid=t_valid,
                            mutable=["batch_stats"], rngs={"dropout": KEY})
        return jnp.sum(y * cot), (y, upd)
    (_, (y, upd)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(variables["params"],
                                          jnp.asarray(x))
    return y, upd, gp, gx


@pytest.mark.parametrize("kind", ["conv", "block", "stack", "stack_scan"])
def test_modules_in_training_with_t_valid_match_jax(kind):
    """Output, input gradient, every parameter's gradient and the updated
    BatchNorm statistics, at t_valid 5 of 8 rows."""
    rng = np.random.default_rng(11)
    b, t, d, t_valid = 3, 8, 16, 5
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    cot = rng.standard_normal((b, t, d)).astype(np.float32)
    cfg = jcc.ChunkStackConfig(num_blocks=2, win_back=1,
                               scan_layers=kind == "stack_scan", **STACK)
    tcfg = tcc.ChunkStackConfig(**dataclasses.asdict(cfg))
    jmod, tmod = {
        "conv": lambda: (jcc.ChunkConv(d, 4), tcc.ChunkConv(d, 4)),
        "block": lambda: (jcc.ChunkBlock(cfg), tcc.ChunkBlock(tcfg)),
        "stack": lambda: (jcc.ChunkStack(cfg), tcc.ChunkStack(tcfg)),
        "stack_scan": lambda: (jcc.ChunkStack(cfg), tcc.ChunkStack(tcfg)),
    }[kind]()
    variables, tmod = _train_pair(jmod, tmod, x, seed=12)
    want_y, upd, want_gp, want_gx = _jax_train_grads(
        jmod, variables, x, jnp.asarray(t_valid), jnp.asarray(cot))
    xt = t_(x).requires_grad_()
    y = tmod(xt, torch.tensor(t_valid))
    (y * t_(cot)).sum().backward()
    close(y, want_y)
    close(xt.grad, want_gx)
    assert_leaves_close({k: p.grad for k, p in tmod.named_parameters()},
                        grads_of(want_gp), 1e-5, "grad", skip=ZERO_GRADIENT)
    assert_leaves_close(buffers(tmod), stats_of(upd), 1e-5, "stat")


def test_helper_phone_call_in_training_matches_jax():
    cfg = jcc.ChunkStackConfig(num_blocks=1, **STACK)
    ids = np.array([[1, 4, 2, 0, 7], [3, 3, 5, 6, 1]], np.int32)
    jmod = jcc.ContextHelper(cfg, N_PHONE)
    variables, tmod = module_pair(
        jmod, tcc.ContextHelper(tcc.ChunkStackConfig(
            **dataclasses.asdict(cfg)), N_PHONE),
        jnp.asarray(ids), method=jcc.ContextHelper.phone_call)
    (emb, out), upd = jmod.apply(variables, jnp.asarray(ids), True,
                                 method=jcc.ContextHelper.phone_call,
                                 mutable=["batch_stats"])
    got = tmod.train().phone_call(t_(ids))
    close(got[0], emb)
    close(got[1], out)
    assert_leaves_close(buffers(tmod), stats_of(upd), 1e-5, "stat")


# ---------------------------------------------------------------------------
# The whole model: train_forward, loss and metrics, Adam steps
# ---------------------------------------------------------------------------

N_CHUNKS = 6


def chunk_batch(seed, b=2, n_chunks=N_CHUNKS, lens=((7, 5), (6, 4),
                                                    (6, 3), (5, 5))):
    """Tone signals and ragged labels without adjacent repeats (so every
    label fits its CTC input): (phones, chars, extra_phones, extra_chars)
    lengths per row from ``lens``."""
    rng = np.random.default_rng(seed)
    t_enc = n_chunks * 4
    wav = np.stack([tones(n_chunks * 0.16, seed=seed + i) for i in range(b)])

    def labels(n_max, lengths, top):
        out = np.zeros((b, n_max), np.int32)
        for i, n in enumerate(lengths):
            row = [int(rng.integers(1, top))]
            while len(row) < n:
                v = int(rng.integers(1, top))
                if v != row[-1]:
                    row.append(v)
            out[i, :n] = row
        return out, np.asarray(lengths, np.int32)

    batch = {"wav": wav.astype(np.float32),
             "input_length": np.array([t_enc, t_enc - 4][:b], np.int32)}
    fields = (("phones", N_PHONE - 1), ("chars", N_CHAR - 1),
              ("extra_phones", N_PHONE - 1), ("extra_chars", N_CHAR - 1))
    for (key, top), lengths in zip(fields, lens):
        batch[key], batch[key[:-1] + "_length"] = labels(
            max(lengths), lengths[:b], top)
    return batch


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=[False, True],
                ids=["unrolled", "scan"])
def pair(request):
    jcfg = with_scan(tiny_cfg(), request.param)
    calib = chunk_batch(0)["wav"]
    jmodel, variables, tmodel = build_pair(jcfg, seed=4, calib=calib)
    return jmodel, variables, tmodel, request.param


def fresh_port_model(pair):
    """The port model of ``pair`` with its weights, new, in training mode."""
    jmodel, variables, tmodel, _ = pair
    model = tcc.ChunkConformer(tmodel.cfg, N_PHONE, N_CHAR)
    model.load_state_dict(tmodel.state_dict())
    return model.train()


@pytest.mark.parametrize("max_pick", [8, None], ids=["cap8", "uncapped"])
def test_train_forward_matches_jax(pair, max_pick):
    jmodel, variables, _, _ = pair
    batch = chunk_batch(1)
    width = int(batch["phone_length"].max())
    want, upd = jmodel.apply(
        variables, jnp.asarray(batch["wav"]),
        jnp.asarray(batch["extra_phones"]), max_pick, True,
        label_width=jnp.asarray(width), rngs={"dropout": KEY},
        mutable=["batch_stats"], method=jcc.ChunkConformer.train_forward)
    model = fresh_port_model(pair)
    with torch.no_grad():
        got = model.train_forward(t_(batch["wav"]), t_(batch["extra_phones"]),
                                  max_pick, label_width=width)
    assert set(got) == set(want)
    for k in ("phone_logits", "picked_counts", "txt_logits", "help_logits"):
        close(got[k], want[k])
    if max_pick is None:
        close(got["t_ref"], want["t_ref"])
        assert 1 <= int(got["t_ref"]) <= N_CHUNKS * 4
    else:
        assert got["t_ref"] is None and want["t_ref"] is None
    counts = got["picked_counts"].numpy()
    assert (counts > 0).all() and (counts < N_CHUNKS * 4).all(), counts
    assert_leaves_close(buffers(model), stats_of(upd), 1e-5, "stat")
    # ADVICE hazard 2: the uncapped pick needs the label width in training
    with pytest.raises(ValueError, match="label_width"):
        model.train_forward(t_(batch["wav"]), t_(batch["extra_phones"]),
                            None)
    model.eval().train_forward(t_(batch["wav"]), t_(batch["extra_phones"]),
                               None)


@pytest.mark.parametrize("txt,reduction", [("padded", "sum"),
                                           ("picked", "mean"),
                                           ("picked", "sum")])
@pytest.mark.parametrize("max_pick", [8, None], ids=["cap8", "uncapped"])
def test_loss_and_metrics_match_jax(pair, txt, reduction, max_pick):
    jmodel, variables, _, _ = pair
    batch = chunk_batch(2)
    want, (want_m, _) = jct._loss_and_metrics(
        jmodel, variables["params"], variables["batch_stats"],
        jax_batch(batch), KEY, max_pick, True, txt, reduction)
    model = fresh_port_model(pair)
    with torch.no_grad():
        got, got_m = tct.loss_and_metrics(model, torch_batch(batch),
                                          max_pick, txt, reduction)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert set(got_m) == set(want_m)
    for k, v in want_m.items():
        assert float(got_m[k]) == pytest.approx(float(v), rel=1e-5,
                                                abs=1e-6), k


def test_chunk_ctc_acc_matches_jax():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 6, (4, 7)).astype(np.int32)
    labels[1, 3:] = 0
    for t in (4, 7, 10):
        decoded = rng.integers(0, 6, (4, t)).astype(np.int32)
        decoded[:, :2] = labels[:, :2]
        want = float(jct._chunk_ctc_acc(jnp.asarray(labels),
                                        jnp.asarray(decoded)))
        got = float(tct.chunk_ctc_acc(t_(labels), t_(decoded)))
        assert got == pytest.approx(want, abs=1e-6)


# The f32 gradients of this model carry rounding noise of about 1e-5 of a
# leaf's largest entry: the JAX package against itself (its jitted step
# against the same step run eagerly) differs by up to 2.0e-5 on one leaf
# (an encoder LayerNorm or conv weight) at these inputs, so gradient leaves
# are held to GRAD_REL of their largest entry. Adam with its usual epsilon
# of 1e-6 would move every weight whose gradient is within that noise of 0
# by +-lr on the noise's sign; epsilon 1 keeps such steps proportional to
# the gradient (a few 1e-9), so the parameters can be held to 1e-5 of each
# leaf's largest entry with no leaf left out. The update at 1e-6 is tested
# on given gradients in tests/test_torch_train.py.
GRAD_REL = 5e-5
ADAM_EPS = 1.0


def _jax_step(jmodel, max_pick, txt, reduction):
    """The JAX package's step, also handing back the gradient it applied."""
    def step(state, batch):
        grad_fn = jax.value_and_grad(
            lambda p: jct._loss_and_metrics(
                jmodel, p, state.batch_stats, batch,
                jax.random.fold_in(KEY, state.step), max_pick, True, txt,
                reduction), has_aux=True)
        (loss, (metrics, stats)), grads = grad_fn(state.params)
        state = state.apply_gradients(grads=grads).replace(batch_stats=stats)
        return state, loss, metrics, grads
    return jax.jit(step)


def _flax_leaves(variables):
    return {k: np.asarray(v) for k, v in
            convert.flatten(jax.tree.map(np.asarray, variables)).items()}


@pytest.mark.parametrize("max_pick", [8, None], ids=["cap8", "uncapped"])
def test_three_adam_steps_match_jax(pair, max_pick):
    """The main gate: three steps of ``make_chunk_train_step`` (Adam lr
    1e-3, ``loss_reduction`` sum, padded char-CTC lengths) from the same
    weights; at each step the loss, the metrics and every gradient leaf,
    and after each the parameters and BatchNorm statistics, pulled into
    the flax layout with ``to_flax_names``. Then the eval step."""
    jmodel, variables, _, scan = pair
    oc = {"lr": 1e-3, "epsilon": ADAM_EPS}
    tx = jstate.make_optimizer(oc)
    jst = jstate.ASRTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"], tx=tx,
        batch_stats=variables["batch_stats"])
    jstep = _jax_step(jmodel, max_pick, "padded", "sum")

    model = fresh_port_model(pair)
    grads = []

    def mark(stage):
        if stage == "backward":
            grads.append({k: p.grad.clone()
                          for k, p in model.named_parameters()})

    tst = tstate.ASRTrainState(
        model, tstate.make_optimizer(model.parameters(), oc),
        torch.Generator().manual_seed(0))
    tstep = tct.make_chunk_train_step(max_pick, mark=mark)
    for i in range(3):
        batch = chunk_batch(10 + i)
        before = jst
        jst, jloss, jm, jgrads = jstep(jst, jax_batch(batch))
        tst, tm = tstep(tst, torch_batch(batch))
        assert float(tm["train_loss"]) * 2 == pytest.approx(float(jloss),
                                                           rel=1e-5), i
        for k, v in jm.items():
            assert float(tm[k]) == pytest.approx(float(v), rel=1e-5,
                                                 abs=1e-6), (i, k)
        assert_leaves_close(grads[i], grads_of(jgrads), GRAD_REL,
                            f"grad {i}", skip=ZERO_GRADIENT)
        if i == 0 and max_pick == 8 and not scan:
            # the JAX package's own step takes the step rebuilt here (once:
            # each jitted step costs a compile)
            real, real_m = jct.make_chunk_train_step(
                jmodel, max_pick, donate=False)(before, jax_batch(batch), KEY)
            for a, b in zip(jax.tree.leaves(real.params),
                            jax.tree.leaves(jst.params)):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=0, atol=1e-6)
            assert float(real_m["train_loss"]) == pytest.approx(
                float(jm["train_loss"]), rel=1e-6)
        want = _flax_leaves({"params": jst.params,
                             "batch_stats": jst.batch_stats})
        got = convert.to_flax_names(model, scan_layers=scan)
        assert set(got) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"step {i} {name}")
    assert tst.step == 3 and tst.optimizer.count == 3

    batch = chunk_batch(20)
    want = jct.make_chunk_eval_step(jmodel, max_pick)(jst, jax_batch(batch))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = tct.make_chunk_eval_step(max_pick)(tst, torch_batch(batch))
    for k, v in want.items():
        assert float(got[k]) == pytest.approx(float(v), rel=1e-5,
                                              abs=1e-6), k
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_chunk_train_step_runs_and_descends():
    """Port of ``tests/test_chunk.py::test_chunk_train_step_runs_and_descends``
    with dropout 0.1 and SpecAugment on, drawing from the state's
    generator."""
    jcfg = tiny_cfg()
    cfg = dataclasses.replace(
        port_cfg(jcfg), spec_augment=True, front_dropout=0.1,
        encoder=dataclasses.replace(port_cfg(jcfg).encoder, dropout=0.1))
    model = tcc.build_chunk_model(cfg, N_PHONE, N_CHAR, device="cpu")
    gen = torch.Generator().manual_seed(1)
    set_generator(model, gen)
    state = tstate.ASRTrainState(
        model, tstate.make_optimizer(model.parameters(), {"lr": 3e-3}), gen)
    batch = torch_batch(chunk_batch(5, n_chunks=3, lens=((5, 5), (5, 5),
                                                          (6, 6), (4, 4))))
    step = tct.make_chunk_train_step(max_pick=8)
    global_rng = torch.random.get_rng_state()
    losses = [float(step(state, batch)[1]["train_loss"]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    assert torch.equal(torch.random.get_rng_state(), global_rng)
    em = tct.make_chunk_eval_step(max_pick=8)(state, batch)
    assert np.isfinite(float(em["train_loss"]))


# ---------------------------------------------------------------------------
# SpecAugment in the chunk front
# ---------------------------------------------------------------------------

def _bands(key_w, key_s, b, n_masks, dim, max_width):
    """The (start, width) that the JAX package's ``_axis_masks`` draws."""
    max_width = max(0, min(int(max_width), dim))
    w = jax.random.randint(key_w, (b, n_masks), 0, max_width + 1)
    u = jax.random.uniform(key_s, (b, n_masks))
    s = jnp.floor(u * (dim - w + 1).astype(jnp.float32)).astype(jnp.int32)
    return t_(np.asarray(s, np.int32)), t_(np.asarray(w, np.int32))


def test_chunk_front_spec_augment_matches_jax(monkeypatch):
    """The JAX front masks its 'valid' log-mel with the bands its key
    draws; the port's front given those bands (and the config's knobs)
    gives the same output. Without a generator it raises, eval mode
    leaves the mel alone, and the draws follow the generator's seed."""
    import tensorflowasr_tpu.ops.specaug as jspec

    jcfg = dataclasses.replace(tiny_cfg(), spec_augment=True,
                               specaug_freq_width=5, specaug_time_ratio=0.2)
    cfg = port_cfg(jcfg)
    assert (cfg.specaug_freq_width, cfg.specaug_time_ratio) == (5, 0.2)
    b = 2
    wav = np.stack([tones(4 * 0.16, seed=s) for s in (1, 2)])
    jmod = jcc.ChunkFront(jcfg)
    variables, tmod = module_pair(jmod, tcc.ChunkFront(cfg),
                                  jnp.asarray(wav))
    seen = {}
    original = jspec.spec_augment

    def recording(mel, rng, **kw):
        seen["rng"], seen["shape"] = rng, mel.shape
        return original(mel, rng, **kw)

    monkeypatch.setattr(jspec, "spec_augment", recording)
    want = jmod.apply(variables, jnp.asarray(wav), True,
                      rngs={"dropout": KEY})
    _, t, f = seen["shape"]
    kfw, kfs, ktw, kts = jax.random.split(seen["rng"], 4)
    bands = (_bands(kfw, kfs, b, 2, f, 5),
             _bands(ktw, kts, b, 2, t, int(round(t * 0.2))))

    gen = torch.Generator().manual_seed(3)

    def given(mel, generator, **kw):
        assert generator is gen
        assert kw == dict(n_freq_masks=2, freq_width=5, n_time_masks=2,
                          time_ratio=0.2)
        return tspec.apply_bands(mel, *bands)

    tmod.train()
    with pytest.raises(RuntimeError, match="generator"):
        tmod(t_(wav))
    set_generator(tmod, gen)
    monkeypatch.setattr(tcc, "spec_augment", given)
    got = tmod(t_(wav))
    close(got, want, atol=2e-5)
    assert not np.allclose(np.asarray(want),
                           np.asarray(jmod.apply(variables,
                                                 jnp.asarray(wav))))
    monkeypatch.undo()
    with torch.no_grad():
        plain = tmod.eval()(t_(wav))
        tmod.train()
        draws = []
        for seed in (7, 7, 8):
            gen.manual_seed(seed)
            draws.append(tmod(t_(wav)))
    close(plain, jmod.apply(variables, jnp.asarray(wav)), atol=2e-5)
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], plain)


def test_trainable_mel_gradient_matches_jax():
    """With ``mel_layer_trainable`` the mel matrix takes its gradient
    through the plain dB + mel epilogue (the wav, and so K1, carries
    none): the front's parameter gradients against JAX in training mode."""
    jcfg = dataclasses.replace(tiny_cfg(), mel_layer_trainable=True)
    # noise, not the gated tones: the dB's 1 / power amplifies rounding on
    # near-silent frames
    wav = (np.random.default_rng(4).standard_normal((2, 3 * 2560))
           * 0.1).astype(np.float32)
    jmod = jcc.ChunkFront(jcfg)
    variables, tmod = module_pair(jmod, tcc.ChunkFront(port_cfg(jcfg)),
                                  jnp.asarray(wav))
    cot = np.random.default_rng(6).standard_normal(
        jmod.apply(variables, jnp.asarray(wav)).shape).astype(np.float32)

    def f(params):
        y = jmod.apply({"params": params}, jnp.asarray(wav), True,
                       rngs={"dropout": KEY})
        return jnp.sum(y * cot)

    want = grads_of(jax.grad(f)(variables["params"]))
    (tmod.train()(t_(wav)) * t_(cot)).sum().backward()
    got = {k: p.grad for k, p in tmod.named_parameters()}
    assert "freq2mel" in got and float(got["freq2mel"].abs().max()) > 0
    assert_leaves_close(got, want, 1e-5, "grad")


def test_config_reads_the_training_fields():
    from tensorflowasr_tpu.utils.config import UserConfig as JConfig
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    extra = {"model_config": {"ChunkConformerFront": {
        "spec_augment": True, "specaug_freq_masks": 1,
        "specaug_freq_width": 9, "specaug_time_masks": 3,
        "specaug_time_ratio": 0.1, "dropout": 0.1},
        "ChunkConformerEncoder": {"dropout": 0.2}}}
    want = jcc.ChunkConformerConfig.from_user_config(JConfig(
        "configs/am_data.yml", "configs/chunk_conformerS.yml"))
    want = dataclasses.replace(
        want, spec_augment=True, specaug_freq_masks=1, specaug_freq_width=9,
        specaug_time_masks=3, specaug_time_ratio=0.1, front_dropout=0.1,
        encoder=dataclasses.replace(want.encoder, dropout=0.2))
    got = tcc.ChunkConformerConfig.from_user_config(UserConfig(
        "configs/am_data.yml", "configs/chunk_conformerS.yml", extra=extra),
        "float32")
    assert got == port_cfg(want)


# ---------------------------------------------------------------------------
# The chunk dataloader, ChunkTester
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("streaming", [False, True],
                         ids=["offline", "streaming"])
def test_chunk_dataloader_batches_equal_the_jax_loaders(corpus, streaming):
    """Every key, the extra text branch's included, over train batches that
    cross epoch boundaries and the eval split; wav caps are whole chunks
    and no char row carries </S>."""
    from tensorflowasr_tpu.data.chunk_dataloader import (
        ChunkDataLoader as JChunkDataLoader,
    )
    from tensorflowasr_tpu.utils import text as jtext
    from tensorflowasr_tpu_torch.data.chunk_dataloader import ChunkDataLoader
    from tensorflowasr_tpu_torch.utils import text as ttext

    cfg = loader_config(corpus, streaming=streaming)
    loaders = []
    for cls, text in ((JChunkDataLoader, jtext), (ChunkDataLoader, ttext)):
        phone_f = text.TextFeaturizer({"vocabulary":
                                       str(corpus / "phones.txt")})
        char_f = text.TextFeaturizer({"vocabulary":
                                      str(corpus / "chars.txt")})
        loaders.append(cls(
            cfg, phone_f, char_f, chunk_num=16,
            pinyin2phone=text.load_pinyin2phone(str(corpus / "p2p.map")),
            transcripts_are_pinyin=True, seed=3))
    want_dl, got_dl = loaders
    assert [repr(b) for b in got_dl.buckets] == \
        [repr(b) for b in want_dl.buckets]
    assert all(b.wav_cap % 2560 == 0 for b in got_dl.buckets)
    end_id = char_f.endid()
    for train, n in ((True, 8), (False, 4)):
        for _ in range(n):
            want, got = want_dl.generate(train), got_dl.generate(train)
            assert list(got) == list(want)
            assert {"extra_phones", "extra_phone_length", "extra_chars",
                    "extra_char_length"} <= set(got)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got["wav"].shape[1] % 2560 == 0
            # whole chunks of 4 encoder frames, inside the bucket
            assert (got["input_length"] % 4 == 0).all()
            assert got["input_length"].max() <= got["wav"].shape[1] // 640
            assert not (got["chars"] == end_id).any()
            assert (got["extra_phone_length"] > 0).all()
    assert got_dl.epochs == want_dl.epochs >= 1


def test_chunk_tester_matches_jax(pair):
    from types import SimpleNamespace

    from tensorflowasr_tpu.eval.testers import ChunkTester as JChunkTester
    from tensorflowasr_tpu_torch.eval.testers import ChunkTester

    jmodel, variables, _, _ = pair
    batches = [chunk_batch(30), chunk_batch(31)]
    state = State(variables["params"], variables["batch_stats"])
    want = JChunkTester(jct.make_chunk_predict_step(jmodel), state).run(
        iter(batches))
    model = fresh_port_model(pair).eval()
    got = ChunkTester(
        lambda st, wav, n: tct.make_chunk_predict_step(st.model)(wav, n),
        SimpleNamespace(model=model)).run(iter(batches))
    assert got == want
    assert got["phone_N"] > 0 and got["char_N"] > 0


# ---------------------------------------------------------------------------
# CLIs: train, eval, then the test CLIs restore what training wrote
# ---------------------------------------------------------------------------

def _sine(freq, seconds):
    t = np.arange(int(seconds * SR)) / SR
    return (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def write_cli_corpus(tmp_path, model_config):
    """The corpus and configs of ``tests/test_cli_extra.py``'s chunk CLI
    test, with ``model_config``; returns (data yml, model yml)."""
    lines = []
    for i, txt in enumerate(["ni3 hao3", "shi4 jie4"]):
        p = tmp_path / f"u{i}.wav"
        write_wav(str(p), _sine(200 + 40 * i, 1.0), SR)
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
            "sample_rate": SR, "stride_ms": 10, "reduction_factor": 4,
            "wav_max_duration": 2,
            "train_list": str(tmp_path / "train.list"),
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
                           "save_interval_steps": 2,
                           "eval_interval_steps": 1000,
                           "outdir": str(tmp_path / "logs")},
    }
    dp, mp = tmp_path / "d.yml", tmp_path / "m.yml"
    dp.write_text(yaml.dump(data_cfg))
    mp.write_text(yaml.dump(model_config))
    return str(dp), str(mp)


CHUNK_CLI_MODEL = {"model_config": {
    "name": "ChunkConformer",
    "ChunkConformerFront": {"dmodel": 16, "reduction_factor": 4,
                            "sample_rate": SR, "n_mels": 20,
                            "stride_ms": 10, "chunk_num": 16},
    **{name: dict(dmodel=16, head_size=8, num_heads=2, kernel_size=4,
                  fc_factor=0.5, dropout=0.0, win_front=6, num_blocks=1,
                  win_back=2 if name == "ChunkCTCDecoder" else 0)
       for name in ("ChunkConformerEncoder", "ChunkCTCPicker",
                    "ChunkCTCDecoder", "ContextHelper")},
}}


def _printed(out, label):
    line = next(ln for ln in out.splitlines() if ln.startswith(label))
    return line.split(":", 1)[1].strip()


def test_chunk_train_eval_and_stream_cli(tmp_path, capsys):
    """Port of ``tests/test_cli_extra.py::test_chunk_train_and_stream_cli``:
    ``cli.train_asr`` trains the ChunkConformer for 2 steps on the CPU and
    saves; ``cli.test_chunk_asr`` without ``--weights`` restores that
    checkpoint and prints what the trainer's own predict step gives on it;
    ``cli.eval_am`` scores it, and the JAX package's ``eval_am`` on the same
    weights prints the same error rates."""
    from tensorflowasr_tpu.cli.eval_am import main as jax_eval_main
    from tensorflowasr_tpu.train.chunk_trainer import ChunkTrainer as JTrainer
    from tensorflowasr_tpu.utils.config import UserConfig as JConfig
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.cli.eval_am import main as eval_main
    from tensorflowasr_tpu_torch.cli.test_chunk_asr import main as chunk_main
    from tensorflowasr_tpu_torch.cli.train_asr import main as train_main
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    data_yml, model_yml = write_cli_corpus(tmp_path, CHUNK_CLI_MODEL)
    common = ["--data_config", data_yml, "--model_config", model_yml,
              "--compute_dtype", "float32", "--device", "cpu"]
    assert train_main(common + ["--total_steps", "2",
                                "--data_workers", "0"]) == 0
    assert os.listdir(tmp_path / "logs" / "checkpoints") == [
        "ckpt_000000002.pt"]
    logged = json.loads((tmp_path / "logs" / "metrics.jsonl").read_text())
    assert logged["step"] == 2 and np.isfinite(logged["train_loss"])
    assert {"phone_loss", "txt_loss", "help_loss", "phone_acc", "txt_acc",
            "help_acc"} <= set(logged)

    # the test CLI restores step 2 and decodes as the trainer's predict step
    capsys.readouterr()
    wav_path = str(tmp_path / "u0.wav")
    assert chunk_main(common + ["--wav", wav_path]) == 0
    captured = capsys.readouterr()
    assert "random init" not in captured.err
    config = UserConfig(data_yml, model_yml)
    phone_f, char_f = build_featurizers(config)[:2]
    trainer = tct.ChunkTrainer(config, phone_f.num_classes,
                               char_f.num_classes, device="cpu")
    trainer.init_state()
    assert trainer.restore() and trainer.state.step == 2
    wav = _sine(200, 1.0)
    padded = np.zeros(-(-len(wav) // 2560) * 2560, np.float32)
    padded[:len(wav)] = wav
    char_ids, char_lens, ph_ids, ph_lens = trainer.predict_step(
        trainer.state, t_(padded[None]),
        torch.tensor([len(padded) // 2560 * 4]))
    assert _printed(captured.out, "offline phones") == " ".join(
        phone_f.iextract(ph_ids[0, :ph_lens[0]].tolist()))
    assert _printed(captured.out, "offline chars") == "".join(
        char_f.iextract(char_ids[0, :char_lens[0]].tolist()))
    assert "stream  chars :" in captured.out and "RTF" in captured.out

    # eval_am on the trained weights, here and in the JAX package
    assert eval_main(common + ["--max_batches", "1"]) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    got = json.loads(captured.out.strip().splitlines()[-1])
    # the JAX package's checkpoints go to an outdir of their own
    jax_model_yml = tmp_path / "jm.yml"
    jax_model_yml.write_text(yaml.dump({**CHUNK_CLI_MODEL, "running_config": {
        "batch_size": 2, "outdir": str(tmp_path / "jax_logs")}}))
    jtrainer = JTrainer(JConfig(data_yml, str(jax_model_yml)),
                        phone_f.num_classes, char_f.num_classes)
    jtrainer.init_state({"wav": padded[None],
                         "extra_phones": np.ones((1, 4), np.int32)})
    save_as_jax_checkpoint(jtrainer, trainer.state.model, 2)
    assert jax_eval_main(["--data_config", data_yml, "--model_config",
                          str(jax_model_yml), "--max_batches", "1"]) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    want = json.loads(captured.out.strip().splitlines()[-1])
    assert got == want
    assert got["phone_N"] > 0 and got["char_N"] > 0


def test_chunk_eval_cli_scores_in_f32_as_jax(tmp_path, capsys, monkeypatch):
    """``cli.eval_am`` without ``--compute_dtype`` builds its
    ``ChunkTrainer`` in f32, as the JAX package's ``eval_am`` does, and
    prints the JAX CLI's error rates on the same trained weights."""
    from tensorflowasr_tpu.cli.eval_am import main as jax_eval_main
    from tensorflowasr_tpu.train.chunk_trainer import ChunkTrainer as JTrainer
    from tensorflowasr_tpu.utils.config import UserConfig as JConfig
    from tensorflowasr_tpu_torch.cli import eval_am
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.cli.train_asr import main as train_main
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    data_yml, model_yml = write_cli_corpus(tmp_path, CHUNK_CLI_MODEL)
    common = ["--data_config", data_yml, "--model_config", model_yml,
              "--device", "cpu"]
    assert train_main(common + ["--compute_dtype", "float32",
                                "--total_steps", "2",
                                "--data_workers", "0"]) == 0
    built, real_setup = [], eval_am.chunk_setup

    def setup(*args):
        dl, trainer = real_setup(*args)
        built.append(trainer.model_cfg.dtype_str)
        return dl, trainer

    monkeypatch.setattr(eval_am, "chunk_setup", setup)
    capsys.readouterr()
    assert eval_am.main(common + ["--max_batches", "1"]) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    assert built == ["float32"]
    got = json.loads(captured.out.strip().splitlines()[-1])

    config = UserConfig(data_yml, model_yml)
    phone_f, char_f = build_featurizers(config)[:2]
    trainer = tct.ChunkTrainer(config, phone_f.num_classes,
                               char_f.num_classes, device="cpu")
    trainer.init_state()
    assert trainer.restore() and trainer.state.step == 2
    jax_model_yml = tmp_path / "jm.yml"
    jax_model_yml.write_text(yaml.dump({**CHUNK_CLI_MODEL, "running_config": {
        "batch_size": 2, "outdir": str(tmp_path / "jax_logs")}}))
    jtrainer = JTrainer(JConfig(data_yml, str(jax_model_yml)),
                        phone_f.num_classes, char_f.num_classes)
    jtrainer.init_state({"wav": np.zeros((1, 2560), np.float32),
                         "extra_phones": np.ones((1, 4), np.int32)})
    save_as_jax_checkpoint(jtrainer, trainer.state.model, 2)
    assert jax_eval_main(["--data_config", data_yml, "--model_config",
                          str(jax_model_yml), "--max_batches", "1"]) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    want = json.loads(captured.out.strip().splitlines()[-1])
    assert got == want
    assert got["phone_N"] > 0 and got["char_N"] > 0
