"""Data and tensor parallelism of the port (``parallel/``) against the JAX
package's mesh steps and against the port's own one-process step, on the
CPU with gloo.

Ranks are separate processes started by ``parallel/step_check.py::launch``
(``python -m`` on a worker entry inside the port, so no rank imports JAX;
rendezvous through a file, no TCP port); each writes what its steps did.
The JAX side runs here, on conftest's 8-device CPU mesh, where GSPMD makes
its step one global program. Every run is at dropout 0 unless it tests the
masks, from the same weights (flax variables moved by ``models/convert.py``,
or a port model's state_dict), f32.

Tolerances:
- losses and metrics within 1e-5 relative of JAX's, 1e-5 of the
  one-process port's; gradient global norms 1e-5 relative;
- parameters after 3 Adam steps (epsilon 1, lr 1e-3, as
  ``tests/test_torch_chunk_train.py`` runs Adam: at 1e-6 a gradient that
  is rounding noise steps +-lr) within 1e-5 of each leaf's largest entry,
  the leaves whose gradient is zero in exact arithmetic
  (``test_torch_train.ZERO_GRADIENT``) held to 1e-7 absolute instead;
- BatchNorm running statistics within 1e-5 of each leaf's largest entry,
  and bit-identical across ranks, as the parameters are;
- the tensor-parallel SGD step to ``tests/test_tp.py``'s bar: loss within
  1e-4 relative, parameters within lr * 1e-2.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import PartitionSpec as P

from tests.test_chunk import tiny_cfg
from tests.test_torch_chunk import build_pair, port_cfg
from tests.test_torch_chunk_train import _jax_step
from tests.test_torch_prefetch import corpus  # noqa: F401
from tests.test_torch_train import (
    BLANK,
    N_CHAR,
    N_PHONE,
    TINY,
    ZERO_GRADIENT,
    both_models,
    torch_leaves,
)
from tensorflowasr_tpu.models import conformer as jconf
from tensorflowasr_tpu.parallel import mesh as jmesh
from tensorflowasr_tpu.parallel import tp as jtp
from tensorflowasr_tpu.train import asr_trainer as jtrain
from tensorflowasr_tpu.train import state as jstate
from tensorflowasr_tpu_torch.models import chunk_conformer as tcc
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.models.layers import BatchNorm
from tensorflowasr_tpu_torch.parallel import mesh as tmesh
from tensorflowasr_tpu_torch.parallel import multihost, step_check
from tensorflowasr_tpu_torch.parallel import tp as ttp
from tensorflowasr_tpu_torch.testing import tones
from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer

torch.set_num_threads(2)

ADAM = {"lr": 1e-3, "epsilon": 1.0}
REL = 1e-5
RANK_TIMEOUT = 120.0


def ctc_config(outdir, batch_size, model=TINY, optimizer=ADAM):
    return {"model_config": dict(model), "speech_config": {},
            "optimizer_config": dict(optimizer),
            "running_config": {"batch_size": batch_size,
                               "outdir": str(outdir)}}


def write_spec(tmp_path, config, state_dict, batches, kind="ctc",
               n_phone=N_PHONE, n_char=N_CHAR, **kw):
    """The step_check spec of ``batches`` (numpy dicts) from
    ``state_dict``, its files in ``tmp_path``."""
    weights, data = tmp_path / "weights.pt", tmp_path / "batches.npz"
    torch.save(state_dict, weights)
    np.savez(data, **{f"{i}/{k}": v for i, b in enumerate(batches)
                      for k, v in b.items()})
    return {"kind": kind, "config": config, "n_phone": n_phone,
            "n_char": n_char, "weights": str(weights),
            "batches": str(data), "steps": len(batches), "device": "cpu",
            **kw}


def ctc_batch(seed, b, n_char=N_CHAR):
    """Noise, ragged phone and char labels (zero padded)."""
    rng = np.random.default_rng(seed)
    t = 9600
    phone_length = rng.integers(3, 7, b).astype(np.int32)
    phones = rng.integers(1, BLANK, (b, 6)).astype(np.int32)
    for i, n in enumerate(phone_length):
        phones[i, n:] = 0
    chars = rng.integers(1, n_char, (b, 5)).astype(np.int32)
    chars[::3, 3:] = 0
    return {"wav": (rng.standard_normal((b, t)) * 0.1).astype(np.float32),
            "input_length": np.where(np.arange(b) % 2, t // 640 - 4,
                                     t // 640).astype(np.int32),
            "phones": phones, "phone_length": phone_length,
            "chars": chars}


def assert_leaves_close(got, want, what, rel=REL):
    """Each leaf within ``rel`` of its reference's largest entry; a leaf
    whose gradient is zero in exact arithmetic (rounding noise, which
    Adam at epsilon 1 turns into steps of lr times that noise from a zero
    start) within 1e-7."""
    assert set(got) == set(want), what
    for name, w in want.items():
        w = np.asarray(w)
        atol = 1e-7 if name.endswith(ZERO_GRADIENT) \
            else rel * np.abs(w).max()
        np.testing.assert_allclose(np.asarray(got[name]), w, rtol=0,
                                   atol=atol, err_msg=f"{what} {name}")


def values(result, key="params"):
    return {k: v["value"].numpy() for k, v in result[key].items()}


def assert_ranks_identical(results):
    for key in ("params", "buffers"):
        for name, leaf in results[0][key].items():
            for r in results[1:]:
                assert torch.equal(r[key][name]["value"], leaf["value"]), \
                    (key, name, r["rank"])


def assert_metrics_close(got, want, rel=REL):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=rel, abs=1e-6), k


# -- (a) the 2-rank CTCTrainer step against JAX's 8-device mesh step ---------

def test_two_rank_ctc_steps_match_the_jax_mesh_step(tmp_path):
    jmodel, variables, tmodel = both_models(seed=8)
    batches = [ctc_batch(20 + i, 8) for i in range(3)]
    config = ctc_config(tmp_path, 8)
    assert tconf.ConformerConfig.from_user_config(config) == tmodel.cfg
    spec = write_spec(tmp_path, config, tmodel.state_dict(), batches)
    ranks = step_check.launch(spec, 2, str(tmp_path / "ranks"),
                              RANK_TIMEOUT)
    one = step_check.run(spec)

    mesh = jmesh.make_data_mesh(8)
    assert mesh.devices.size == 8
    tx = jstate.make_optimizer(ADAM)
    jst = jmesh.replicate(jstate.ASRTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"], tx=tx,
        batch_stats=variables["batch_stats"]), mesh)
    jstep = jtrain.make_train_step(jmodel, tx, BLANK, donate=False)
    for i, batch in enumerate(batches):
        jst, jm = jstep(jst, jmesh.shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh),
            jax.random.PRNGKey(1))
        want = {k: float(v) for k, v in jm.items()}
        for r in ranks:
            assert_metrics_close(r["metrics"][i], want)
            assert r["grad_norms"][i] == pytest.approx(one["grad_norms"][i],
                                                       rel=REL)
        assert_metrics_close(one["metrics"][i], want)
    assert [r["rows"] for r in ranks] == [4, 4]
    assert_ranks_identical(ranks)
    params = torch_leaves(jst.params)
    assert_leaves_close(values(ranks[0]), params, "param")
    assert_leaves_close(values(one), params, "param (one process)")
    stats = convert.to_torch_names(convert.flatten(
        {"batch_stats": jax.tree.map(np.asarray, jst.batch_stats)}))
    assert_leaves_close(values(ranks[0], "buffers"), stats, "stat")
    moved = [k for k, v in values(ranks[0], "buffers").items()
             if not np.array_equal(v, tmodel.state_dict()[k].numpy())]
    assert len(moved) == len(stats)


# -- (b) an uneven split equals one process ---------------------------------

def test_uneven_split_equals_one_process(tmp_path):
    """B = 5 over 2 ranks: 3 rows and 2 rows; every reduction is global,
    so the step is the one-process step on the 5 rows."""
    _, _, tmodel = both_models(seed=9)
    batches = [ctc_batch(30 + i, 5) for i in range(3)]
    spec = write_spec(tmp_path, ctc_config(tmp_path, 5), tmodel.state_dict(),
                      batches)
    ranks = step_check.launch(spec, 2, str(tmp_path / "ranks"),
                              RANK_TIMEOUT)
    one = step_check.run(spec)
    assert [r["rows"] for r in ranks] == [3, 2]
    for i in range(3):
        for r in ranks:
            assert_metrics_close(r["metrics"][i], one["metrics"][i])
            assert r["grad_norms"][i] == pytest.approx(one["grad_norms"][i],
                                                       rel=REL)
    assert_ranks_identical(ranks)
    assert_leaves_close(values(ranks[0]), values(one), "param")
    assert_leaves_close(values(ranks[0], "buffers"), values(one, "buffers"),
                        "stat")


def test_local_batchnorm_moments_fail_the_comparison(tmp_path):
    """The planted fault ``chip_smoke.py`` also runs (``local_batchnorm``:
    each rank's BatchNorm moments over its own rows) lands far outside the
    bounds the comparison above holds the ranks to: above ten times them."""
    _, _, tmodel = both_models(seed=10)
    spec = write_spec(tmp_path, ctc_config(tmp_path, 8), tmodel.state_dict(),
                      [ctc_batch(40, 8)])
    ranks = step_check.launch(dict(spec, local_batchnorm=True), 2,
                              str(tmp_path / "ranks"), RANK_TIMEOUT)
    one = step_check.run(spec)
    want = one["metrics"][0]["train_loss"]
    for r in ranks:
        assert abs(r["metrics"][0]["train_loss"] - want) > 10 * REL * want
    with pytest.raises(AssertionError):
        assert_leaves_close(values(ranks[0]), values(one), "param",
                            rel=10 * REL)
    stat = "encoder.blocks.0.conv_module.bn.running_mean"
    assert not torch.equal(ranks[0]["buffers"][stat]["value"],
                           ranks[1]["buffers"][stat]["value"])


def test_batch_rows_split_as_numpy_does():
    for b in (5, 8, 32, 33):
        for n in (1, 2, 3, 4):
            want = np.array_split(np.arange(b), n)
            for i in range(n):
                np.testing.assert_array_equal(
                    np.arange(b)[tmesh.batch_rows(b, n, i)], want[i])


# -- (c) the chunk step with rank-dependent picks -----------------------------

N_CHUNKS = 6


def chunk_rows(seed, b=8):
    """Gated tones, labels without adjacent repeats (each fits its CTC
    input), the extra chars no longer than the extra phones."""
    rng = np.random.default_rng(seed)
    wav = np.stack([tones(N_CHUNKS * 0.16, seed=seed + i) for i in range(b)])

    def labels(lo, hi, top, cap=None):
        lengths = rng.integers(lo, hi + 1, b)
        if cap is not None:
            lengths = np.minimum(lengths, cap)
        out = np.zeros((b, int(lengths.max())), np.int32)
        for i, n in enumerate(lengths):
            row = [int(rng.integers(1, top))]
            while len(row) < n:
                v = int(rng.integers(1, top))
                if v != row[-1]:
                    row.append(v)
            out[i, :n] = row
        return out, lengths.astype(np.int32)

    batch = {"wav": wav.astype(np.float32),
             "input_length": np.full(b, N_CHUNKS * 4, np.int32)}
    batch["phones"], batch["phone_length"] = labels(3, 6, N_PHONE_C - 1)
    batch["chars"], batch["char_length"] = labels(2, 5, N_CHAR_C - 1)
    batch["extra_phones"], batch["extra_phone_length"] = labels(
        4, 7, N_PHONE_C - 1)
    batch["extra_chars"], batch["extra_char_length"] = labels(
        2, 5, N_CHAR_C - 1, cap=batch["extra_phone_length"])
    return batch


N_PHONE_C, N_CHAR_C = 12, 16


def chunk_config(outdir, batch_size):
    stack = dict(dmodel=16, head_size=8, num_heads=2, kernel_size=4,
                 dropout=0.0, win_front=6)
    return {"model_config": {
        "name": "ChunkConformer",
        "ChunkConformerFront": {"dmodel": 16, "reduction_factor": 4,
                                "dropout": 0.0, "sample_rate": 16000,
                                "n_mels": 20, "stride_ms": 10,
                                "chunk_num": 16},
        "ChunkConformerEncoder": {**stack, "num_blocks": 2, "win_back": 0},
        "ChunkCTCPicker": {**stack, "num_blocks": 1, "win_back": 0},
        "ChunkCTCDecoder": {**stack, "num_blocks": 1, "win_back": 2},
        "ContextHelper": {**stack, "num_blocks": 1, "win_back": 0}},
        "speech_config": {}, "optimizer_config": dict(ADAM),
        "running_config": {"batch_size": batch_size, "outdir": str(outdir)}}


def local_t_refs(model, batch):
    """Each half's own ``t_ref`` (what a rank would take alone) from the
    picks of the global batch's training-mode forward."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.track_stats = False
    with torch.no_grad():
        fwd = model.train().train_forward(
            torch.from_numpy(batch["wav"]),
            torch.from_numpy(batch["extra_phones"]), None,
            label_width=int(batch["phone_length"].max()))
    counts = fwd["picked_counts"].numpy()
    t = fwd["phone_logits"].shape[1]
    halves = (slice(0, 4), slice(4, 8))
    return int(fwd["t_ref"]), [
        int(np.clip(max(counts[h].max(), batch["phone_length"][h].max()),
                    1, t)) for h in halves]


def test_two_rank_chunk_step_with_rank_dependent_picks(tmp_path):
    batches = [chunk_rows(40 + i) for i in range(2)]
    jcfg = tiny_cfg()
    jmodel, variables, tmodel = build_pair(jcfg, seed=4, n_phone=N_PHONE_C,
                                           n_char=N_CHAR_C,
                                           calib=batches[0]["wav"])
    config = chunk_config(tmp_path, 8)
    assert tcc.ChunkConformerConfig.from_user_config(config) == \
        port_cfg(jcfg)
    probe = tcc.ChunkConformer(tmodel.cfg, N_PHONE_C, N_CHAR_C)
    probe.load_state_dict(tmodel.state_dict())
    t_ref, halves = local_t_refs(probe, batches[0])
    # alone, the ranks would run their helper and decoder at other widths
    assert halves[0] != halves[1] and t_ref == max(halves)

    spec = write_spec(tmp_path, config, tmodel.state_dict(), batches,
                      kind="chunk", n_phone=N_PHONE_C, n_char=N_CHAR_C)
    ranks = step_check.launch(spec, 2, str(tmp_path / "ranks"),
                              RANK_TIMEOUT)
    one = step_check.run(spec)

    mesh = jmesh.make_data_mesh(8)
    jst = jmesh.replicate(jstate.ASRTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        tx=jstate.make_optimizer(ADAM),
        batch_stats=variables["batch_stats"]), mesh)
    jstep = _jax_step(jmodel, None, "padded", "sum")
    for i, batch in enumerate(batches):
        jst, jloss, jm, _ = jstep(jst, jmesh.shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
        want = {k: float(v) for k, v in jm.items()}
        for r in ranks + [one]:
            assert_metrics_close(r["metrics"][i], want)
        for r in ranks:
            assert r["grad_norms"][i] == pytest.approx(one["grad_norms"][i],
                                                       rel=REL)
    assert_ranks_identical(ranks)
    want = convert.chunk_to_torch_names(convert.flatten(jax.tree.map(
        np.asarray, {"params": jst.params,
                     "batch_stats": jst.batch_stats})))
    got = {**values(ranks[0]), **values(ranks[0], "buffers")}
    # this model's f32 gradients carry ~1e-5 of rounding noise
    # (tests/test_torch_chunk_train.py::GRAD_REL); Adam at epsilon 1 passes
    # it on scaled by lr
    assert_leaves_close(got, want, "chunk leaf")
    assert_leaves_close(got, {**values(one), **values(one, "buffers")},
                        "chunk leaf (one process)")


# -- (d) the tensor-parallel rules against JAX's ------------------------------

def tp_model_kw():
    """``tests/test_tp.py``'s model: 4 heads of 4, FFN width 64."""
    return dict(dmodel=16, num_blocks=2, head_size=4, num_heads=4,
                kernel_size=8, dropout=0.0, ctcdecoder_num_blocks=1,
                ctcdecoder_dropout=0.0, translator_num_blocks=1,
                translator_dropout=0.0)


# a JAX leaf's sharded dimension -> the torch weight's: a Dense kernel
# [in, out] is the weight [out, in]; attention q/k/v [in, heads, size] ->
# [heads * size, in], out [heads, size, d] -> [d, heads * size]; a bias
# keeps its leading axis
TORCH_DIM = {("ffn1/kernel", 1): 0, ("ffn1/bias", 0): 0,
             ("ffn2/kernel", 0): 1, ("query/kernel", 1): 0,
             ("key/kernel", 1): 0, ("value/kernel", 1): 0,
             ("query/bias", 0): 0, ("key/bias", 0): 0, ("value/bias", 0): 0,
             ("out/kernel", 0): 1}


@pytest.mark.parametrize("model_axis", [2, 4, 8])
def test_tp_rules_shard_the_leaves_jax_shards(model_axis):
    """The port's placements over ``to_torch_names`` of the flax paths
    against JAX's ``tp_spec`` with its divisibility check, on a model axis
    of 2, 4 and 8: at 8 the 4 heads replicate (the fused [16, 16] q/k/v
    weight would divide and split a head) while ffn1 (64 wide) shards."""
    from jax.sharding import Mesh

    jcfg_kw = tp_model_kw()
    jmodel = jconf.ConformerCTC(jconf.ConformerConfig(**jcfg_kw), 12, 16)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8000), jnp.float32),
                            jnp.ones((1, 5), jnp.int32))["params"]
    mesh = Mesh(np.asarray(jax.devices()[:model_axis]), ("model",))
    tmodel = tconf.ConformerCTC(tconf.ConformerConfig(**jcfg_kw), 12, 16)
    placements = ttp.tp_placements(tmodel, model_axis)
    sharded = set()
    for path, leaf in convert.flatten(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes)).items():
        spec = jtp.tp_spec(path)
        if not jtp._divides(spec, leaf, mesh):
            spec = P()
        (name,) = convert.to_torch_names({f"params/{path}": leaf})
        got = placements[name]
        dims = [d for d, a in enumerate(spec) if a == "model"]
        if not dims:
            assert not got.is_shard(), (path, name, got)
            continue
        key = ("/".join(path.split("/")[-2:]), dims[0])
        assert got.is_shard(TORCH_DIM[key]), (path, name, got)
        sharded.add(name)
    assert set(placements) == set(
        convert.to_torch_names(convert.flatten({"params": jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes)})))
    names = {n.split(".", 1)[0] for n in sharded}
    assert names == {"encoder", "ctc_decoder", "translator"}
    attention = [n for n in sharded if ".mha." in n]
    assert bool(attention) == (model_axis <= 4)
    assert any(n.endswith("ffn1.weight") for n in sharded)


# -- (e) the (data 2 x model 2) TP + DP step ----------------------------------

TP_LR = 1e-2


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """One SGD step of ``tests/test_tp.py``'s model on a (2 x 2) mesh of 4
    gloo ranks, and the same step in one process."""
    tmp = tmp_path_factory.mktemp("tp")
    config = ctc_config(tmp, 4, tp_model_kw())
    trainer = CTCTrainer(config, 12, 16, 11, device="cpu")
    trainer.init_state(seed=5)
    rng = np.random.default_rng(0)
    batch = {"wav": (rng.standard_normal((4, 8000)) * 0.1).astype(
        np.float32), "input_length": np.full(4, 13, np.int32),
        "phones": rng.integers(1, 11, (4, 5)).astype(np.int32),
        "phone_length": np.full(4, 5, np.int32),
        "chars": rng.integers(1, 16, (4, 6)).astype(np.int32)}
    spec = write_spec(tmp, config, trainer.state.model.state_dict(),
                      [batch], n_phone=12, n_char=16, sgd=TP_LR)
    one = step_check.run(spec)
    ranks = step_check.launch(dict(spec, tp=[2, 2]), 4, str(tmp / "ranks"),
                              RANK_TIMEOUT)
    return spec, one, ranks


def test_tp_dp_step_matches_one_process(tp_runs):
    _, one, ranks = tp_runs
    want = one["metrics"][0]["train_loss"]
    for r in ranks:
        got = r["metrics"][0]["train_loss"]
        assert abs(got - want) < 1e-4 * max(1.0, abs(want))
    full = step_check.assemble(ranks)
    ref = values(one)
    assert set(full) == set(ref)
    worst = max(float(np.abs(full[k].numpy() - v).max())
                for k, v in ref.items())
    assert worst < TP_LR * 1e-2
    # the projections stayed sharded, as the rules say
    leaf = ranks[0]["params"]["encoder.blocks.0.ff_module_1.ffn1.weight"]
    assert leaf["dim"] == 0 and leaf["value"].shape == (32, 16)
    leaf = ranks[0]["params"]["encoder.blocks.0.mhsa.mha.out.weight"]
    assert leaf["dim"] == 1 and leaf["value"].shape == (16, 8)
    # the replicated leaves are the same on both ranks of the model axis
    for name, leaf in ranks[0]["params"].items():
        if leaf["dim"] is None:
            assert torch.equal(leaf["value"],
                               ranks[1]["params"][name]["value"]), name


def test_tp_dp_adam_step_with_a_global_norm_clip(tmp_path):
    """Adam with a clip that acts: the global norm adds the squares of the
    sharded gradients over ``model`` and counts the replicated ones once,
    so the (2 x 2) step scales the gradients as one process does."""
    config = ctc_config(tmp_path, 4, tp_model_kw())
    trainer = CTCTrainer(config, 12, 16, 11, device="cpu")
    trainer.init_state(seed=6)
    spec = write_spec(tmp_path, config, trainer.state.model.state_dict(),
                      [ctc_batch(50 + i, 4, 16) for i in range(2)], n_phone=12,
                      n_char=16, grad_clip_norm=1.0)
    one = step_check.run(spec)
    assert one["grad_norms"][0] > 10.0          # the clip acts
    ranks = step_check.launch(dict(spec, tp=[2, 2]), 4,
                              str(tmp_path / "ranks"), RANK_TIMEOUT)
    for r in ranks:
        for got, want in zip(r["metrics"], one["metrics"]):
            assert_metrics_close(got, want, rel=1e-4)
    full = {k: v.numpy() for k, v in step_check.assemble(ranks).items()}
    assert_leaves_close(full, values(one), "param", rel=1e-4)


def test_accumulation_checkpoint_of_two_ranks_resumes_anywhere(tmp_path):
    """``grad_accum_steps`` 2: two ranks take 3 micro-steps and save
    between updates (the pending gradients saved summed over the ranks),
    then resume in two ranks, and in one process, for a 4th: both equal 4
    micro-steps of one process, whose own checkpoint holds the same
    pending gradients."""
    _, _, tmodel = both_models(seed=10)
    batches = [ctc_batch(60 + i, 4) for i in range(4)]
    accum = dict(ADAM, grad_accum_steps=2)
    two, alone = tmp_path / "two", tmp_path / "alone"
    spec = write_spec(tmp_path, ctc_config(two, 4, optimizer=accum),
                      tmodel.state_dict(), batches[:3], save=True)
    step_check.launch(spec, 2, str(tmp_path / "first"), RANK_TIMEOUT)
    straight = step_check.run(write_spec(
        tmp_path / "", ctc_config(alone, 4, optimizer=accum),
        tmodel.state_dict(), batches))
    saved = torch.load(two / "checkpoints" / "ckpt_000000003.pt",
                       weights_only=True)["optimizer"]
    assert saved["mini_step"] == 1 and saved["count"] == 1
    later = write_spec(tmp_path, ctc_config(two, 4, optimizer=accum),
                       tmodel.state_dict(), batches[3:], restore=True)
    resumed = step_check.launch(later, 2, str(tmp_path / "second"),
                                RANK_TIMEOUT)
    assert_ranks_identical(resumed)
    assert_leaves_close(values(resumed[0]), values(straight), "param")
    assert_leaves_close(values(step_check.run(later)), values(straight),
                        "param (one process)")


# -- (f) the depthwise gradient on a (data, model) mesh -----------------------

def test_depthwise_gradient_on_the_mesh_is_not_over_counted(tp_runs):
    """The depthwise kernels are replicated over ``model``, their gradient
    summed over ``data`` only: SGD moved them exactly as the unsharded step
    did, not by a multiple of it (the over-count ``tests/test_tp.py`` pins
    for XLA's grouped convolution)."""
    spec, one, ranks = tp_runs
    start = torch.load(spec["weights"], weights_only=True)
    names = [k for k in start if k.endswith("dw_conv.weight")]
    assert len(names) == 2 + 1 + 1
    for name in names:
        moved_one = one["params"][name]["value"] - start[name]
        moved = ranks[0]["params"][name]["value"] - start[name]
        assert float(moved_one.abs().max()) > 1e-6, name
        torch.testing.assert_close(moved, moved_one, rtol=0,
                                   atol=TP_LR * 1e-4)


# -- (g) dropout masks -------------------------------------------------------

def test_dropout_masks_differ_between_ranks_and_tp_draws_them_whole(
        tmp_path):
    """At dropout 0.1 the two data ranks draw different masks (their
    generators are seeded from (seed, data rank)); a (1 x 2) TP run, whose
    model ranks share one data rank, draws the one-process masks (the
    sharded FFN hidden slices a full-width mask), so it takes the
    one-process step, dropout and all."""
    drop = {**tp_model_kw(), "dropout": 0.1, "ctcdecoder_dropout": 0.1,
            "translator_dropout": 0.1}
    config = ctc_config(tmp_path, 4, drop)
    trainer = CTCTrainer(config, 12, 16, 11, device="cpu")
    trainer.init_state(seed=5)
    rng = np.random.default_rng(1)
    batch = {"wav": (rng.standard_normal((4, 8000)) * 0.1).astype(
        np.float32), "input_length": np.full(4, 13, np.int32),
        "phones": rng.integers(1, 11, (4, 5)).astype(np.int32),
        "phone_length": np.full(4, 5, np.int32),
        "chars": rng.integers(1, 16, (4, 6)).astype(np.int32)}
    spec = write_spec(tmp_path, config, trainer.state.model.state_dict(),
                      [batch], n_phone=12, n_char=16, sgd=TP_LR,
                      probe_dropout=True)
    dp = step_check.launch(spec, 2, str(tmp_path / "dp"), RANK_TIMEOUT)
    a, b = (r["dropped"] for r in dp)
    assert a.shape == b.shape and 0.05 < float(a.float().mean()) < 0.15
    assert not torch.equal(a, b)

    one = step_check.run(spec)
    tp = step_check.launch(dict(spec, tp=[1, 2]), 2, str(tmp_path / "tp"),
                           RANK_TIMEOUT)
    for r in tp:
        assert torch.equal(r["dropped"], one["dropped"])
        assert r["metrics"][0]["train_loss"] == pytest.approx(
            one["metrics"][0]["train_loss"], rel=1e-4)
    full = step_check.assemble(tp)
    worst = max(float(np.abs(full[k].numpy() - v).max())
                for k, v in values(one).items())
    assert worst < TP_LR * 1e-2


def test_rank_seeds_differ_and_rank_0_keeps_the_seed():
    assert tmesh.rank_seed(7, 0) == 7
    seeds = {tmesh.rank_seed(7, r, s) for r in range(4) for s in range(3)}
    assert len(seeds) == 12


# -- (h) train_asr under torchrun --------------------------------------------

def test_train_asr_under_torchrun_restores_in_one_process(corpus, capsys):
    """Two gloo ranks of ``cli.train_asr`` (``torchrun --standalone``): rank
    0 alone writes ``metrics.jsonl`` and the checkpoint, the losses are
    those of the same run in one process, and ``eval_am`` restores the
    checkpoint in one process."""
    from tensorflowasr_tpu_torch.cli.eval_am import main as eval_main
    from tensorflowasr_tpu_torch.cli.train_asr import main as train_main

    tmp_path, dp, mp_ = corpus
    # dropout 0 everywhere: the ranks' masks differ from one process's
    model = yaml.safe_load(open(mp_, encoding="utf-8"))
    model["model_config"].update(ctcdecoder_dropout=0.0,
                                 translator_dropout=0.0)
    with open(mp_, "w", encoding="utf-8") as f:
        yaml.dump(model, f)
    data = yaml.safe_load(open(dp, encoding="utf-8"))
    data["running_config"].update(batch_size=4, log_interval_steps=1,
                                  save_interval_steps=3)
    with open(dp, "w", encoding="utf-8") as f:
        yaml.dump(data, f)
    one_dir = tmp_path / "one"
    data["running_config"]["outdir"] = str(one_dir)
    one_yml = tmp_path / "one.yml"
    one_yml.write_text(yaml.dump(data), encoding="utf-8")
    flags = ["--model_config", mp_, "--device", "cpu", "--compute_dtype",
             "float32", "--total_steps", "3", "--data_workers", "2"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "tensorflowasr_tpu_torch.cli.train_asr", "--data_config", dp,
         "--dist_backend", "gloo"] + flags,
        capture_output=True, text=True, timeout=RANK_TIMEOUT, env=env,
        cwd=str(tmp_path))
    assert run.returncode == 0, run.stderr[-3000:]
    assert train_main(["--data_config", str(one_yml)] + flags) == 0

    logs = tmp_path / "logs"
    assert os.listdir(logs / "checkpoints") == ["ckpt_000000003.pt"]
    logged = [json.loads(line) for line in
              (logs / "metrics.jsonl").read_text().splitlines()]
    alone = [json.loads(line) for line in
             (one_dir / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in logged] == [1, 2, 3]
    for got, want in zip(logged, alone):
        assert got["train_loss"] == pytest.approx(want["train_loss"],
                                                  rel=1e-5)
    # throughput counts the global batch of 4, not a rank's 2 rows
    for m in logged[1:]:
        assert m["examples_per_s"] / m["steps_per_s"] == pytest.approx(4)

    capsys.readouterr()
    assert eval_main(["--data_config", dp, "--model_config", mp_,
                      "--device", "cpu", "--max_batches", "1"]) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    result = json.loads(captured.out.strip().splitlines()[-1])
    assert np.isfinite(result["phone_cer"])


# -- (i) the process group -------------------------------------------------

def test_initialize_is_a_no_op_for_one_process():
    multihost.initialize()
    multihost.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert tmesh.make_data_mesh(8, "cpu") is None
    assert multihost.default_backend("cuda:1") == "nccl"
    assert multihost.default_backend("cpu") == "gloo"
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("localhost:1", 2, 0, backend="mpi")


def test_meshes_in_a_one_rank_process_group(tmp_path, monkeypatch):
    """The mesh helpers on a gloo group of one rank (this process):
    ``make_hybrid_mesh`` is (nodes, ranks a node) with JAX's axis names,
    ``make_data_mesh`` one ``data`` axis, and the batch helpers keep every
    row; the group is left again."""
    import torch.distributed as dist

    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdzv",
                            world_size=1, rank=0)
    try:
        hybrid = multihost.make_hybrid_mesh(device="cpu")
        assert hybrid.mesh_dim_names == ("dcn_data", "data")
        assert tuple(hybrid.mesh.shape) == (1, 1)
        assert tmesh.data_size(hybrid) == 1 and tmesh.data_rank(hybrid) == 0
        mesh = tmesh.make_data_mesh(8, "cpu")
        assert mesh.mesh_dim_names == ("data",)
        assert tmesh.data_group(mesh) is not None
        assert tmesh.batch_spec(mesh)[0].is_shard(0)
        assert tmesh.local_batch_size(5, mesh) == 5
        tp_mesh = tmesh.make_mesh(("data", "model"), (1, 1), "cpu")
        assert tmesh.data_size(tp_mesh) == 1
        with pytest.raises(ValueError, match="multi-axis"):
            tmesh.make_mesh(("data", "model"))
        batch = tmesh.shard_batch({"wav": np.zeros((3, 4), np.float32),
                                   "input_length": np.ones(3, np.int32)},
                                  mesh, "cpu")
        assert batch["wav"].shape == (3, 4)
        assert "input_length_host" in batch
        linear = torch.nn.Linear(2, 2)
        want = {k: v.clone() for k, v in linear.state_dict().items()}
        assert tmesh.replicate(linear, mesh) is linear
        for k, v in linear.state_dict().items():
            assert torch.equal(v, want[k])
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_process_batch_slice_raises_on_an_indivisible_batch(monkeypatch):
    assert multihost.process_batch_slice(16) == slice(0, 16)
    monkeypatch.setattr(multihost, "process_count", lambda: 3)
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    assert multihost.process_batch_slice(9) == slice(3, 6)
    with pytest.raises(ValueError, match="not divisible"):
        multihost.process_batch_slice(16)


def test_host_local_batch_keeps_host_lengths():
    batch = {"wav": np.zeros((2, 4), np.float32),
             "phone_length": np.array([1, 2], np.int32)}
    got = multihost.host_local_batch(batch, device="cpu")
    assert set(got) == {"wav", "phone_length", "phone_length_host"}
    assert got["phone_length_host"].device.type == "cpu"


def test_device_flag_takes_an_index_and_rejects_others():
    from tensorflowasr_tpu_torch.cli.common import config_parser
    from tensorflowasr_tpu_torch.utils.device import resolve_device

    parser = config_parser("x")
    base = ["--data_config", "d", "--model_config", "m"]
    assert parser.parse_args(base + ["--device", "cuda:1"]).device == \
        "cuda:1"
    for bad in ("tpu", "cpu:1"):
        with pytest.raises(SystemExit):
            parser.parse_args(base + ["--device", bad])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:3")


def test_attention_runs_on_a_ranks_share_of_the_heads():
    """``MultiHeadAttention`` reads its head count from the projected
    width: two halves of the heads (q/k/v rows, out columns), each run by
    the same forward, add up to the whole layer (the out bias once)."""
    from tensorflowasr_tpu_torch.models.layers import MultiHeadAttention

    torch.manual_seed(0)
    mha = MultiHeadAttention(16, 4, 4, 16)
    x = torch.randn(2, 5, 16)
    want = mha(x, x)
    got = 0
    for half in range(2):
        rows = slice(8 * half, 8 * half + 8)
        part = MultiHeadAttention(16, 4, 4, 16)
        for p in ("query", "key", "value"):
            getattr(part, p).weight = torch.nn.Parameter(
                getattr(mha, p).weight[rows].detach().clone())
            getattr(part, p).bias = torch.nn.Parameter(
                getattr(mha, p).bias[rows].detach().clone())
        part.out.weight = torch.nn.Parameter(
            mha.out.weight[:, rows].detach().clone())
        part.out.bias = torch.nn.Parameter(
            mha.out.bias.detach() * (1.0 - half))
        got = got + part(x, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
