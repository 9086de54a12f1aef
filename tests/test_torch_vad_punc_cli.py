"""The port's VAD and punctuation CLIs against the JAX package's on one
corpus (``tests/test_cli_extra.py:18-92`` mirrored): ``cli.train_vad`` ->
``cli.eval_vad`` and ``cli.train_punc`` (with teacher features) ->
``cli.eval_punc``, both sides resuming from a step-0 checkpoint of the same
seeded weights, each in its own output directory. After two steps the
port's parameters are within 1e-5 of each leaf's largest entry of JAX's,
each eval restores its own checkpoint (no random-init warning) and prints
the JAX CLI's numbers, and ``eval_vad --export_native`` on the same
weights writes JAX's artifact byte for byte."""

import hashlib
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from tensorflowasr_tpu.cli import common as jcommon
from tensorflowasr_tpu.train.checkpoint import (
    CheckpointManager as JCheckpointManager,
)
from tensorflowasr_tpu.utils.config import UserConfig as JUserConfig
from tensorflowasr_tpu_torch.cli import common as tcommon
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.train.checkpoint import CheckpointManager
from tensorflowasr_tpu_torch.utils.audio import write_wav
from tensorflowasr_tpu_torch.utils.config import UserConfig

torch.set_num_threads(2)

# Adam epsilon 1, as in tests/test_torch_vad_punc_train.py: at 1e-6 an
# entry whose gradient is within the frameworks' rounding noise of 0 steps
# by +-lr on the noise's sign
OPTIMIZER = {"lr": 0.01, "beta1": 0.9, "beta2": 0.98, "epsilon": 1.0}


def perturbed(params, seed):
    """Every leaf moved by noise, so that no leaf starts at 0 (flax inits
    biases to 0) and each is held against its own size."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x, np.float32)
        top = float(np.abs(x).max())
        scale = 0.3 * top if x.ndim > 1 and top > 0 else 0.1
        return (x + scale * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree.map(draw, jax.device_get(params))


def write_configs(tmp_path, data, model):
    """One data YAML a side (its own outdir), one model YAML."""
    paths = {}
    for side in ("jax", "port"):
        d = json.loads(json.dumps(data))
        d["running_config"]["outdir"] = str(tmp_path / f"{side}_logs")
        p = tmp_path / f"{side}_data.yml"
        p.write_text(yaml.dump(d), encoding="utf-8")
        paths[side] = str(p)
    mp = tmp_path / "model.yml"
    mp.write_text(yaml.dump(model), encoding="utf-8")
    return paths, str(mp)


def start_both(build_jax, build_port, paths, model_yml, seed):
    """A step-0 checkpoint of the same perturbed weights in each side's
    outdir. Returns those weights (flax params)."""
    _, jstate = build_jax(JUserConfig(paths["jax"], model_yml))
    params = perturbed(jstate.params, seed)
    JCheckpointManager(os.path.join(
        yaml.safe_load(open(paths["jax"]))["running_config"]["outdir"],
        "checkpoints")).save(0, jstate.replace(params=params))
    model, state = build_port(UserConfig(paths["port"], model_yml))
    convert.load_flax_variables(model, {"params": params})
    save_port(state, paths["port"], 0)
    return params


def save_port(state, data_yml, step):
    outdir = yaml.safe_load(open(data_yml))["running_config"]["outdir"]
    state.step = step
    CheckpointManager(os.path.join(outdir, "checkpoints")).save(step, state)


def restored_jax_params(build_jax, data_yml, model_yml):
    config = JUserConfig(data_yml, model_yml)
    _, state = build_jax(config)
    state = jcommon.restore_or_warn(
        state, config.section("running_config")["outdir"], "test")
    return state


def assert_params_close(model, jparams):
    want = convert.to_torch_names(convert.flatten(
        {"params": jax.tree.map(np.asarray, jparams)}))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(),
                                   rtol=0, atol=1e-5 * float(w.abs().max()),
                                   err_msg=k)


def last_json(capsys):
    captured = capsys.readouterr()
    return json.loads(captured.out.strip().splitlines()[-1]), captured


# -- VAD ----------------------------------------------------------------------

def vad_jax_build(config):
    return jcommon.build_vad_model(config)


def vad_port_build(config):
    return tcommon.build_vad_model(config, "cpu")


@pytest.fixture()
def vad_setup(tmp_path):
    sr = 8000
    rng = np.random.default_rng(0)
    paths = []
    for i in range(5):
        quiet = 0.002 * rng.standard_normal(int(rng.uniform(0.1, 0.3) * sr))
        t = np.arange(int(rng.uniform(0.3, 0.6) * sr)) / sr
        tone = 0.6 * np.sin(2 * np.pi * (250 + 60 * i) * t)
        p = tmp_path / f"v{i}.wav"
        write_wav(str(p), np.concatenate([quiet, tone, quiet]).astype(
            np.float32), sr)
        paths.append(str(p))
    (tmp_path / "vad.list").write_text("\n".join(paths), encoding="utf-8")
    data = {
        "speech_config": {"sample_rate": sr, "frame_input": 80,
                          "max_frames": 8000, "voice_thread": 0.4,
                          "streaming": True, "streaming_min_frame": 8},
        "running_config": {"train_list": str(tmp_path / "vad.list"),
                           "eval_list": str(tmp_path / "vad.list"),
                           "batch_size": 2, "log_interval_steps": 1,
                           "save_interval_steps": 2},
        "augments_config": None,
        "optimizer_config": OPTIMIZER,
    }
    model = {"model_config": {"name": "CNN_Online_VAD", "dmodel": 8}}
    return write_configs(tmp_path, data, model)


def test_train_and_eval_vad_cli_match_jax(vad_setup, tmp_path, capsys):
    """Streaming on: every batch is folded by ``streaming_reshape`` from
    the same seeded generator on both sides."""
    from tensorflowasr_tpu.cli.eval_vad import main as jax_eval
    from tensorflowasr_tpu.cli.train_vad import main as jax_train
    from tensorflowasr_tpu_torch.cli.eval_vad import main as eval_main
    from tensorflowasr_tpu_torch.cli.train_vad import main as train_main

    paths, model_yml = vad_setup
    start_both(vad_jax_build, vad_port_build, paths, model_yml, seed=1)
    for fn, side, extra in ((jax_train, "jax", []),
                            (train_main, "port", ["--device", "cpu"])):
        assert fn(["--data_config", paths[side], "--model_config",
                   model_yml, "--total_steps", "2", "--compute_dtype",
                   "float32"] + extra) == 0
    assert sorted(os.listdir(tmp_path / "port_logs" / "checkpoints")) == [
        "ckpt_000000000.pt", "ckpt_000000002.pt"]
    jst = restored_jax_params(vad_jax_build, paths["jax"], model_yml)
    assert int(jst.step) == 2
    model, state = vad_port_build(UserConfig(paths["port"], model_yml))
    state = tcommon.restore_or_warn(state, str(tmp_path / "port_logs"), "t")
    assert state.step == 2
    assert_params_close(model, jst.params)
    got_log = [json.loads(x) for x in
               (tmp_path / "port_logs" / "metrics.jsonl").read_text()
               .splitlines()]
    want_log = [json.loads(x) for x in
                (tmp_path / "jax_logs" / "metrics.jsonl").read_text()
                .splitlines()]
    assert [(m["step"], m.get("split")) for m in got_log] == \
        [(m["step"], m.get("split")) for m in want_log] == \
        [(1, None), (1, "eval"), (2, None), (2, "eval")]
    for g, w in zip(got_log, want_log):
        for k in ("train_loss", "vad_loss", "wav_loss", "vad_acc", "f1"):
            if k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-5), k

    capsys.readouterr()
    out = {}
    for fn, side, extra in ((jax_eval, "jax", []),
                            (eval_main, "port", ["--device", "cpu"])):
        assert fn(["--data_config", paths[side], "--model_config",
                   model_yml, "--max_batches", "2"] + extra) == 0
        out[side], captured = last_json(capsys)
        assert "no VAD checkpoint" not in captured.err
    assert set(out["port"]) == {"acc", "f1"}
    for k in ("acc", "f1"):
        assert out["port"][k] == pytest.approx(out["jax"][k], abs=1e-6), k


def test_eval_vad_export_native_is_byte_equal_to_jax(vad_setup, tmp_path,
                                                     capsys):
    """On the same weights (JAX's step-0 checkpoint copied into the port's
    outdir), the two eval_vad calls print the same JSON and write the same
    native artifact, byte for byte."""
    from tensorflowasr_tpu.cli.eval_vad import main as jax_eval
    from tensorflowasr_tpu_torch.cli.eval_vad import main as eval_main

    paths, model_yml = vad_setup
    start_both(vad_jax_build, vad_port_build, paths, model_yml, seed=2)
    out = {}
    for fn, side, extra in ((jax_eval, "jax", []),
                            (eval_main, "port", ["--device", "cpu"])):
        assert fn(["--data_config", paths[side], "--model_config",
                   model_yml, "--max_batches", "2", "--export_native",
                   str(tmp_path / f"{side}_native")] + extra) == 0
        out[side], captured = last_json(capsys)
        assert "no VAD checkpoint" not in captured.err
        assert "native VAD artifact written" in captured.out
    for k in ("acc", "f1"):
        assert out["port"][k] == pytest.approx(out["jax"][k], abs=1e-6), k
    names = sorted(os.listdir(tmp_path / "jax_native"))
    assert names and names == sorted(os.listdir(tmp_path / "port_native"))
    for name in names:
        assert (tmp_path / "port_native" / name).read_bytes() == \
            (tmp_path / "jax_native" / name).read_bytes(), name


def test_eval_vad_without_checkpoint_warns(vad_setup, capsys):
    from tensorflowasr_tpu_torch.cli.eval_vad import main as eval_main

    paths, model_yml = vad_setup
    assert eval_main(["--data_config", paths["port"], "--model_config",
                      model_yml, "--max_batches", "1", "--device",
                      "cpu"]) == 0
    out, captured = last_json(capsys)
    assert "no VAD checkpoint" in captured.err and set(out) == {"acc", "f1"}


# -- punctuation -------------------------------------------------------------

PUNC_LINES = ["ab，cd。", "abc。", "fed，ab。", "dcba，fe？", "eab。cd，ef。"]


def punc_jax_build(config):
    _, _, model, state = jcommon.build_punc_model(config)
    return model, state


def punc_port_build(config):
    _, _, model, state = tcommon.build_punc_model(config, "cpu")
    return model, state


@pytest.fixture()
def punc_setup(tmp_path):
    (tmp_path / "chars.txt").write_text(
        "\n".join(["<S>", "</S>"] + list("abcdef")), encoding="utf-8")
    (tmp_path / "puncs.txt").write_text(
        "\n".join(["<S>", "</S>", "，", "。", "？"]), encoding="utf-8")
    (tmp_path / "punc.list").write_text("\n".join(PUNC_LINES) + "\n",
                                        encoding="utf-8")
    # seeded teacher features, one .npy a line under the loader's name
    feats = tmp_path / "bert"
    feats.mkdir()
    rng = np.random.default_rng(3)
    for line in PUNC_LINES:
        n = sum(ch in "abcdef" for ch in line) + 2
        name = hashlib.sha1(line.encode("utf-8")).hexdigest()[:16]
        np.save(feats / f"{name}.npy",
                rng.standard_normal((n, 24)).astype(np.float32))
    data = {
        "punc_vocab": {"vocabulary": str(tmp_path / "chars.txt"),
                       "blank_at_zero": True},
        "punc_biaodian": {"vocabulary": str(tmp_path / "puncs.txt"),
                          "blank_at_zero": True},
        "running_config": {"train_list": str(tmp_path / "punc.list"),
                           "eval_list": str(tmp_path / "punc.list"),
                           "batch_size": 2, "max_len": 16,
                           "log_interval_steps": 1,
                           "save_interval_steps": 2},
        "optimizer_config": OPTIMIZER,
    }
    model = {"model_config": {"num_layers": 2, "d_model": 16,
                              "enc_embedding_dim": 16, "num_heads": 2,
                              "dff": 16, "pe_input": 64, "rate": 0.0,
                              "bert_dim": 24}}
    paths, model_yml = write_configs(tmp_path, data, model)
    return paths, model_yml, str(feats)


def test_train_and_eval_punc_cli_match_jax(punc_setup, tmp_path, capsys):
    """Dropout 0 (its masks cannot match); teacher features on."""
    from tensorflowasr_tpu.cli.eval_punc import main as jax_eval
    from tensorflowasr_tpu.cli.train_punc import main as jax_train
    from tensorflowasr_tpu_torch.cli.eval_punc import main as eval_main
    from tensorflowasr_tpu_torch.cli.train_punc import main as train_main

    paths, model_yml, feats = punc_setup
    start_both(punc_jax_build, punc_port_build, paths, model_yml, seed=4)
    for fn, side, extra in ((jax_train, "jax", []),
                            (train_main, "port", ["--device", "cpu"])):
        assert fn(["--data_config", paths[side], "--model_config",
                   model_yml, "--total_steps", "2", "--bert_feature_dir",
                   feats] + extra) == 0
    # the loader's offset is saved after every batch, as JAX's
    for name in ("epoch", "offset"):
        got = np.load(tmp_path / "port_logs" / "dg_state.npz")[name]
        assert got == np.load(tmp_path / "jax_logs" / "dg_state.npz")[name]
    jst = restored_jax_params(punc_jax_build, paths["jax"], model_yml)
    model, state = punc_port_build(UserConfig(paths["port"], model_yml))
    state = tcommon.restore_or_warn(state, str(tmp_path / "port_logs"), "t")
    assert state.step == int(jst.step) == 2
    assert_params_close(model, jst.params)
    got_log = [json.loads(x) for x in
               (tmp_path / "port_logs" / "metrics.jsonl").read_text()
               .splitlines()]
    want_log = [json.loads(x) for x in
                (tmp_path / "jax_logs" / "metrics.jsonl").read_text()
                .splitlines()]
    # a train line and an eval pass a step
    assert [m.get("split") for m in got_log] == \
        [m.get("split") for m in want_log] == [None, "eval"] * 2
    for g, w in zip(got_log, want_log):
        assert g["feature_map_loss"] > 0
        for k in ("train_loss", "bd_loss", "feature_map_loss", "bd_acc"):
            if k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-5), k

    capsys.readouterr()
    out = {}
    for fn, side, extra in ((jax_eval, "jax", []),
                            (eval_main, "port", ["--device", "cpu"])):
        assert fn(["--data_config", paths[side], "--model_config",
                   model_yml, "--max_batches", "2"] + extra) == 0
        out[side], captured = last_json(capsys)
        assert "no punctuation checkpoint" not in captured.err
    assert set(out["port"]) == {"bd_acc", "bd_loss"}
    assert out["port"]["bd_acc"] == pytest.approx(out["jax"]["bd_acc"],
                                                  abs=1e-6)
    assert out["port"]["bd_loss"] == pytest.approx(out["jax"]["bd_loss"],
                                                   rel=1e-5)
