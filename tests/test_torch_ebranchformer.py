"""E-Branchformer CTC (``models/ebranchformer.py``) against the plain f32
reference of ``tests/plain_ebranchformer.py`` at a small size on the CPU:
the relative shift against the explicit gather of ``p_{i-j}``, the key
mask, the encoder and both heads' logits on a padded batch of unequal
lengths, one ``CTCTrainer`` step (loss, gradients, updated weights), the
model through ``ASREngine``'s pieces, the dispatch on ``model_config.name``
through the CLIs; and a ConformerCTC's ids unchanged now that the predict
step hands ``encode`` the frame lengths."""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

sys.path.insert(0, os.path.dirname(__file__))

import plain_ebranchformer as plain  # noqa: E402
from tensorflowasr_tpu_torch.models import layers  # noqa: E402
from tensorflowasr_tpu_torch.models.conformer import (  # noqa: E402
    ConformerConfig,
    ConformerCTC,
    build_model,
    count_params,
)
from tensorflowasr_tpu_torch.models.ebranchformer import (  # noqa: E402
    EBranchformerConfig,
    EBranchformerCTC,
    offline_config,
)
from tensorflowasr_tpu_torch.serve.engines import (  # noqa: E402
    ASREngine,
    predict_step,
)
from tensorflowasr_tpu_torch.train.asr_trainer import (  # noqa: E402
    CTCTrainer,
    make_train_step,
)
from tensorflowasr_tpu_torch.utils.config import UserConfig  # noqa: E402

N_PHONE, N_CHAR = 11, 17
TINY = dict(name="EBranchformerCTC", dmodel=32, num_blocks=2, num_heads=4,
            head_size=8, linear_units=64, cgmlp_linear_units=96,
            cgmlp_conv_kernel=7, merge_conv_kernel=7, kernel_size=7,
            ctcdecoder_num_blocks=1, ctcdecoder_kernel_size=7,
            translator_num_blocks=1, translator_kernel_size=7)
# f32 against f32: the port and the reference sum in other orders (the
# shift against the gather, fused against unfused products) and differ by
# rounding, ~1e-6 of the largest entry measured; 1e-5 leaves 10x of room
# while a wrong term moves them by O(1)
F32_TOL = 1e-5


def tiny_cfg(**over) -> EBranchformerConfig:
    return offline_config({"model_config": dict(TINY, **over),
                           "speech_config": {}}, "float32")


def sizes(cfg) -> dict:
    return dataclasses.asdict(cfg)


def perturbed_model(cfg, seed=0):
    """A model whose every leaf is nonzero and not at its initial value
    (zero biases, unit norms and BatchNorm statistics perturbed), so that
    each weight reaches the outputs."""
    model = build_model(cfg, N_PHONE, N_CHAR, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            noise = torch.randn(t.shape, generator=g)
            if name.endswith("running_var"):
                t.copy_(1.0 + 0.2 * noise.abs())
            elif name.endswith(("bias", "running_mean", "pos_bias_u",
                                "pos_bias_v")) or "norm" in name \
                    or ".ln." in name:
                t.add_(0.05 * noise)
    return model


def weights(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def padded_batch(seed=0, seconds=(1.0, 0.62, 0.3)):
    """Noise rows of unequal lengths zero padded to the longest, and their
    frame lengths (samples // 640, as the loader gives them)."""
    g = torch.Generator().manual_seed(seed)
    n = [int(s * 16000) for s in seconds]
    wav = torch.zeros(len(n), max(n))
    for r, k in enumerate(n):
        wav[r, :k] = 0.1 * torch.randn(k, generator=g)
    return wav, torch.tensor([k // 640 for k in n], dtype=torch.int32)


def assert_close(got, want, tol=F32_TOL):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"{err} > {tol} x {scale}"


@pytest.mark.parametrize("t", [1, 2, 5, 17])
def test_the_shift_trick_equals_the_gather(t):
    x = torch.randn(2, 3, t, 2 * t - 1)
    i, j = torch.arange(t)[:, None], torch.arange(t)[None]
    assert torch.equal(layers.rel_shift(x), x[..., i, (t - 1) - (i - j)])


def test_relative_positions_match_the_reference():
    assert torch.equal(torch.from_numpy(layers.rel_positional_encoding(6, 8)),
                       plain.rel_positions(6, 8))


@pytest.mark.parametrize("side", ["port", "plain"])
def test_padded_keys_leave_the_valid_frames_alone(side):
    """Whatever the frames past a row's length hold, the attention output
    of its valid frames is the same, bit for bit: the masked keys' weights
    are exactly zero."""
    cfg = tiny_cfg()
    model = perturbed_model(cfg)
    attn = model.encoder.blocks[0].attn
    w = {"a." + k: v for k, v in attn.state_dict().items()}
    t, length = 9, torch.tensor([9, 4])
    pos = torch.from_numpy(layers.rel_positional_encoding(t, cfg.dmodel))
    x = torch.randn(2, t, cfg.dmodel)
    y = x.clone()
    y[1, 4:] = 100.0 * torch.randn(t - 4, cfg.dmodel)

    def run(inp):
        if side == "port":
            return attn(inp, pos, layers.key_mask(length, t))
        return plain.rel_attention(w, "a", inp, pos, length, cfg.num_heads,
                                   None, 0.0)
    with torch.no_grad():
        a, b = run(x), run(y)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1, :4], b[1, :4])
    assert not torch.equal(a[1, 4:], b[1, 4:])


def test_encoder_and_both_heads_match_the_plain_reference():
    cfg = tiny_cfg()
    model = perturbed_model(cfg).eval()
    W, m = weights(model), sizes(cfg)
    wav, lengths = padded_batch()
    with torch.no_grad():
        enc = model.encode(wav, lengths)
        want = plain.encode(W, m, wav, lengths)
        assert_close(enc, want)
        logits = model.ctc_logits(enc)
        assert_close(logits, plain.ctc_logits(W, m, want))
        ids, _ = plain.greedy(logits, lengths, N_PHONE - 1)
        ids = torch.nn.functional.pad(ids, (0, 10))
        assert_close(model.translate(ids, enc),
                     plain.translate(W, m, ids, want))
        # without lengths every key counts: another answer for short rows
        free = model.encode(wav)
    assert torch.equal(free[0], enc[0])
    assert not torch.allclose(free[2], enc[2])


def test_one_train_step_matches_the_plain_reference():
    """Loss, every parameter's gradient and its change after one Adam step
    (epsilon 1: at 1e-6 Adam turns the rounding noise of a zero gradient,
    such as an attention key bias's, into a full +-lr step), dropout on,
    the reference drawing its masks from the same generator state in the
    same order."""
    cfg = tiny_cfg()
    model = perturbed_model(cfg)
    W, m = weights(model), sizes(cfg)
    wav, lengths = padded_batch(seed=3)
    batch = {"wav": wav, "input_length": lengths,
             "phones": torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0],
                                     [7, 0, 0, 0]], dtype=torch.int32),
             "phone_length": torch.tensor([4, 2, 1], dtype=torch.int32),
             "chars": torch.tensor([[3, 4, 2], [5, 2, 0], [6, 2, 0]],
                                   dtype=torch.int32)}
    lr = 1e-2
    opt = {"lr": lr, "beta1": 0.9, "beta2": 0.98, "epsilon": 1.0}
    trainer = CTCTrainer({"model_config": TINY, "speech_config": {},
                          "optimizer_config": opt, "running_config": {}},
                         N_PHONE, N_CHAR, N_PHONE - 1, device="cpu")
    state = trainer.init_state(seed=5)
    state.model.load_state_dict(W)
    gen = torch.Generator().set_state(state.generator.get_state())
    grads = {}

    def mark(stage):
        if stage == "backward":
            grads.update({k: p.grad.clone() for k, p in
                          state.model.named_parameters()})
    step = make_train_step(N_PHONE - 1, mark)
    _, metrics = step(state, batch)
    ref = plain.train_step(W, m, batch, gen, lr, 0.9, 0.98, 1.0)
    assert float(metrics["train_loss"]) == pytest.approx(ref["loss"],
                                                         rel=F32_TOL)
    # each leaf against the larger of its own and the median leaf's size,
    # so that a leaf whose exact gradient is zero is held to the others';
    # measured 5.4e-6 (rounding through the backward); 1e-4 leaves 18x.
    # The change after the step: 1.2e-5 x lr measured, the f32 spacing of
    # a weight near 1 (1.2e-7) against a step of ~lr; 1e-4 x lr leaves 8x
    med = float(np.median([float(g.abs().max())
                           for g in ref["grad"].values()]))
    after = dict(state.model.named_parameters())
    assert set(grads) == set(ref["grad"])
    for k, g in ref["grad"].items():
        scale = max(float(g.abs().max()), med)
        assert float((grads[k] - g).abs().max()) <= 1e-4 * scale, k
        moved = after[k].detach() - W[k]
        want = ref["new"][k] - W[k]
        assert float((moved - want).abs().max()) <= 1e-4 * lr, k


def test_asr_engine_pieces_match_the_plain_reference():
    """A 1.3 s file through ``ASREngine``: each 0.48 s piece encoded in one
    batch with its valid frames as its length, as the reference encodes
    the piece alone; the decoded ids the reference's greedy ids."""
    cfg = tiny_cfg()
    model = perturbed_model(cfg).eval()
    W, m = weights(model), sizes(cfg)
    engine = ASREngine(model, chunk_seconds=0.5)
    wav = 0.1 * torch.randn(20800, generator=torch.Generator().manual_seed(7))
    outs = engine.encode_pieces([wav[i:i + 7680].numpy()
                                 for i in range(0, 20800, 7680)])
    for k, out in enumerate(outs):
        piece = torch.zeros(1, 7680)
        n = min(7680, 20800 - 7680 * k)
        piece[0, :n] = wav[7680 * k:7680 * k + n]
        frames = min(12, -(-n // 640))
        with torch.no_grad():
            want = plain.encode(W, m, piece, torch.tensor([frames]))
        assert out.shape == (frames, cfg.dmodel)
        assert_close(torch.from_numpy(out), want[0, :frames])
    ids, lens, _ = engine._decode(outs, 1)
    enc = torch.from_numpy(np.concatenate(outs))[None]
    t = enc.shape[1]                       # 33 frames, padded to 3 chunks
    enc = torch.nn.functional.pad(enc, (0, 0, 0, 36 - t))
    with torch.no_grad():
        want, n = plain.greedy(plain.ctc_logits(W, m, enc),
                               torch.tensor([t]), N_PHONE - 1)
    assert int(lens[0]) == int(n[0])
    assert np.array_equal(ids[0, :int(n[0])], want[0, :int(n[0])].numpy())


def test_a_conformer_gives_the_same_ids_with_the_lengths_passed():
    """``predict_step`` now hands ``encode`` the frame lengths; a
    ConformerCTC masks nothing, so its phones and chars are bit-identical
    to the encode without them."""
    cfg = ConformerConfig(dmodel=16, num_blocks=1, head_size=8, num_heads=2,
                          kernel_size=4, ctcdecoder_kernel_size=4,
                          translator_num_blocks=1, translator_kernel_size=4)
    model = build_model(cfg, N_PHONE, N_CHAR, device="cpu", seed=2)
    wav, lengths = padded_batch(seed=4)
    with torch.no_grad():
        enc = model.encode(wav)
        assert torch.equal(model.encode(wav, lengths), enc)
        phones, plens, chars = predict_step(model, wav, lengths)
        logits = model.ctc_logits(enc)
    want, n = plain.greedy(logits, lengths, N_PHONE - 1)
    assert torch.equal(plens.long(), n)
    for r in range(wav.shape[0]):
        assert torch.equal(phones[r, :n[r]].long(), want[r, :n[r]])
    padded = torch.nn.functional.pad(phones, (0, 10))
    with torch.no_grad():
        assert torch.equal(chars, torch.argmax(model.translate(padded, enc),
                                               -1).to(torch.int32))


def test_the_name_selects_the_model():
    assert type(tiny_cfg()) is EBranchformerConfig
    conformer = {"model_config": {"name": "OfflineConformerCTC"},
                 "speech_config": {}}
    assert type(offline_config(conformer)) is ConformerConfig
    assert type(build_model(tiny_cfg(), N_PHONE, N_CHAR, "cpu")) \
        is EBranchformerCTC
    assert isinstance(build_model(tiny_cfg(), N_PHONE, N_CHAR, "cpu"),
                      ConformerCTC)
    with pytest.raises(ValueError, match="spec_augment"):
        build_model(dataclasses.replace(tiny_cfg(), spec_augment=True),
                    N_PHONE, N_CHAR, "cpu")


def test_the_shipped_configuration_at_its_published_widths():
    """``configs/ebranchformerL.yml``: 512 wide, 17 blocks, 8 x 64 heads,
    FFN 1024, cgMLP 3072, kernels 31; the parameter count the benchmark's
    configuration file gives (built on the meta device)."""
    root = os.path.dirname(os.path.dirname(__file__))
    cfg = offline_config(UserConfig(
        os.path.join(root, "configs/am_data.yml"),
        os.path.join(root, "configs/ebranchformerL.yml")))
    assert (cfg.dmodel, cfg.num_blocks, cfg.num_heads, cfg.head_size,
            cfg.linear_units, cfg.cgmlp_linear_units, cfg.cgmlp_conv_kernel,
            cfg.merge_conv_kernel, cfg.norm_eps) == (512, 17, 8, 64, 1024,
                                                      3072, 31, 31, 1e-12)
    with torch.device("meta"):
        model = EBranchformerCTC(cfg, 231, 9161)
    assert count_params(model.encoder) == 116270080
    assert count_params(model) == 142017712
    with open(os.path.join(root, "benchmark/configs/ebranchformer_l.json"),
              encoding="utf-8") as f:
        assert json.load(f)["count_params"] == {"encoder": 116270080,
                                                "model": 142017712}


# -- the CLIs -----------------------------------------------------------------

@pytest.fixture()
def cli_configs(tmp_path):
    """A four-utterance corpus of tones and the tiny E-Branchformer."""
    from tensorflowasr_tpu_torch.utils.audio import write_wav

    lines = []
    for i, txt in enumerate(["ni3 hao3", "shi4 jie4", "ni3 shi4",
                             "hao3 jie4"]):
        p = tmp_path / f"u{i}.wav"
        t = np.arange(16000) / 16000
        write_wav(str(p), (0.5 * np.sin(2 * np.pi * (200 + 40 * i) * t))
                  .astype(np.float32), 16000)
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
    data = {"speech_config": {
        "sample_rate": 16000, "stride_ms": 10, "reduction_factor": 4,
        "wav_max_duration": 2, "train_list": str(tmp_path / "train.list"),
        "eval_list": str(tmp_path / "train.list"),
        "pinyin_map": str(tmp_path / "p2p.map"),
        "transcripts_are_pinyin": True},
        "inp_config": {"vocabulary": str(tmp_path / "phones.txt"),
                       "blank_at_zero": False},
        "tar_config": {"vocabulary": str(tmp_path / "chars.txt"),
                       "blank_at_zero": False},
        "augments_config": None, "optimizer_config": {"lr": 0.003},
        "running_config": {"batch_size": 2, "log_interval_steps": 2,
                           "eval_interval_steps": 1000,
                           "save_interval_steps": 4,
                           "outdir": str(tmp_path / "logs")}}
    dp, mp = tmp_path / "data.yml", tmp_path / "model.yml"
    dp.write_text(yaml.dump(data), encoding="utf-8")
    mp.write_text(yaml.dump({"model_config": TINY}), encoding="utf-8")
    return tmp_path, ["--data_config", str(dp), "--model_config", str(mp),
                      "--compute_dtype", "float32", "--device", "cpu"]


def test_train_eval_and_test_cli(cli_configs, capsys):
    """``train_asr`` trains an EBranchformerCTC through ``CTCTrainer`` and
    saves it; ``eval_am`` and ``test_asr`` restore and score it;
    ``test_asr --weights`` (a JAX Conformer's layout) is refused."""
    from tensorflowasr_tpu_torch.cli.eval_am import main as eval_main
    from tensorflowasr_tpu_torch.cli.test_asr import main as test_main
    from tensorflowasr_tpu_torch.cli.train_asr import main as train_main
    tmp_path, common = cli_configs
    assert train_main(common + ["--total_steps", "4",
                                "--data_workers", "0"]) == 0
    state = torch.load(tmp_path / "logs" / "checkpoints"
                       / "ckpt_000000004.pt", weights_only=False)
    assert any(".attn.pos_bias_u" in k for k in state["model"])
    lines = (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()
    assert np.isfinite(json.loads(lines[-1])["train_loss"])
    capsys.readouterr()
    assert eval_main(common + ["--max_batches", "2"]) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    result = json.loads(captured.out.strip().splitlines()[-1])
    assert result["phone_N"] == 16 and result["char_N"] == 8
    assert test_main(common + ["--wav", str(tmp_path / "u1.wav")]) == 0
    captured = capsys.readouterr()
    assert "random init" not in captured.err
    assert "phones:" in captured.out
    with pytest.raises(ValueError, match="EBranchformerCTC"):
        test_main(common + ["--wav", str(tmp_path / "u1.wav"),
                            "--weights", "w.npz"])
