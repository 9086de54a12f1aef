"""The port's block-streaming ConformerCTC (``speech_config.streaming:
true``, ``configs/Streaming_ConformerS.yml``) against the JAX package's, on
the CPU, from the same weights: the encoder (chunks folded into the batch
before the frontend, each chunk isolated), the whole model, three Adam
steps with SpecAugment off, ``cli.eval_am`` and ``cli.test_asr`` (with the
ValueError both raise on a wav that is not a whole number of chunks) and
``OfflineASRSession`` over the streaming model. Ids must be identical,
values within 1e-5 of each output's (or leaf's) largest entry."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_serve import Vocab, speech, top2_margin
from tests.test_torch_serve import randomize as fan_in_randomize
from tests.test_torch_train import (
    ZERO_GRADIENT,
    assert_leaves_close,
    configs,  # noqa: F401  (a fixture)
    save_as_jax_checkpoint,
    torch_leaves,
)
from tests.test_torch_train import randomize as small_bias_randomize
from tensorflowasr_tpu.models import conformer as jconf
from tensorflowasr_tpu.serve.engines import ASREngine as JASREngine
from tensorflowasr_tpu.serve.offline_session import (
    OfflineASRSession as JOfflineASRSession,
)
from tensorflowasr_tpu.train import asr_trainer as jtrain
from tensorflowasr_tpu.train import state as jstate
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.ops import frontend as fe
from tensorflowasr_tpu_torch.serve.engines import ASREngine
from tensorflowasr_tpu_torch.serve.offline_session import OfflineASRSession
from tensorflowasr_tpu_torch.train import asr_trainer as ttrain
from tensorflowasr_tpu_torch.train import state as tstate
from tensorflowasr_tpu_torch.utils.audio import write_wav

torch.set_num_threads(2)

SR = 16000
CHUNK = 7680                   # streaming_bucket 0.5 s at 16 kHz, 12 frames
N_PHONE, N_CHAR = 11, 17
STREAM = dict(streaming=True, streaming_bucket=0.5)
TINY = dict(dmodel=32, num_blocks=2, head_size=16, num_heads=2,
            kernel_size=8, ctcdecoder_num_blocks=1, ctcdecoder_kernel_size=8,
            translator_num_blocks=2, translator_kernel_size=8,
            dropout=0.0, ctcdecoder_dropout=0.0, translator_dropout=0.0)


def rel_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_chunk_samples_and_config_field_match_jax():
    for bucket in (0.5, 0.3, 0.01, 1.0):
        got = tconf.ConformerConfig(streaming_bucket=bucket).chunk_samples
        want = jconf.ConformerConfig(streaming_bucket=bucket).chunk_samples
        assert got == want
    assert tconf.ConformerConfig().chunk_samples == CHUNK


def init_shapes(jmodel):
    return jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, CHUNK), jnp.float32),
                          jnp.ones((1, 4), jnp.int32))


@pytest.fixture(scope="module")
def streaming_pair():
    """(flax model, variables, port model) of a tiny streaming
    ConformerCTC, with fan-in scaled kernels and zero biases so that the
    ids vary (``tests/test_torch_serve.py``)."""
    jmodel = jconf.ConformerCTC(jconf.ConformerConfig(**TINY, **STREAM),
                                N_PHONE, N_CHAR)
    variables = fan_in_randomize(init_shapes(jmodel), 5)
    tcfg = tconf.ConformerConfig(**TINY, **STREAM)
    tmodel = tconf.ConformerCTC(tcfg, N_PHONE, N_CHAR)
    tmodel.load_state_dict(convert.convert_flax_variables(variables, tcfg))
    return jmodel, variables, tmodel.eval()


def test_encoder_and_whole_model_match_jax_chunks_isolated(streaming_pair):
    jmodel, variables, tmodel = streaming_pair
    assert isinstance(tmodel.encoder, tconf.StreamingConformerEncoder)
    wav = speech(3 * CHUNK / SR, seed=3)[None].repeat(2, 0)
    wav[1] = speech(3 * CHUNK / SR, seed=4)
    ids = np.random.default_rng(1).integers(1, N_PHONE, (2, 9)).astype(
        np.int32)

    @jax.jit
    def forward(variables, wav, ids):
        return jmodel.apply(variables, wav, ids)

    want = forward(variables, wav, ids)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(wav), torch.from_numpy(ids))
    assert got[0].shape == (2, 3 * 12, 32)
    for g, w, what in zip(got, want, ("enc", "ctc", "char")):
        assert rel_err(g, w) < 1e-5, what
    # chunk isolation: the folded encode is the per-chunk encodes joined
    with torch.no_grad():
        parts = [tmodel.encode(torch.from_numpy(wav[:, i:i + CHUNK]))
                 for i in range(0, 3 * CHUNK, CHUNK)]
    torch.testing.assert_close(torch.cat(parts, 1), got[0], rtol=0,
                               atol=1e-5)
    # the fold comes before the frontend: a log-mel of the whole wav,
    # reshaped after, is normalised by another max and padded elsewhere
    cfg = fe.LogMelFrontendConfig(padding="same")
    x = torch.from_numpy(wav)
    folded = fe.log_mel_spectrogram(x.reshape(6, CHUNK), cfg)
    whole = fe.log_mel_spectrogram(x, cfg).reshape(6, 48, 80)
    assert float((folded - whole).abs().max()) > 1.0


def test_length_not_a_whole_number_of_chunks_raises_as_in_jax(
        streaming_pair):
    jmodel, variables, tmodel = streaming_pair
    wav = np.zeros((1, CHUNK + 640), np.float32)
    with pytest.raises(ValueError, match="not a multiple"):
        jmodel.apply(variables, wav, method=jconf.ConformerCTC.encode)
    with pytest.raises(ValueError, match="not a multiple"):
        tmodel.encode(torch.from_numpy(wav))


def test_converter_carries_the_streaming_model_unchanged(streaming_pair):
    """The streaming encoder's parameters have the offline names: the same
    flax tree loads into both, and reads back unchanged."""
    _, variables, tmodel = streaming_pair
    offline = tconf.ConformerCTC(tconf.ConformerConfig(**TINY), N_PHONE,
                                 N_CHAR)
    assert list(offline.state_dict()) == list(tmodel.state_dict())
    flat = convert.flatten(jax.tree.map(np.asarray, variables))
    back = convert.to_flax_names(tmodel)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_from_user_config_reads_streaming_as_jax(tmp_path):
    from tensorflowasr_tpu.utils.config import UserConfig as JUserConfig
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = yaml.safe_load(open(os.path.join(root, "configs",
                                            "am_data.yml")))
    data["speech_config"].update(streaming=True, streaming_bucket=0.25)
    dp = tmp_path / "d.yml"
    dp.write_text(yaml.dump(data))
    mp = os.path.join(root, "configs", "Streaming_ConformerS.yml")
    got = tconf.ConformerConfig.from_user_config(UserConfig(str(dp), mp))
    want = jconf.ConformerConfig.from_user_config(JUserConfig(str(dp), mp))
    assert got.streaming and got.streaming_bucket == 0.25
    assert got.chunk_samples == want.chunk_samples == 3840
    assert (got.dmodel, got.num_blocks, got.kernel_size) == (256, 4, 5)
    for name in ("dmodel", "num_blocks", "head_size", "num_heads",
                 "kernel_size", "translator_num_blocks", "streaming",
                 "streaming_bucket"):
        assert getattr(got, name) == getattr(want, name), name


# -- training -----------------------------------------------------------------

def train_batch(seed, b=3, n_chunks=2, l=6, u=5):
    """Ragged labels; input_length counts the chunks' encoder frames, as
    the streaming loader's does (one row a chunk short)."""
    rng = np.random.default_rng(seed)
    phones = rng.integers(1, N_PHONE - 1, (b, l)).astype(np.int32)
    chars = rng.integers(1, N_CHAR, (b, u)).astype(np.int32)
    phone_length = np.array([l, l - 2, l - 1], np.int32)[:b]
    for i, n in enumerate(phone_length):
        phones[i, n:] = 0
    chars[1, u - 2:] = 0
    frames = n_chunks * 12
    return {"wav": (rng.standard_normal((b, n_chunks * CHUNK)) * 0.1
                    ).astype(np.float32),
            "input_length": np.array([frames, frames - 12, frames],
                                     np.int32)[:b],
            "phones": phones, "phone_length": phone_length, "chars": chars}


# As in tests/test_torch_chunk_train.py: the f32 gradients carry rounding
# noise of a few 1e-6 of a leaf's largest entry, and Adam with its usual
# epsilon of 1e-6 turns an entry whose gradient is within that noise of 0
# into a step of +-lr on the noise's sign (one conv weight here moved 8.2e-6
# apart in three steps, 1.3e-5 of its leaf's largest entry). Epsilon 1 keeps
# the steps proportional to the gradient, which is itself held to 1e-5 of
# each leaf's largest entry at every step; the update at 1e-6 is tested on
# given gradients in tests/test_torch_train.py. The gradients are held as
# there, to GRAD_REL of each leaf's largest entry: a small leaf (an
# attention key kernel whose entries are about 1e-4 of the largest gradient
# entry anywhere) carries noise of 1.3e-5 of its own largest entry at the
# third step.
ADAM = {"lr": 1e-2, "epsilon": 1.0}
GRAD_REL = 5e-5


def test_three_adam_steps_match_jax():
    """SpecAugment off (its masks cannot match across frameworks). At each
    step the loss, the metrics and every gradient leaf; after three steps
    the parameters and the BatchNorm statistics."""
    jcfg = jconf.ConformerConfig(**TINY, **STREAM)
    jmodel = jconf.ConformerCTC(jcfg, N_PHONE, N_CHAR)
    variables = small_bias_randomize(init_shapes(jmodel), 8)
    tcfg = tconf.ConformerConfig(**TINY, **STREAM)
    tmodel = tconf.ConformerCTC(tcfg, N_PHONE, N_CHAR)
    tmodel.load_state_dict(convert.convert_flax_variables(variables, tcfg))

    tx = jstate.make_optimizer(ADAM)
    jst = jstate.ASRTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"], tx=tx,
        batch_stats=variables["batch_stats"])

    @jax.jit
    def jstep(state, batch):
        """``jtrain.make_train_step``'s step, also handing back its
        gradient."""
        (_, (metrics, stats)), grads = jax.value_and_grad(
            lambda p: jtrain._loss_and_metrics(
                jmodel, p, state.batch_stats, batch, jax.random.PRNGKey(1),
                N_PHONE - 1, True), has_aux=True)(state.params)
        state = state.apply_gradients(grads=grads).replace(
            batch_stats=stats)
        return state, metrics, grads

    grads = []

    def mark(stage):
        if stage == "backward":
            grads.append({k: p.grad.clone()
                          for k, p in tmodel.named_parameters()})

    tst = tstate.ASRTrainState(
        tmodel, tstate.make_optimizer(tmodel.parameters(), ADAM),
        torch.Generator().manual_seed(0))
    tstep = ttrain.make_train_step(N_PHONE - 1, mark=mark)
    for i in range(3):
        batch = train_batch(seed=20 + i)
        jst, jm, jgrads = jstep(jst, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        tst, tm = tstep(tst, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5,
                                                 abs=1e-6), (i, k)
        want = torch_leaves(jgrads)
        assert_leaves_close(grads[i], want, GRAD_REL, f"grad {i}",
                            skip=ZERO_GRADIENT)
        # the leaves that are zero in exact arithmetic: noise well under
        # 1e-5 of the largest gradient entry anywhere
        top = max(float(g.abs().max()) for g in want.values())
        for k, g in grads[i].items():
            if k.endswith(ZERO_GRADIENT):
                assert float(g.abs().max()) < 1e-5 * top, (i, k)
    assert tst.step == 3 and int(jst.step) == 3
    assert_leaves_close(dict(tmodel.named_parameters()),
                        torch_leaves(jst.params), 1e-5, "param")
    start = torch_leaves(variables["params"])
    moved = max(float((p.detach() - start[k]).abs().max())
                for k, p in tmodel.named_parameters())
    assert moved > 1e-3
    stats = convert.to_torch_names(convert.flatten(
        {"batch_stats": jax.tree.map(np.asarray, jst.batch_stats)}))
    assert_leaves_close(dict(tmodel.named_buffers()), stats, 1e-5, "stat")


def test_spec_augment_is_per_chunk(monkeypatch):
    """In training mode SpecAugment runs on the folded [B * n, 48, 80]
    log-mel, so its time bands are at most time_ratio of a chunk."""
    from tensorflowasr_tpu_torch.models import layers

    cfg = tconf.ConformerConfig(**TINY, **STREAM, spec_augment=True,
                                specaug_time_ratio=0.1)
    model = tconf.ConformerCTC(cfg, N_PHONE, N_CHAR).train()
    layers.set_generator(model, torch.Generator().manual_seed(0))
    seen, real = [], tconf.spec_augment

    def spy(mel, *a, **kw):
        out = real(mel, *a, **kw)
        seen.append((mel, out))
        return out

    monkeypatch.setattr(tconf, "spec_augment", spy)
    model.encode(torch.from_numpy(speech(3 * CHUNK / SR, seed=1)[None]))
    (mel, out), = seen
    assert mel.shape == (3, 48, 80)
    # a time band fills whole rows with the chunk's mean: 2 bands of at
    # most round(48 * 0.1) = 5 rows each
    fill = mel.mean(dim=(1, 2), keepdim=True)
    masked_rows = (out == fill).all(-1) & ~(mel == fill).all(-1)
    assert masked_rows.any() and int(masked_rows.sum(-1).max()) <= 10


# -- CLIs --------------------------------------------------------------------

@pytest.fixture()
def streaming_configs(configs):  # noqa: F811
    tmp_path, data_yml, model_yml, model_cfg = configs
    data = yaml.safe_load(open(data_yml))
    data["speech_config"].update(streaming=True, streaming_bucket=0.5)
    with open(data_yml, "w") as f:
        yaml.dump(data, f)
    return tmp_path, data_yml, model_yml, model_cfg


def test_eval_am_and_test_asr_cli_match_jax(streaming_configs, capsys):
    """The port trains the streaming model 4 steps; the JAX CLIs restore
    the same weights. eval_am's error rates are equal, test_asr's phones
    and chars too on a wav of 2 chunks; on a wav that is not a whole number
    of chunks both raise ValueError, since JAX's test_asr pads only to hop
    x reduction factor (``tensorflowasr_tpu/utils/audio.py:86-95``)."""
    from tensorflowasr_tpu.cli.eval_am import main as jax_eval_main
    from tensorflowasr_tpu.cli.test_asr import main as jax_test_main
    from tensorflowasr_tpu.utils.config import UserConfig as JConfig
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.cli.eval_am import main as eval_main
    from tensorflowasr_tpu_torch.cli.test_asr import main as test_main
    from tensorflowasr_tpu_torch.cli.train_asr import main as train_main
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    tmp_path, data_yml, model_yml, model_cfg = streaming_configs
    common = ["--data_config", data_yml, "--model_config", model_yml,
              "--device", "cpu"]
    assert train_main(common + ["--compute_dtype", "float32",
                                "--total_steps", "4",
                                "--data_workers", "0"]) == 0
    capsys.readouterr()
    assert eval_main(common + ["--max_batches", "2"]) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    got = json.loads(captured.out.strip().splitlines()[-1])

    config = UserConfig(data_yml, model_yml)
    phone_f, char_f = build_featurizers(config)[:2]
    trainer = ttrain.CTCTrainer(config, phone_f.num_classes,
                                char_f.num_classes, phone_f.blank,
                                device="cpu")
    trainer.init_state()
    assert trainer.restore() and trainer.state.step == 4
    assert isinstance(trainer.state.model.encoder,
                      tconf.StreamingConformerEncoder)
    jax_model_yml = tmp_path / "jm.yml"
    jax_model_yml.write_text(yaml.dump({**model_cfg, "running_config": {
        "batch_size": 2, "outdir": str(tmp_path / "jax_logs")}}))
    jtrainer = jtrain.CTCTrainer(JConfig(data_yml, str(jax_model_yml)),
                                 phone_f.num_classes, char_f.num_classes,
                                 blank_id=phone_f.blank)
    assert jtrainer.model_cfg.streaming
    jtrainer.init_state({"wav": np.zeros((1, CHUNK), np.float32),
                         "phones": np.ones((1, 4), np.int32)})
    save_as_jax_checkpoint(jtrainer, trainer.state.model, 4)
    jcommon = ["--data_config", data_yml, "--model_config",
               str(jax_model_yml)]
    assert jax_eval_main(jcommon + ["--max_batches", "2"]) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    want = json.loads(captured.out.strip().splitlines()[-1])
    assert got == want
    # the loader quantises 1 s to 2 chunks of 12 frames: 8 phones scored
    assert got["phone_N"] == 16 and got["char_N"] == 8

    whole, ragged = tmp_path / "whole.wav", tmp_path / "ragged.wav"
    write_wav(str(whole), speech(2 * CHUNK / SR, seed=7), SR)
    write_wav(str(ragged), speech(1.0, seed=7), SR)
    outs = []
    for fn, args in ((test_main, common), (jax_test_main, jcommon)):
        assert fn(args + ["--wav", str(whole), "--compute_dtype",
                          "float32"]) == 0
        captured = capsys.readouterr()
        assert "no checkpoint found" not in captured.err
        outs.append([line for line in captured.out.splitlines()
                     if line.startswith(("phones:", "chars :"))])
        with pytest.raises(ValueError, match="not a multiple"):
            fn(args + ["--wav", str(ragged), "--compute_dtype", "float32"])
    assert outs[0] == outs[1] and len(outs[0]) == 2


# -- serving -----------------------------------------------------------------

def test_offline_session_over_the_streaming_model_matches_jax(
        streaming_pair):
    """``OfflineASRSession`` (no VAD) feeds one 7680-sample chunk at a time
    through ``ASREngine.extract_feature``: the texts equal JAX's session's,
    and the per-chunk encodes joined equal the folded encode of the padded
    file, since block streaming isolates chunks."""
    jmodel, variables, tmodel = streaming_pair
    vocab = Vocab(N_CHAR)
    jasr = JASREngine(jmodel, variables, chunk_seconds=0.5, sample_rate=SR,
                      text_featurizer=vocab)
    asr = ASREngine(tmodel, chunk_seconds=0.5, sample_rate=SR,
                    text_featurizer=vocab)
    assert asr.chunk_samples == jasr.chunk_samples == CHUNK
    texts = []
    for seconds, seed in ((2.0, 1), (3.5, 2)):
        wav = speech(seconds, seed)
        want = JOfflineASRSession(jasr).transcribe_wav(wav)
        got = OfflineASRSession(asr).transcribe_wav(wav)
        assert got == want
        texts.append(got[0]["text"])
        n = -(-len(wav) // CHUNK)
        encs = [asr.extract_feature(wav[s:s + CHUNK])
                for s in range(0, len(wav), CHUNK)]
        padded = np.zeros((1, n * CHUNK), np.float32)
        padded[0, :len(wav)] = wav
        with torch.no_grad():
            folded = tmodel.encode(torch.from_numpy(padded))[0].numpy()
        joined = np.concatenate(encs)
        np.testing.assert_allclose(joined, folded[:len(joined)], rtol=0,
                                   atol=1e-5)
        # no near-tie decides the phone ids
        with torch.no_grad():
            logits = tmodel.ctc_logits(torch.from_numpy(joined[None]))
        assert top2_margin(logits.numpy()) > 1e-4
        phones = asr.decode_phones(encs)
        assert phones == jasr.decode_phones(encs) and phones
        texts.append(phones)
    # the decodes say something, and not the same for both files
    assert any(t for t in texts[::2]) and texts[1] != texts[3]


@pytest.fixture(scope="module")
def vad_punc_engines(streaming_pair):
    """JAX's and the port's ASR (the streaming model), VAD and punctuation
    engines on the same weights, the VAD and punctuation calibrated as in
    tests/test_torch_stream_session.py."""
    from tests.test_torch_stream_session import THRESHOLD, PuncVocab, nested
    from tensorflowasr_tpu.models import punc as jpunc
    from tensorflowasr_tpu.models import vad as jvad
    from tensorflowasr_tpu.serve import engines as jeng
    from tensorflowasr_tpu_torch.models import punc as tpunc
    from tensorflowasr_tpu_torch.models import vad as tvad
    from tensorflowasr_tpu_torch.models.layers import init_weights_
    from tensorflowasr_tpu_torch import testing as synth
    from tensorflowasr_tpu_torch.serve import engines as teng

    jmodel, variables, tmodel = streaming_pair
    stream = synth.tone_bursts(synth.STREAM_PATTERN, seed=1)
    vad = tvad.OnlineVAD()
    init_weights_(vad, torch.Generator().manual_seed(5))
    assert synth.calibrate_vad(vad, stream) > 1.0
    punc = tpunc.PuncTransformer(tpunc.PuncConfig(), len(PuncVocab.tokens),
                                 2 + len(synth.PUNC_TOKENS))
    init_weights_(punc, torch.Generator().manual_seed(4))
    ids = np.random.default_rng(5).integers(3, len(PuncVocab.tokens),
                                            (8, 64))
    ids[:, 0], ids[:, -1] = 1, 2
    synth.calibrate_punc(punc, ids, THRESHOLD)
    vocab = Vocab(N_CHAR)
    jax_side = dict(
        asr=JASREngine(jmodel, variables, chunk_seconds=0.5, sample_rate=SR,
                       text_featurizer=vocab),
        vad=jeng.VADEngine(jvad.OnlineVAD(),
                           nested(convert.to_flax_names(vad)),
                           frame_input=80),
        punc=jeng.PuncEngine(jpunc.PuncTransformer(
            jpunc.PuncConfig(), len(PuncVocab.tokens),
            2 + len(synth.PUNC_TOKENS)), nested(convert.to_flax_names(punc)),
            PuncVocab(), synth.PUNC_TOKENS, threshold=THRESHOLD))
    port_side = dict(
        asr=ASREngine(tmodel, chunk_seconds=0.5, sample_rate=SR,
                      text_featurizer=vocab),
        vad=teng.VADEngine(vad, device="cpu"),
        punc=teng.PuncEngine(punc, PuncVocab(), synth.PUNC_TOKENS,
                             threshold=THRESHOLD, device="cpu"))
    return jax_side, port_side, stream


def test_sessions_with_vad_over_the_streaming_model_match_jax(
        vad_punc_engines):
    """The live ``StreamASRSession`` and the VAD-segmented, punctuated
    ``OfflineASRSession`` over the streaming model: events and segments
    equal JAX's sessions'."""
    from tests.test_torch_stream_session import run_stream
    from tensorflowasr_tpu.serve.stream_session import (
        StreamASRSession as JStreamASRSession,
    )
    from tensorflowasr_tpu_torch import testing as synth
    from tensorflowasr_tpu_torch.serve.stream_session import (
        StreamASRSession,
    )

    jax_side, port_side, stream = vad_punc_engines
    want = run_stream(JStreamASRSession, stream, jax_side)[0]
    got = run_stream(StreamASRSession, stream, port_side)[0]
    assert got == want
    types = [e["event_type"] for e in got]
    assert types.count("sentence begin") == types.count("sentence end") == 2
    wav = synth.tone_bursts(synth.file_pattern(5.0), seed=12)
    want = JOfflineASRSession(jax_side["asr"], jax_side["vad"],
                              jax_side["punc"]).transcribe_wav(wav)
    got = OfflineASRSession(port_side["asr"], port_side["vad"],
                            port_side["punc"]).transcribe_wav(wav)
    assert got == want
    assert len(got) == sum(loud for _, loud in synth.file_pattern(5.0))
