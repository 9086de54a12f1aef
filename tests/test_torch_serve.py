"""The port's serving path against the JAX package's, from the same weights:
``predict_step`` vs ``make_predict_step``, ``ASREngine`` +
``OfflineASRSession`` vs their JAX counterparts, and the ``test_asr`` CLI.
Phone ids, lengths and char ids must be identical."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from tensorflowasr_tpu.models import conformer as jconf
from tensorflowasr_tpu.serve.engines import ASREngine as JASREngine
from tensorflowasr_tpu.serve.offline_session import (
    OfflineASRSession as JOfflineASRSession,
)
from tensorflowasr_tpu.train.asr_trainer import make_predict_step
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.serve.engines import ASREngine, predict_step
from tensorflowasr_tpu_torch.serve.offline_session import (
    MIN_PIECE_SAMPLES,
    OfflineASRSession,
)

torch.set_num_threads(2)

SR = 16000
TINY = dict(dmodel=32, num_blocks=2, head_size=16, num_heads=2,
            kernel_size=8, ctcdecoder_num_blocks=1, ctcdecoder_kernel_size=8,
            translator_num_blocks=2, translator_kernel_size=8)
State = collections.namedtuple("State", "params batch_stats")


class Vocab:
    """Char read-out: id -> token, ``</S>`` is id 1."""

    def __init__(self, n):
        self.tokens = ["<pad>", "</S>"] + [f"c{i}" for i in range(n - 2)]

    def iextract(self, ids):
        if isinstance(ids, list):
            return [self.tokens[i] for i in ids]
        return self.tokens[ids]

    def endid(self):
        return 1


def randomize(shapes, seed):
    """Fan-in scaled random kernels with zero biases and unit norms: an
    untrained Conformer with random biases answers every frame alike, and
    ids that never change would test little. (The bias and statistic
    mappings are held in tests/test_torch_model.py.)"""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        leaf, parent = path[-1].key, path[-2].key
        if leaf == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if leaf == "scale":
            return np.ones(x.shape, np.float32)
        if leaf == "embedding":
            return rng.standard_normal(x.shape).astype(np.float32)
        if leaf == "kernel":
            fan_in = (x.shape[0] if parent in ("query", "key", "value",
                                                "dw_conv")
                      else int(np.prod(x.shape[:-1])))
            return (rng.standard_normal(x.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return np.zeros(x.shape, np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def pair(n_phone, n_char, seed=3, **kw):
    """(flax model, its variables, the port's model with those weights)."""
    jcfg = jconf.ConformerConfig(dropout=0.0, ctcdecoder_dropout=0.0,
                                 translator_dropout=0.0, **TINY, **kw)
    jmodel = jconf.ConformerCTC(jcfg, n_phone, n_char)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3200), jnp.float32),
                            jnp.ones((1, 4), jnp.int32))
    variables = randomize(shapes, seed)
    tcfg = tconf.ConformerConfig(**TINY, **kw)
    tmodel = tconf.ConformerCTC(tcfg, n_phone, n_char)
    tmodel.load_state_dict(convert.convert_flax_variables(variables, tcfg))
    return jmodel, variables, tmodel.eval()


def speech(seconds, seed):
    """50 ms segments of two random tones at one of three loudness levels:
    frames that differ enough for a random-weight model to tell apart."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    wav = np.zeros(n)
    for s in range(0, n, 800):
        tones = sum(np.sin(2 * np.pi * f * t[s:s + 800])
                    for f in rng.uniform(100, 6000, 2))
        wav[s:s + 800] = tones * rng.choice([0.001, 0.05, 1.0])
    return (0.3 * wav).astype(np.float32)


def top2_margin(logits, lengths=None):
    top = np.sort(np.asarray(logits, np.float64), axis=-1)
    margin = top[..., -1] - top[..., -2]
    if lengths is not None:
        margin = np.concatenate([m[:n] for m, n in zip(margin, lengths)])
    return margin.min()


def test_predict_step_identical_ids():
    n_phone, n_char = 11, 17
    jmodel, variables, tmodel = pair(n_phone, n_char, seed=11)
    lens_s = (1.5, 1.0)
    wav = np.zeros((2, int(max(lens_s) * SR)), np.float32)
    for i, s in enumerate(lens_s):
        wav[i, :int(s * SR)] = speech(s, seed=i)
    in_len = np.array([int(s * SR) // 640 for s in lens_s], np.int32)

    state = State(variables["params"], variables["batch_stats"])
    want = [np.asarray(a) for a in make_predict_step(jmodel, n_phone - 1)(
        state, jnp.asarray(wav), jnp.asarray(in_len))]
    got = [a.numpy() for a in predict_step(
        tmodel, torch.from_numpy(wav), torch.from_numpy(in_len))]

    # ids can only agree if no argmax is a near tie: check the seed gives
    # top-2 margins of at least 1e-3 on every decision both sides make
    @jax.jit
    def logits(variables, wav, phone_ids):
        enc = jmodel.apply(variables, wav, method=jconf.ConformerCTC.encode)
        padded = jnp.pad(phone_ids, ((0, 0), (0, 10)))
        return (jmodel.apply(variables, enc,
                             method=jconf.ConformerCTC.ctc_logits),
                jmodel.apply(variables, padded, enc,
                             method=jconf.ConformerCTC.translate))

    ctc, chars = logits(variables, wav, want[0])
    assert top2_margin(ctc, in_len) >= 1e-3
    assert top2_margin(chars) >= 1e-3

    assert want[1].tolist() == got[1].tolist() and min(got[1]) > 2
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_engine_and_offline_session_match_jax():
    n_phone, n_char = 11, 17
    jmodel, variables, tmodel = pair(n_phone, n_char, seed=2)
    vocab = Vocab(n_char)
    jeng = JASREngine(jmodel, variables, chunk_seconds=0.5, sample_rate=SR,
                      text_featurizer=vocab)
    teng = ASREngine(tmodel, chunk_seconds=0.5, sample_rate=SR,
                     text_featurizer=vocab)
    assert (teng.chunk_samples, teng.chunk_frames) == \
        (jeng.chunk_samples, jeng.chunk_frames)

    wav = speech(1.3, seed=5)
    # one quantum, a short piece, and a piece longer than one chunk
    for piece in (wav[:teng.chunk_samples], wav[:3000], wav):
        np.testing.assert_allclose(teng.extract_feature(piece),
                                   jeng.extract_feature(piece),
                                   rtol=0, atol=1e-4)
    encs = [jeng.extract_feature(wav[:7680]), jeng.extract_feature(wav[7680:])]
    assert teng.decode(encs) == jeng.decode(encs)
    assert teng.decode_phones(encs) == jeng.decode_phones(encs)
    assert len(set(teng.decode_phones(encs))) > 1

    got = OfflineASRSession(teng).transcribe_wav(wav)
    want = JOfflineASRSession(jeng).transcribe_wav(wav)
    assert got == want
    assert len(got) == 1 and got[0]["text"]


@pytest.fixture(scope="module")
def engines():
    """(the port's engine, JAX's engine) over the same weights."""
    n_phone, n_char = 11, 17
    jmodel, variables, tmodel = pair(n_phone, n_char, seed=2)
    vocab = Vocab(n_char)
    return (ASREngine(tmodel, chunk_seconds=0.5, sample_rate=SR,
                      text_featurizer=vocab),
            JASREngine(jmodel, variables, chunk_seconds=0.5, sample_rate=SR,
                       text_featurizer=vocab))


# (whole pieces, samples of a trailing piece): one piece, a trailing short
# piece, whole groups of pad_chunks, a trailing piece the session drops
# (under MIN_PIECE_SAMPLES), and more than two groups
@pytest.mark.parametrize("whole,tail", [(1, 0), (1, 3000), (4, 0),
                                        (4, MIN_PIECE_SAMPLES // 2),
                                        (8, 5000)])
def test_batched_pieces_equal_one_encode_a_piece(engines, whole, tail):
    teng, jeng = engines
    chunk = teng.chunk_samples
    wav = speech((whole * chunk + tail) / SR, seed=whole + tail)
    pieces = [wav[s:s + chunk] for s in range(0, len(wav), chunk)]
    assert len(pieces) == whole + (tail > 0)
    alone = [teng.extract_feature(p) for p in pieces]   # B = 1 each
    batched = teng.encode_pieces(pieces)
    assert [b.shape for b in batched] == [a.shape for a in alone]
    for b, a in zip(batched, alone):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    np.testing.assert_allclose(teng.extract_feature(wav),
                               np.concatenate(alone), rtol=0, atol=1e-5)

    got = OfflineASRSession(teng).transcribe_wav(wav)
    want = JOfflineASRSession(jeng).transcribe_wav(wav)
    assert got == want and got[0]["text"]


def test_unported_serving_options_raise():
    """Every serving option is ported now. The beam decoder (``beam_width``)
    gives JAX's beam engine's phones (tests/test_torch_lm_cli.py holds it
    with an n-gram LM); a VAD and a punctuation engine are ported
    (tests/test_torch_stream_session.py holds them to JAX's), so the
    session takes both: VAD segments, punctuation on each text."""
    jmodel, variables, tmodel = pair(11, 17)
    beam = ASREngine(tmodel, beam_width=4, text_featurizer=Vocab(17))
    jbeam = JASREngine(jmodel, variables, text_featurizer=Vocab(17),
                       beam_width=4)
    encs = [jbeam.extract_feature(speech(0.48, seed=s)) for s in (7, 8)]
    assert beam.decode_phones(encs) == jbeam.decode_phones(encs)
    assert beam.decode_phones(encs)
    eng = ASREngine(tmodel, text_featurizer=Vocab(17))

    class EnergyVAD:
        frame_input = 80

        def inference(self, frames):
            e = np.abs(frames).mean(axis=-1).flatten()
            return np.where(e > 0.01, 1.0, -1.0)

    class Stop:
        def punc_recover(self, chars):
            return list(chars) + ["."]

    wav = np.concatenate([np.zeros(SR // 2, np.float32), speech(1.0, seed=4),
                          np.zeros(SR // 2, np.float32),
                          speech(1.0, seed=5)])
    segs = OfflineASRSession(eng, vad=EnergyVAD(),
                             punc=Stop()).transcribe_wav(wav)
    assert len(segs) >= 2 and segs[0]["start_s"] >= 0.45
    assert all(s["text"].endswith(".") for s in segs
               if len(s["text"]) >= 5 * 2)
    assert OfflineASRSession(eng).transcribe_wav(wav)[0]["start_s"] == 0.0


@pytest.fixture()
def cli_configs(tmp_path):
    (tmp_path / "phones.txt").write_text(
        "\n".join(["n", "i3", "h", "ao3", "sh", "i4", "j", "ie4"]),
        encoding="utf-8")
    (tmp_path / "chars.txt").write_text(
        "\n".join(["<S>", "</S>", "ni3", "hao3", "shi4", "jie4"]),
        encoding="utf-8")
    data_cfg = {
        "speech_config": {"sample_rate": SR, "stride_ms": 10,
                          "reduction_factor": 4, "num_feature_bins": 80},
        "inp_config": {"vocabulary": str(tmp_path / "phones.txt"),
                       "blank_at_zero": False},
        "tar_config": {"vocabulary": str(tmp_path / "chars.txt"),
                       "blank_at_zero": False},
    }
    model_cfg = {"model_config": dict(name="OfflineConformerCTC", **TINY)}
    dp, mp = tmp_path / "data.yml", tmp_path / "model.yml"
    dp.write_text(yaml.dump(data_cfg), encoding="utf-8")
    mp.write_text(yaml.dump(model_cfg), encoding="utf-8")
    wav_path = tmp_path / "utt.wav"
    pcm = (speech(1.23, seed=6) * 32767).astype(np.int16)
    wavfile.write(str(wav_path), SR, pcm)
    return tmp_path, str(dp), str(mp), str(wav_path)


def _printed(out, label):
    line = next(ln for ln in out.splitlines() if ln.startswith(label))
    return line.split(":", 1)[1].strip()


def test_cli_test_asr_matches_jax(cli_configs, capsys):
    from tensorflowasr_tpu.export.native_export import _flatten
    from tensorflowasr_tpu.utils.audio import SpeechFeaturizer
    from tensorflowasr_tpu.utils.text import TextFeaturizer
    from tensorflowasr_tpu_torch.cli.test_asr import main

    tmp_path, data_yml, model_yml, wav_path = cli_configs
    phone_f = TextFeaturizer({"vocabulary": str(tmp_path / "phones.txt")})
    char_f = TextFeaturizer({"vocabulary": str(tmp_path / "chars.txt")})
    jmodel, variables, _ = pair(phone_f.num_classes, char_f.num_classes,
                                seed=15)
    weights = tmp_path / "weights.npz"
    np.savez(weights, **dict(_flatten(variables)))

    args = ["--data_config", data_yml, "--model_config", model_yml,
            "--wav", wav_path, "--device", "cpu",
            "--compute_dtype", "float32"]
    assert main(args + ["--weights", str(weights)]) == 0
    out = capsys.readouterr().out
    assert "RTF" in out and "on cpu" in out

    # the JAX package on the same preprocessing (pad to hop x rf, peak
    # normalise, floor input length)
    sf = SpeechFeaturizer({"sample_rate": SR})
    wav = sf.load_wav(wav_path)
    padded = sf.pad_signal(wav)
    padded = padded / np.abs(padded).max()
    in_len = np.array([len(wav) // 640], np.int32)
    state = State(variables["params"], variables["batch_stats"])
    ids, lens, chars = make_predict_step(jmodel, phone_f.blank)(
        state, jnp.asarray(padded[None]), jnp.asarray(in_len))
    phones = phone_f.iextract(list(np.asarray(ids)[0, :int(lens[0])]))
    want_chars = []
    for v in np.asarray(chars)[0]:
        if v == 0 or v == char_f.endid():
            break
        want_chars.append(char_f.iextract(int(v)))
    assert len(phones) > 3
    assert _printed(out, "phones:") == " ".join(phones)
    assert _printed(out, "chars :") == "".join(want_chars)

    # no weights: seeded random init, with a warning
    assert main(args) == 0
    captured = capsys.readouterr()
    assert "random init" in captured.err and "phones:" in captured.out


def test_cli_cuda_without_cuda_raises(cli_configs):
    from tensorflowasr_tpu_torch.cli.test_asr import main

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    _, data_yml, model_yml, wav_path = cli_configs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--data_config", data_yml, "--model_config", model_yml,
              "--wav", wav_path])
