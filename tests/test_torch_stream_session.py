"""The port's VAD and punctuation serving against the JAX package's objects,
from the same weights (``tests/test_serve.py:89-253`` mirrored): the
``TaskContent`` event flow, the offline segmenter's merge and re-split,
``StreamASRSession`` end to end on pcm16 packets, ``PuncEngine`` with OOV
chars and windowed long input, ``OfflineASRSession`` with VAD and
punctuation, ``build_asr_ops`` with a VAD engine, ``cli.serve_model`` with
the VAD configs and ``cli.test_punc``.

The VAD (``configs/vad_model.yml`` width) and the punctuation model
(``configs/punc_settings.yml`` width) are seeded random inits with their
last layer calibrated (``tensorflowasr_tpu_torch/testing.py``), so that
tone bursts are voiced, gaps silent and some punctuation is inserted; every
decision both sides take is checked for a near-tie, and the events and
texts must vary."""

import uuid

import jax
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_serve import Vocab, pair
from tensorflowasr_tpu.models import punc as jpunc
from tensorflowasr_tpu.models import vad as jvad
from tensorflowasr_tpu.serve import engines as jeng
from tensorflowasr_tpu.serve import model_server as jms
from tensorflowasr_tpu.serve import vad_machine as jvm
from tensorflowasr_tpu.serve.offline_session import (
    OfflineASRSession as JOfflineASRSession,
)
from tensorflowasr_tpu.serve.stream_session import (
    StreamASRSession as JStreamASRSession,
)
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.models import punc as tpunc
from tensorflowasr_tpu_torch.models import vad as tvad
from tensorflowasr_tpu_torch.models.layers import init_weights_
from tensorflowasr_tpu_torch import testing as synth
from tensorflowasr_tpu_torch.serve import engines as teng
from tensorflowasr_tpu_torch.serve import model_server as tms
from tensorflowasr_tpu_torch.serve import vad_machine as tvm
from tensorflowasr_tpu_torch.serve.offline_session import OfflineASRSession
from tensorflowasr_tpu_torch.serve.stream_session import StreamASRSession

torch.set_num_threads(2)

SR = 16000
N_PHONE, N_CHAR = 11, 17
THRESHOLD = 0.65
MARGIN = 1e-4          # least distance of a decision from its threshold


class PuncVocab:
    """The punctuation model's chars: the ASR's c0..c14 but every fifth
    (c4, c9, c14), which stay out of the vocabulary (OOV)."""

    tokens = ["<pad>", "<S>", "</S>"] + [f"c{i}" for i in range(15)
                                         if i % 5 != 4]

    def has(self, t):
        return t in self.tokens

    def extract(self, toks):
        return [self.tokens.index(t) for t in toks]

    def startid(self):
        return 1

    def endid(self):
        return 2


def nested(flat):
    tree = {}
    for name, arr in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def energy_vad(frames):
    e = np.abs(frames).mean(axis=-1).flatten()
    return np.where(e > 0.01, 1.0, -1.0)


class Recorder:
    """Wraps a JAX engine method, keeping what it returned."""

    def __init__(self, obj, name):
        self.seen, fn = [], getattr(obj, name)

        def wrapped(*a):
            out = fn(*a)
            self.seen.append(np.asarray(out))
            return out
        setattr(obj, name, wrapped)


@pytest.fixture(scope="module")
def models():
    """(JAX engines, port engines) on the same weights, and the stream."""
    jasr_model, asr_vars, tasr_model = pair(N_PHONE, N_CHAR, seed=2)
    stream = synth.tone_bursts(synth.STREAM_PATTERN, seed=1)

    vad = tvad.OnlineVAD()
    init_weights_(vad, torch.Generator().manual_seed(5))
    vad_margin = synth.calibrate_vad(vad, stream)
    vad_vars = nested(convert.to_flax_names(vad))

    cfg = tpunc.PuncConfig()
    punc = tpunc.PuncTransformer(cfg, len(PuncVocab.tokens),
                                 2 + len(synth.PUNC_TOKENS))
    init_weights_(punc, torch.Generator().manual_seed(4))
    rng = np.random.default_rng(5)
    ids = rng.integers(3, len(PuncVocab.tokens), (8, 64))
    ids[:, 0], ids[:, -1] = 1, 2
    share = synth.calibrate_punc(punc, ids, THRESHOLD)
    punc_vars = nested(convert.to_flax_names(punc))
    assert vad_margin > 1.0 and 0.15 < share < 0.35

    vocab = Vocab(N_CHAR)
    jax_side = dict(
        asr=jeng.ASREngine(jasr_model, asr_vars, chunk_seconds=0.5,
                           sample_rate=SR, text_featurizer=vocab),
        vad=jeng.VADEngine(jvad.OnlineVAD(), vad_vars, frame_input=80),
        punc=jeng.PuncEngine(jpunc.PuncTransformer(
            jpunc.PuncConfig(), len(PuncVocab.tokens),
            2 + len(synth.PUNC_TOKENS)), punc_vars, PuncVocab(),
            synth.PUNC_TOKENS, threshold=THRESHOLD))
    port_side = dict(
        asr=teng.ASREngine(tasr_model, chunk_seconds=0.5, sample_rate=SR,
                           text_featurizer=vocab),
        vad=teng.VADEngine(vad, device="cpu"),
        punc=teng.PuncEngine(punc, PuncVocab(), synth.PUNC_TOKENS,
                             threshold=THRESHOLD, device="cpu"))
    return jax_side, port_side, stream


def check_margins(vad_logits, punc_probs):
    """No VAD logit or punctuation decision near its threshold. A position
    gets punctuation when its top probability, on a class >= 2, is at
    least THRESHOLD > 0.5; so only that probability's distance from the
    threshold decides (a near-tie of two classes can only be below 0.5)."""
    logits = np.concatenate([x.ravel() for x in vad_logits])
    assert np.abs(logits).min() > MARGIN
    for probs in punc_probs:
        assert np.abs(probs[1:-1].max(-1) - THRESHOLD).min() > MARGIN


def test_task_content_event_flow_equals_jax():
    """Two bursts of speech, each then silence: start -> sends -> inter
    break -> end, state for state."""
    packet = int(0.02 * SR)
    stream = synth.tone_bursts(((0.3, False), (2.0, True), (0.3, False),
                              (1.0, True), (2.5, False)), seed=2)
    trace = {}
    for name, mod in (("jax", jvm), ("port", tvm)):
        tc = mod.TaskContent(energy_vad, chunk_max_duration=0.5,
                             sample_rate=SR, wait_sil=3, vad_downsample=2)
        states = []
        for i in range(0, len(stream) - packet, packet):
            tc.parse(stream[i:i + packet])
            states.append((tc.start_event, tc.send_flag, tc.sound_end,
                           tc.sil_times, tc.inter_break, len(tc.chunk),
                           dict(tc.live_result)))
            if tc.start_event:
                tc.start_event = 0
            if tc.send_flag and tc.sound_end:
                tc.reset_live_result()
            elif tc.send_flag:
                tc.send_flag = 0
                tc.chunk_length_check()
        tc.final_parse()
        trace[name] = states
    assert trace["port"] == trace["jax"]
    starts = sum(s[0] for s in trace["port"])
    ends = sum(s[1] and s[2] for s in trace["port"])
    sends = sum(s[1] and not s[2] for s in trace["port"])
    # wait_sil 3: the 0.3 s pause ends the first sentence too
    assert starts == ends == 2 and sends == 6
    assert any(s[4] for s in trace["port"])           # an inter break


def test_offline_segmenter_merge_and_resplit_equals_jax():
    sr8 = 8000
    wav = synth.tone_bursts(((0.5, False), (0.4, True), (0.05, False),
                           (0.4, True), (1.0, False), (2.5, True),
                           (0.5, False), (0.3, True)), seed=3, sr=sr8)
    segs = {}
    for name, mod in (("jax", jvm), ("port", tvm)):
        seg = mod.OfflineVADSegmenter(energy_vad, sample_rate=sr8,
                                      frame_input=80, merge_gap=0.1,
                                      max_segment=1.0)
        segs[name] = seg.segment(wav)
        assert seg.recover([]) == [] and seg.segment(wav[:40]) == []
    assert segs["port"] == segs["jax"]
    got = segs["port"]
    # the 0.05 s gap merged, the 2.5 s burst split in 4, then the last one
    assert len(got) == 6, got
    assert all(e - s <= sr8 for s, e in got)


def run_stream(side, stream, engines, pcm=True):
    vad = Recorder(engines["vad"], "inference")
    probs = Recorder(engines["punc"], "_window_probs")
    session = side(engines["asr"], engines["vad"], punc=engines["punc"],
                   sample_rate=SR)
    packet = int(0.02 * SR)
    events = []
    for i in range(0, len(stream), packet):
        piece = stream[i:i + packet]
        if pcm:
            piece = (np.clip(piece, -1, 1) * 32767).astype("<i2").tobytes()
        ev = session.send(piece)
        if ev:
            events.append(ev)
    final = session.final_send()
    if final:
        events.append(final)
    for ev in events:
        if "task_id" in ev:
            uuid.UUID(ev.pop("task_id"))
    return events, vad.seen, probs.seen


def test_stream_session_equals_jax(models):
    jax_side, port_side, stream = models
    want, jvad_seen, jprobs = run_stream(JStreamASRSession, stream, jax_side)
    got, tvad_seen, _ = run_stream(StreamASRSession, stream, port_side)
    check_margins(jvad_seen, jprobs)
    # one a 0.1 s, or 0.12 where the float sum of 0.02 s falls short
    assert len(tvad_seen) == len(jvad_seen) >= 8 / 0.12
    for a, b in zip(tvad_seen, jvad_seen):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())
    assert got == want
    types = [e["event_type"] for e in got]
    assert types.count("sentence begin") == types.count("sentence end") == 2
    assert types.count("inter break") == 1 and "result change" in types
    texts = [e["best_text"] for e in got if e["event_type"] in
             ("inter break", "sentence end")]
    assert all(texts) and len(set(texts)) == len(texts)
    assert any(p in "".join(texts) for p in synth.PUNC_TOKENS)
    # float packets are the same session (the pcm16 round trip aside)
    floats, _, _ = run_stream(StreamASRSession, stream, port_side, pcm=False)
    assert [e["event_type"] for e in floats] == types


def test_punc_engine_oov_and_windows_equal_jax(models):
    jax_side, port_side, _ = models
    jp, tp = jax_side["punc"], port_side["punc"]
    assert tp.max_len == jp.max_len == 64
    rng = np.random.default_rng(7)
    short = [f"c{i}" for i in rng.integers(0, 15, 12)] + ["9", "Z"]
    long = [f"c{i}" for i in rng.integers(0, 15, 201)]
    probs = Recorder(jp, "_window_probs")
    for chars in (short, long, ["9", "Z"], []):
        got, want = tp.punc_recover(chars), jp.punc_recover(chars)
        assert got == want
        assert [c for c in got if c not in synth.PUNC_TOKENS] == chars
    check_margins([np.ones(1)], probs.seen)
    assert len(probs.seen[1]) == len([c for c in long if c in
                                      PuncVocab.tokens]) + 2
    assert any(c in synth.PUNC_TOKENS for c in tp.punc_recover(long))
    # an OOV char never gets punctuation after it
    out = tp.punc_recover(short)
    for a, b in zip(out, out[1:]):
        if a in ("9", "Z", "c4", "c9", "c14"):
            assert b not in synth.PUNC_TOKENS


def test_offline_session_with_vad_and_punc_equals_jax(models):
    jax_side, port_side, _ = models
    for seconds, seed in ((3.5, 11), (5.0, 12)):
        wav = synth.tone_bursts(synth.file_pattern(seconds), seed=seed)
        want = JOfflineASRSession(jax_side["asr"], jax_side["vad"],
                                  jax_side["punc"]).transcribe_wav(wav)
        session = OfflineASRSession(port_side["asr"], port_side["vad"],
                                    port_side["punc"])
        got = session.transcribe_wav(wav)
        assert got == want
        bursts = sum(loud for _, loud in synth.file_pattern(seconds))
        assert len(got) == bursts and all(s["text"] for s in got)
        assert all(s["end_s"] > s["start_s"] for s in got)
        # each segment starts in a burst, not at 0
        assert got[0]["start_s"] > 0.25
    no_vad = OfflineASRSession(port_side["asr"]).transcribe_wav(wav)
    assert len(no_vad) == 1 and no_vad[0]["start_s"] == 0.0


def test_build_asr_ops_with_vad_engine_equals_jax(models):
    jax_side, port_side, stream = models
    ops = tms.build_asr_ops(port_side["asr"], port_side["vad"])
    jops = jms.build_asr_ops(jax_side["asr"], jax_side["vad"])
    assert sorted(ops) == sorted(jops)
    frames = synth.vad_frames(stream)[:, :300]
    got, want = ops["vad"](frames), np.asarray(jops["vad"](frames))
    assert got.shape == want.shape == (300,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert (got > 0).any() and (got < 0).any()
    # without one, the energy gate as before
    gate = tms.build_asr_ops(port_side["asr"])["vad"](frames)
    np.testing.assert_array_equal(gate, jms.build_asr_ops(
        jax_side["asr"])["vad"](frames))


def vad_configs(tmp_path):
    data = {"speech_config": {"sample_rate": 8000, "frame_input": 80},
            "optimizer_config": {"lr": 1e-4},
            "running_config": {"outdir": str(tmp_path / "vad_logs")}}
    paths = []
    for name, cfg in (("vd.yml", data), ("vm.yml", {"model_config": {
            "name": "CNN_Online_VAD", "dmodel": 32}})):
        (tmp_path / name).write_text(yaml.dump(cfg), encoding="utf-8")
        paths.append(str(tmp_path / name))
    return paths


def test_serve_model_with_vad_configs(models, tmp_path, capsys):
    from tests.test_torch_model_server import write_configs
    from tensorflowasr_tpu_torch.cli import serve_model
    from tensorflowasr_tpu_torch.cli.common import build_vad_model
    from tensorflowasr_tpu_torch.train.checkpoint import CheckpointManager
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    jax_side, port_side, stream = models
    _, _, odp, omp = write_configs(tmp_path)
    vdp, vmp = vad_configs(tmp_path)
    args = serve_model.parser().parse_args(
        ["--data_config", odp, "--model_config", omp, "--device", "cpu",
         "--vad_data_config", vdp, "--vad_model_config", vmp])
    frames = synth.vad_frames(stream)[:, :200]

    # no VAD checkpoint: a warning and the seeded init
    ops = serve_model.build_ops(args)[0]
    assert "no VAD checkpoint found" in capsys.readouterr().err
    seeded = ops["vad"](frames)

    # the calibrated weights saved as the VAD's checkpoint are what it serves
    model, state = build_vad_model(UserConfig(vdp, vmp), "cpu")
    model.load_state_dict(port_side["vad"].model.state_dict())
    CheckpointManager(str(tmp_path / "vad_logs" / "checkpoints")).save(
        7, state)
    ops = serve_model.build_ops(args)[0]
    assert "no VAD checkpoint" not in capsys.readouterr().err
    got = ops["vad"](frames)
    want = jax_side["vad"].inference(frames)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(got - seeded).max() > 1e-3
    # without the VAD configs the vad op is the energy gate
    args.vad_data_config = args.vad_model_config = None
    gate = serve_model.build_ops(args)[0]["vad"](frames)
    np.testing.assert_array_equal(
        gate, jms.build_asr_ops(jax_side["asr"])["vad"](frames))


def test_cli_test_punc_equals_jax(models, tmp_path, capsys):
    import jax.numpy as jnp

    from tensorflowasr_tpu.cli.common import (
        build_punc_model as jbuild_punc_model,
    )
    from tensorflowasr_tpu.cli.test_punc import main as jax_main
    from tensorflowasr_tpu.train.checkpoint import (
        CheckpointManager as JCheckpointManager,
    )
    from tensorflowasr_tpu.utils.config import UserConfig as JConfig
    from tensorflowasr_tpu_torch.cli.common import build_punc_model
    from tensorflowasr_tpu_torch.cli.test_punc import main
    from tensorflowasr_tpu_torch.train.checkpoint import CheckpointManager
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    _, port_side, _ = models
    # single chars with the ids of PuncVocab's tokens: <S> 1, </S> 2, then
    # a..l for c0..c13 without c4 and c9
    letters = "abcdefghijkl"
    (tmp_path / "chars.txt").write_text(
        "\n".join(["<S>", "</S>", *letters]), encoding="utf-8")
    (tmp_path / "puncs.txt").write_text(
        "\n".join(["<S>", "</S>", *synth.PUNC_TOKENS]), encoding="utf-8")
    (tmp_path / "punc.list").write_text("c0c1，c2。\n", encoding="utf-8")
    cfgs = {}
    for name in ("jax", "port"):
        cfg = {
            "punc_vocab": {"vocabulary": str(tmp_path / "chars.txt"),
                           "blank_at_zero": True},
            "punc_biaodian": {"vocabulary": str(tmp_path / "puncs.txt"),
                              "blank_at_zero": True},
            "optimizer_config": {"lr": 1e-4},
            "running_config": {"train_list": str(tmp_path / "punc.list"),
                               "eval_list": str(tmp_path / "punc.list"),
                               "batch_size": 2,
                               "outdir": str(tmp_path / f"{name}_logs")},
            "model_config": {"name": "PuncTransformer", "num_layers": 3,
                             "d_model": 64, "enc_embedding_dim": 64,
                             "num_heads": 8, "dff": 64, "pe_input": 1024,
                             "rate": 0.1}}
        path = tmp_path / f"{name}.yml"
        path.write_text(yaml.dump(cfg), encoding="utf-8")
        cfgs[name] = str(path)

    # the calibrated weights as each package's checkpoint
    _, _, model, state = build_punc_model(
        UserConfig(cfgs["port"], cfgs["port"]), "cpu")
    model.load_state_dict(port_side["punc"].model.state_dict())
    CheckpointManager(str(tmp_path / "port_logs" / "checkpoints")).save(
        3, state)
    _, _, _, jstate = jbuild_punc_model(JConfig(cfgs["jax"], cfgs["jax"]))
    params = jax.tree.map(jnp.asarray, nested(convert.to_flax_names(
        model))["params"])
    JCheckpointManager(str(tmp_path / "jax_logs" / "checkpoints")).save(
        3, jstate.replace(params=params))

    rng = np.random.default_rng(9)
    lines = ["".join(rng.choice(list(letters + "9Z"), n))
             for n in (6, 30, 90)]
    printed = {}
    for name, fn in (("port", main), ("jax", jax_main)):
        outs = []
        for text in lines:
            argv = ["--data_config", cfgs[name], "--model_config",
                    cfgs[name], "--text", text, "--threshold",
                    str(THRESHOLD)]
            assert fn(argv + (["--device", "cpu"] if name == "port"
                              else [])) == 0
            captured = capsys.readouterr()
            assert "random init" not in captured.err
            outs.append(captured.out)
        printed[name] = outs
    assert printed["port"] == printed["jax"]
    joined = "".join(printed["port"])
    assert any(p in joined for p in synth.PUNC_TOKENS)
    for text, out in zip(lines, printed["port"]):
        assert "".join(c for c in out.strip()
                       if c not in synth.PUNC_TOKENS) == text



