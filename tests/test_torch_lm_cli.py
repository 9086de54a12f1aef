"""The port's LM and corpus tools and its beam decoding entry points against
the JAX package's, on the same files and weights:

- ``cli.train_lm`` (``.npz`` arrays element for element, ``--arpa_out`` byte
  for byte, the perplexities it prints);
- ``cli.eval_am --lm`` and ``--word_lm``: the same JSON as JAX's ``eval_am``
  on the same checkpoint; on a ``ChunkConformer`` config the flags are
  ignored and the decode stays greedy, as in JAX's CLI;
- ``ASREngine(beam_width=8, ngram_lm=...)`` against JAX's engine: the same
  chars and phones, on decodes that vary;
- ``cli.serve_model.build_ops --lm``: the served ops, decoded with the beam
  on the host, against the in-process beam engine;
- ``cli.build_vocab`` and ``cli.make_pinyin_map``: the same bytes;
- ``utils/phones.py`` over the full syllable table.

Everything is compared for equality: ids, JSON, bytes and tables."""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from tensorflowasr_tpu.serve.engines import ASREngine as JASREngine
from tensorflowasr_tpu.serve.offline_session import (
    OfflineASRSession as JOfflineASRSession,
)
from tensorflowasr_tpu.utils import ngram_lm as jlm
from tensorflowasr_tpu.utils.config import UserConfig as JConfig
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.serve import engines
from tensorflowasr_tpu_torch.serve.engines import ASREngine
from tensorflowasr_tpu_torch.serve.offline_session import OfflineASRSession
from tensorflowasr_tpu_torch.utils import ngram_lm as tlm
from tests.test_torch_serve import TINY, SR, Vocab, pair, speech
from tests.test_torch_serve import randomize as fan_in_randomize
from tests.test_torch_train import configs  # noqa: F401 - a fixture
from tests.test_torch_train import save_as_jax_checkpoint

torch.set_num_threads(2)

WORD_ARPA = """\\data\\
ngram 1=5
ngram 2=4

\\1-grams:
-0.6\tni3\t-0.3
-0.6\thao3\t-0.3
-0.7\tshi4\t-0.3
-0.7\tjie4\t-0.3
-99\t<s>\t-0.3

\\2-grams:
-0.1\tni3 hao3
-0.2\tshi4 jie4
-0.4\tni3 shi4
-0.5\thao3 jie4

\\end\\
"""


def jax_host_lm(lm):
    """The port's host LM as the JAX package's ``NGramLM``."""
    return jlm.NGramLM(**{f: getattr(lm, f) for f in (
        "order", "vocab_size", "uni_logp", "key1", "key2", "val",
        "n_probe")})


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# cli.train_lm
# ---------------------------------------------------------------------------

def test_train_lm_cli_matches_jax(configs, capsys):  # noqa: F811
    from tensorflowasr_tpu.cli.train_lm import main as jmain
    from tensorflowasr_tpu_torch.cli.train_lm import main as tmain

    tmp_path, data_yml, model_yml, _ = configs
    lists = str(tmp_path / "train.list")
    outs = {}
    for name, main in (("jax", jmain), ("port", tmain)):
        npz, arpa = tmp_path / f"{name}.npz", tmp_path / f"{name}.arpa"
        assert main(["--data_config", data_yml, "--model_config", model_yml,
                     "--unit", "phone", "--order", "3", "--output", str(npz),
                     "--arpa_out", str(arpa), "--eval_lists", lists]) == 0
        trained = capsys.readouterr().out
        # the ARPA text back through --lm, evaluated only
        assert main(["--data_config", data_yml, "--unit", "phone", "--lm",
                     str(arpa), "--eval_lists", lists]) == 0
        trained = trained.replace(str(npz), "NPZ").replace(str(arpa), "ARPA")
        outs[name] = (npz, arpa, trained, capsys.readouterr().out)
    (jnpz, jarpa, jtrained, jeval), (tnpz, tarpa, ttrained, teval) = \
        outs["jax"], outs["port"]
    assert tarpa.read_bytes() == jarpa.read_bytes()
    assert ttrained == jtrained and teval == jeval
    assert "train ppl" in ttrained and "held-out perplexity" in teval
    with np.load(jnpz) as j, np.load(tnpz) as t:
        assert sorted(t.files) == sorted(j.files)
        for key in j.files:
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    lm = tlm.NGramLM.load(str(tnpz))
    assert lm.order == 3 and lm.vocab_size == 9      # 8 phones + blank


def test_train_lm_takes_no_device_flag(configs):  # noqa: F811
    from tensorflowasr_tpu_torch.cli.train_lm import main

    _, data_yml, _, _ = configs
    with pytest.raises(SystemExit):
        main(["--data_config", data_yml, "--device", "cpu"])


# ---------------------------------------------------------------------------
# cli.eval_am --lm / --word_lm
# ---------------------------------------------------------------------------

def unflatten(flat):
    nested = {}
    for name, arr in flat.items():
        node = nested
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(arr)
    return nested


@pytest.fixture()
def beam_checkpoints(configs):  # noqa: F811
    """Fan-in scaled random weights (decodes that are not all blank),
    saved as the port's checkpoint and, for a copy of the model config
    with its own outdir, as the JAX package's; and an order-3 phone LM
    trained by ``cli.train_lm`` on the corpus, and a word ARPA over its
    pinyin syllables."""
    from tensorflowasr_tpu.train import asr_trainer as jtrain
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.cli.train_lm import main as train_lm
    from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    tmp_path, data_yml, model_yml, model_cfg = configs
    config = UserConfig(data_yml, model_yml)
    phone_f, char_f = build_featurizers(config)[:2]
    trainer = CTCTrainer(config, phone_f.num_classes, char_f.num_classes,
                         phone_f.blank, device="cpu")
    trainer.init_state()
    model = trainer.state.model
    variables = fan_in_randomize(unflatten(convert.to_flax_names(model)), 5)
    model.load_state_dict(convert.convert_flax_variables(variables,
                                                         trainer.model_cfg))
    trainer.state.step = 1
    trainer.save()

    jax_model_yml = tmp_path / "jm.yml"
    jax_model_yml.write_text(yaml.dump({**model_cfg, "running_config": {
        "batch_size": 2, "outdir": str(tmp_path / "jax_logs")}}))
    jtrainer = jtrain.CTCTrainer(JConfig(data_yml, str(jax_model_yml)),
                                 phone_f.num_classes, char_f.num_classes,
                                 blank_id=phone_f.blank)
    jtrainer.init_state({"wav": np.zeros((1, 3200), np.float32),
                         "phones": np.ones((1, 4), np.int32)})
    save_as_jax_checkpoint(jtrainer, model, 1)

    lm = tmp_path / "lm.npz"
    assert train_lm(["--data_config", data_yml, "--order", "3",
                     "--output", str(lm)]) == 0
    words = tmp_path / "words.arpa"
    words.write_text(WORD_ARPA, encoding="utf-8")
    return data_yml, model_yml, str(jax_model_yml), str(lm), str(words)


def test_a_card_checkpoint_restores_on_the_cpu(beam_checkpoints, capsys):
    """``eval_am --device cpu`` on a checkpoint written on the card: the
    card's generator state (Philox, 16 bytes) does not fit the CPU's
    generator, so the restore keeps the seeded one and loads the rest."""
    from tensorflowasr_tpu_torch.cli.eval_am import main as teval
    from tensorflowasr_tpu_torch.train.checkpoint import CheckpointManager

    data_yml, model_yml, _, lm, _ = beam_checkpoints
    ckpt_dir = os.path.join(os.path.dirname(data_yml), "logs", "checkpoints")
    manager = CheckpointManager(ckpt_dir)
    path = manager._path(1)
    saved = torch.load(path, weights_only=True)
    common = ["--data_config", data_yml, "--model_config", model_yml,
              "--device", "cpu", "--lm", lm, "--max_batches", "1"]
    assert teval(common) == 0
    want = last_json(capsys.readouterr().out)
    saved["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(saved, path)
    assert teval(common) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    assert last_json(captured.out) == want


@pytest.mark.parametrize("flag", ["--lm", "--word_lm"])
def test_eval_am_lm_matches_jax(beam_checkpoints, capsys, flag):
    from tensorflowasr_tpu.cli.eval_am import main as jeval
    from tensorflowasr_tpu_torch.cli.eval_am import main as teval

    data_yml, model_yml, jax_model_yml, lm, words = beam_checkpoints
    extra = [flag, lm if flag == "--lm" else words, "--lm_weight", "0.5",
             "--beam_width", "6", "--max_batches", "2"]
    capsys.readouterr()
    assert teval(["--data_config", data_yml, "--model_config", model_yml,
                  "--device", "cpu"] + extra) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    got = last_json(captured.out)
    assert jeval(["--data_config", data_yml, "--model_config",
                  jax_model_yml] + extra) == 0
    captured = capsys.readouterr()
    assert "no checkpoint found" not in captured.err
    assert got == last_json(captured.out)
    # hypotheses that are not empty: fewer deletions than reference phones
    assert got["phone_N"] == 16 and got["phone_D"] < 16


def test_eval_am_lm_on_a_chunk_config_decodes_greedily(configs, capsys):  # noqa: F811,E501
    """JAX's chunk branch never reads the LM flags: an LM path that does not
    exist is not even opened, and the JSON is the greedy one."""
    from tensorflowasr_tpu_torch.cli.eval_am import main as teval

    tmp_path, data_yml, _, _ = configs
    stack = dict(dmodel=16, head_size=8, num_heads=2, kernel_size=4,
                 fc_factor=0.5, dropout=0.0, win_front=6)
    chunk_yml = tmp_path / "chunk.yml"
    chunk_yml.write_text(yaml.dump({"model_config": {
        "name": "ChunkConformer",
        "ChunkConformerFront": {"dmodel": 16, "reduction_factor": 4,
                                "sample_rate": SR, "n_mels": 20,
                                "stride_ms": 10, "chunk_num": 16},
        "ChunkConformerEncoder": {**stack, "num_blocks": 1, "win_back": 0},
        "ChunkCTCPicker": {**stack, "num_blocks": 1, "win_back": 0},
        "ChunkCTCDecoder": {**stack, "num_blocks": 1, "win_back": 2},
        "ContextHelper": {**stack, "num_blocks": 1, "win_back": 0},
    }}))
    common = ["--data_config", data_yml, "--model_config", str(chunk_yml),
              "--device", "cpu", "--max_batches", "2"]
    assert teval(common) == 0
    greedy = last_json(capsys.readouterr().out)
    assert teval(common + ["--lm", str(tmp_path / "none.npz"),
                           "--word_lm", str(tmp_path / "none.arpa")]) == 0
    assert last_json(capsys.readouterr().out) == greedy


# ---------------------------------------------------------------------------
# ASREngine with the beam, and serve_model --lm
# ---------------------------------------------------------------------------

def phone_lm(n_phone, seed=3, order=3):
    rng = np.random.default_rng(seed)
    seqs = [[int(t) for t in rng.integers(0, n_phone - 1, size=10)]
            for _ in range(150)]
    return tlm.train_ngram_lm(seqs, n_phone, order=order)


def test_beam_engine_matches_jax():
    n_phone, n_char = 11, 17
    jmodel, variables, tmodel = pair(n_phone, n_char, seed=5)
    vocab = Vocab(n_char)
    lm = phone_lm(n_phone)
    jeng = JASREngine(jmodel, variables, chunk_seconds=0.5, sample_rate=SR,
                      text_featurizer=vocab, beam_width=8,
                      ngram_lm=jlm.lm_pack(jax_host_lm(lm)), lm_weight=0.4)
    teng = ASREngine(tmodel, chunk_seconds=0.5, sample_rate=SR,
                     text_featurizer=vocab, beam_width=8,
                     ngram_lm=tlm.lm_pack(lm, "cpu"), lm_weight=0.4)
    greedy = ASREngine(tmodel, chunk_seconds=0.5, sample_rate=SR,
                       text_featurizer=vocab)
    wav = speech(2.3, seed=5)
    encs = [jeng.extract_feature(wav[i:i + 7680])
            for i in range(0, len(wav), 7680)]
    got_phones = teng.decode_phones(encs)
    assert got_phones == jeng.decode_phones(encs)
    assert teng.decode(encs) == jeng.decode(encs)
    # the decodes vary, and the LM moves the beam off the greedy path
    assert len(set(got_phones)) > 2
    assert got_phones != greedy.decode_phones(encs)
    got = OfflineASRSession(teng).transcribe_wav(wav)
    assert got == JOfflineASRSession(jeng).transcribe_wav(wav)
    assert got[0]["text"]


def served_beam_decode(ops, wav, host_lm, lm_weight, vocab):
    """What a client does for one file over the served offline ops, with the
    beam on the host: ``encode`` a chunk at a time, the rows padded to whole
    groups of 4 chunks (as ``ASREngine.decode`` pads them), ``ctc_logits``,
    the beam with the LM, the best beam padded with 10 zeros,
    ``translate``; returns (phone ids, chars)."""
    from tensorflowasr_tpu_torch.ops.beam import ctc_beam_search_decode

    cs = int(ops["info"]()[0])
    encs = [ops["encode"](wav[None, i:i + cs]) for i in range(0, len(wav), cs)]
    frames, enc = encs[0].shape[0], np.concatenate(encs)
    groups = -(-(-(-len(enc) // frames)) // 4) * 4
    buf = np.zeros((groups * frames, enc.shape[1]), np.float32)
    buf[:len(enc)] = enc
    logits = torch.from_numpy(ops["ctc_logits"](buf))[None]
    prefixes, lens, _ = ctc_beam_search_decode(
        logits, torch.tensor([len(enc)]), blank_id=logits.shape[-1] - 1,
        beam_width=8, prune_k=min(16, logits.shape[-1]),
        ngram_lm=tlm.lm_pack(host_lm, "cpu"), lm_weight=lm_weight)
    phones = prefixes[0, 0, :int(lens[0, 0])].tolist()
    padded = np.zeros((1, len(buf) + 10), np.int32)
    padded[0, :len(phones)] = phones
    chars = []
    for v in ops["translate"](padded, buf).argmax(-1):
        if v == 0 or v == vocab.endid():
            break
        chars.append(vocab.iextract(int(v)))
    return phones, chars


def test_serve_model_build_ops_with_lm_matches_the_engine(tmp_path):
    from tensorflowasr_tpu_torch.cli.common import build_featurizers
    from tensorflowasr_tpu_torch.cli.serve_model import build_ops, parser
    from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    (tmp_path / "phones.txt").write_text(
        "\n".join(f"p{i}" for i in range(10)), encoding="utf-8")
    (tmp_path / "chars.txt").write_text(
        "\n".join(["<S>", "</S>"] + [f"c{i}" for i in range(14)]),
        encoding="utf-8")
    data_yml, model_yml = tmp_path / "data.yml", tmp_path / "model.yml"
    data_yml.write_text(yaml.dump({
        "speech_config": {"sample_rate": SR, "stride_ms": 10,
                          "reduction_factor": 4},
        "inp_config": {"vocabulary": str(tmp_path / "phones.txt"),
                       "blank_at_zero": False},
        "tar_config": {"vocabulary": str(tmp_path / "chars.txt"),
                       "blank_at_zero": False},
        "running_config": {"outdir": str(tmp_path / "logs")}}))
    model_yml.write_text(yaml.dump({"model_config": dict(
        name="OfflineConformerCTC", **TINY)}))
    config = UserConfig(str(data_yml), str(model_yml))
    phone_f, char_f = build_featurizers(config)[:2]
    assert (phone_f.num_classes, char_f.num_classes) == (11, 17)
    # the engine test's weights, as this config's checkpoint
    _, _, tmodel = pair(11, 17, seed=5)
    trainer = CTCTrainer(config, 11, 17, phone_f.blank, device="cpu")
    trainer.init_state()
    trainer.state.model.load_state_dict(tmodel.state_dict())
    trainer.save()
    lm = phone_lm(11)
    lm_path = str(tmp_path / "lm.npz")
    lm.save(lm_path)

    args = parser().parse_args([
        "--data_config", str(data_yml), "--model_config", str(model_yml),
        "--device", "cpu", "--compute_dtype", "float32", "--lm", lm_path,
        "--lm_weight", "0.4"])
    ops, inline_ops, front = build_ops(args)
    assert front is None and not inline_ops
    wav = speech(2.3, seed=5)
    phones, chars = served_beam_decode(ops, wav, lm, 0.4, Vocab(17))

    # the char read-out of Vocab: the translator's argmax may be the char
    # blank, which has no token in the vocabulary file
    engine = ASREngine(tmodel, sample_rate=SR, text_featurizer=Vocab(17),
                       phone_featurizer=phone_f, beam_width=8,
                       ngram_lm=tlm.lm_pack(lm, "cpu"), lm_weight=0.4)
    encs = [engine.extract_feature(wav[i:i + 7680])
            for i in range(0, len(wav), 7680)]
    assert chars == engine.decode(encs) and chars
    ids, lens, _ = engine._decode(encs, engine.pad_chunks)
    assert phones == ids[0, :lens[0]].tolist()
    assert len(set(phones)) > 2


def test_serve_model_arpa_lm_implies_a_beam(tmp_path, monkeypatch):
    """``--lm x.arpa`` reads the ARPA over the phone vocabulary and sets
    ``--beam_width 8``: the engine's decode is the beam's."""
    from tensorflowasr_tpu_torch.cli import serve_model

    (tmp_path / "phones.txt").write_text(
        "\n".join(f"p{i}" for i in range(10)), encoding="utf-8")
    (tmp_path / "chars.txt").write_text(
        "\n".join(["<S>", "</S>"] + [f"c{i}" for i in range(14)]),
        encoding="utf-8")
    data_yml, model_yml = tmp_path / "data.yml", tmp_path / "model.yml"
    data_yml.write_text(yaml.dump({
        "speech_config": {"sample_rate": SR, "stride_ms": 10,
                          "reduction_factor": 4},
        "inp_config": {"vocabulary": str(tmp_path / "phones.txt"),
                       "blank_at_zero": False},
        "tar_config": {"vocabulary": str(tmp_path / "chars.txt"),
                       "blank_at_zero": False}}))
    model_yml.write_text(yaml.dump({"model_config": dict(
        name="OfflineConformerCTC", **TINY)}))
    lm = phone_lm(11, seed=9, order=2)
    arpa = str(tmp_path / "lm.arpa")
    lm.to_arpa(arpa, [f"p{i}" for i in range(10)] + ["<blank>"])
    built = []

    class Spy(engines.ASREngine):
        def __init__(self, *a, **kw):
            built.append(kw)
            super().__init__(*a, **kw)

    monkeypatch.setattr(engines, "ASREngine", Spy)
    args = serve_model.parser().parse_args([
        "--data_config", str(data_yml), "--model_config", str(model_yml),
        "--device", "cpu", "--lm", arpa])
    serve_model.build_ops(args)
    assert built[0]["beam_width"] == 8
    dev = built[0]["ngram_lm"]
    want = tlm.NGramLM.from_arpa(arpa, {f"p{i}": i for i in range(10)}, 11)
    assert dev.order == 2
    np.testing.assert_array_equal(dev.val.numpy(), want.val)


# ---------------------------------------------------------------------------
# corpus tools
# ---------------------------------------------------------------------------

def test_build_vocab_cli_byte_identical(configs):  # noqa: F811
    from tensorflowasr_tpu.cli.build_vocab import main as jmain
    from tensorflowasr_tpu_torch.cli.build_vocab import main as tmain

    tmp_path, _, _, _ = configs
    lists = tmp_path / "more.list"
    lists.write_text("a.wav\tni3 hao3 hao3\nb.wav\tshi4 jie4 ni3\n"
                     "c.wav\tzhong1 guo2 ni3\n", encoding="utf-8")
    kept = []
    for extra in ([], ["--min_count", "2"]):
        out = {}
        for name, main in (("jax", jmain), ("port", tmain)):
            ph, ch = tmp_path / f"{name}_p.txt", tmp_path / f"{name}_c.txt"
            assert main(["--lists", str(tmp_path / "train.list"), str(lists),
                         "--phone_out", str(ph), "--char_out", str(ch),
                         "--pinyin_map", str(tmp_path / "p2p.map"),
                         "--transcripts_are_pinyin"] + extra) == 0
            out[name] = (ph.read_bytes(), ch.read_bytes())
        assert out["port"] == out["jax"]
        kept.append(b"zhong1" in out["port"][1])
    assert kept == [True, False]


@pytest.mark.parametrize("restrict", [False, True])
def test_make_pinyin_map_cli_byte_identical(configs, restrict):  # noqa: F811
    from tensorflowasr_tpu.cli.make_pinyin_map import main as jmain
    from tensorflowasr_tpu_torch.cli.make_pinyin_map import main as tmain

    tmp_path, _, _, _ = configs
    lists = tmp_path / "pinyin.list"
    lists.write_text("a.wav\tzhong1 guo2 ren2 yu3 nve4 er5 a\n"
                     "b.wav\tlv3 xing2 qq\n", encoding="utf-8")
    extra = (["--lists", str(lists), "--transcripts_are_pinyin",
              "--no_letters"] if restrict else [])
    out = {}
    for name, main in (("jax", jmain), ("port", tmain)):
        m, p = tmp_path / f"{name}.map", tmp_path / f"{name}_phones.txt"
        assert main(["--map_out", str(m), "--phone_out", str(p)]
                    + extra) == 0
        out[name] = (m.read_bytes(), p.read_bytes())
    assert out["port"] == out["jax"]
    assert len(out["port"][0].splitlines()) > (5 if restrict else 1000)


def test_phones_match_jax_on_the_full_syllable_table():
    from tensorflowasr_tpu.utils import phones as jph
    from tensorflowasr_tpu_torch.utils import phones as tph

    table = tph.full_syllable_table()
    assert table == jph.full_syllable_table() and len(table) > 400
    mapping = tph.build_pinyin2phone()
    assert mapping == jph.build_pinyin2phone()
    assert tph.phone_inventory(mapping) == jph.phone_inventory(mapping)
    for base in table + ["ng", "n", "nue", "lue"]:
        for tone in ("", "1", "3", "5"):
            assert tph.split_pinyin(base + tone) == \
                jph.split_pinyin(base + tone)
    for bad in ("", "xyz", "bx1", "a6", "ni3x", "vv"):
        with pytest.raises(ValueError):
            jph.split_pinyin(bad)
        with pytest.raises(ValueError):
            tph.split_pinyin(bad)

