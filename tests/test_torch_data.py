"""The port's host-side copies (dataloader, augmenters, prefetcher, text and
audio helpers, error-rate metrics) and its weight export against the JAX
package's originals: the same seed and corpus give the same batches."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tensorflowasr_tpu.data import am_dataloader as jdl
from tensorflowasr_tpu.data import augment as jaug
from tensorflowasr_tpu.models import conformer as jconf
from tensorflowasr_tpu.utils import audio as jaudio
from tensorflowasr_tpu.utils import metrics as jmetrics
from tensorflowasr_tpu.utils import text as jtext
from tensorflowasr_tpu_torch.data import am_dataloader as tdl
from tensorflowasr_tpu_torch.data import augment as taug
from tensorflowasr_tpu_torch.data.prefetch import (
    PrefetchIterator,
    parallel_map,
)
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.utils import audio as taudio
from tensorflowasr_tpu_torch.utils import metrics as tmetrics
from tensorflowasr_tpu_torch.utils import text as ttext
from tensorflowasr_tpu_torch.utils.telemetry import ThroughputMeter

SR = 16000
SYLLABLES = {"ni3": "n i3", "hao3": "h ao3", "shi4": "sh i4", "jie4": "j ie4"}


@pytest.fixture()
def corpus(tmp_path):
    """20 utterances of 0.5 - 3.4 s (three duration buckets), one too long,
    one too short, one with an out-of-vocabulary syllable."""
    rng = np.random.default_rng(0)
    names = list(SYLLABLES)
    lines = []
    for i in range(20):
        seconds = 0.5 + 0.15 * i
        t = np.arange(int(seconds * SR)) / SR
        wav = 0.4 * np.sin(2 * np.pi * (150 + 30 * i) * t) \
            + 0.05 * rng.standard_normal(len(t))
        path = tmp_path / f"u{i}.wav"
        taudio.write_wav(str(path), wav.astype(np.float32), SR)
        text = " ".join(rng.choice(names, size=1 + i % 4))
        lines.append(f"{path}\t{text}")
    taudio.write_wav(str(tmp_path / "long.wav"),
                     np.zeros(5 * SR, np.float32), SR)
    taudio.write_wav(str(tmp_path / "short.wav"),
                     np.zeros(300, np.float32), SR)
    lines.insert(3, f"{tmp_path / 'long.wav'}\tni3")
    lines.insert(7, f"{tmp_path / 'short.wav'}\tni3")
    lines.insert(11, f"{tmp_path / 'u0.wav'}\tni3 wo3")
    lines.insert(13, f"{tmp_path / 'missing.wav'}\tni3")
    (tmp_path / "train.list").write_text("\n".join(lines), encoding="utf-8")
    phones = sorted({p for v in SYLLABLES.values() for p in v.split()})
    (tmp_path / "phones.txt").write_text("\n".join(phones), encoding="utf-8")
    (tmp_path / "chars.txt").write_text(
        "\n".join(["<S>", "</S>"] + names), encoding="utf-8")
    (tmp_path / "p2p.map").write_text(
        "".join(f"{k}\t{v}\n" for k, v in SYLLABLES.items()),
        encoding="utf-8")
    return tmp_path


def loader_config(root, **speech):
    return {
        "speech_config": {
            "sample_rate": SR, "stride_ms": 10, "reduction_factor": 4,
            "wav_max_duration": 4, "bucket_seconds": [1.0, 2.0, 4.0],
            "train_list": str(root / "train.list"),
            "eval_list": str(root / "train.list"), **speech},
        "running_config": {"batch_size": 4},
        "augments_config": None,
    }


def both_loaders(root, seed=3, **speech):
    cfg = loader_config(root, **speech)
    out = []
    for dl, text in ((jdl, jtext), (tdl, ttext)):
        phone_f = text.TextFeaturizer({"vocabulary": str(root / "phones.txt")})
        char_f = text.TextFeaturizer({"vocabulary": str(root / "chars.txt")})
        out.append(dl.AMDataLoader(
            cfg, phone_f, char_f,
            pinyin2phone=text.load_pinyin2phone(str(root / "p2p.map")),
            transcripts_are_pinyin=True, seed=seed))
    return out


@pytest.mark.parametrize("streaming", [False, True],
                         ids=["offline", "streaming"])
def test_am_dataloader_batches_equal_the_jax_loaders(corpus, streaming):
    """Augmenters off. Twelve train batches cross two epoch boundaries (the
    shuffle draws from the seeded generator) and exercise the bucket choice
    and the carry-over queue; then the eval split."""
    want_dl, got_dl = both_loaders(corpus, streaming=streaming)
    assert [repr(b) for b in got_dl.buckets] == \
        [repr(b) for b in want_dl.buckets]
    shapes = set()
    for train, n in ((True, 12), (False, 6)):
        for _ in range(n):
            want, got = want_dl.generate(train), got_dl.generate(train)
            assert list(got) == ["wav", "input_length", "phones",
                                 "phone_length", "chars", "char_length"]
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            shapes.add(got["wav"].shape)
    assert got_dl.epochs == want_dl.epochs >= 2
    assert len(shapes) >= 2 and all(s[0] == 4 for s in shapes)


def test_am_dataloader_generator_prefetches_the_same_batches(corpus):
    _, plain = both_loaders(corpus)
    _, ahead = both_loaders(corpus)
    it = ahead.generator(train=False, num_workers=2, prefetch_depth=2)
    try:
        for _ in range(4):
            want, got = plain.generate(train=False), next(it)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        it.close()
    assert all(not t.is_alive() for t in it._threads)


def test_bucket_spec_matches_jax():
    for args in ((4.0, SR, 160, 4, 12.0, 10.0, 0), (0.3, SR, 160, 4, 12.0,
                                                    10.0, 0),
                 (7.3, SR, 160, 4, 9.5, 3.0, 7680)):
        want, got = jdl.BucketSpec(*args), tdl.BucketSpec(*args)
        assert (got.wav_cap, got.phone_cap, got.char_cap) == \
            (want.wav_cap, want.phone_cap, want.char_cap)


AUGMENTERS = [
    ("masking", {}), ("pitch", {}), ("speed", {}), ("hz", {}), ("rir", {}),
    ("spec_aug", {}), ("noise", None),
]


@pytest.mark.parametrize("name,kwargs", AUGMENTERS,
                         ids=[a[0] for a in AUGMENTERS])
def test_augmenters_equal_the_jax_packages(name, kwargs, tmp_path):
    """The JAX package draws from the ``random`` / ``numpy.random`` module
    generators, the port from generators of its own made from ``seed``: the
    same number gives the same waveform, sample for sample, and the port
    leaves the module generators where they were."""
    if kwargs is None:
        taudio.write_wav(str(tmp_path / "n.wav"), np.random.default_rng(1)
                         .standard_normal(SR).astype(np.float32) * 0.1, SR)
        (tmp_path / "noises.list").write_text(str(tmp_path / "n.wav"))
        kwargs = {"noises": str(tmp_path / "noises.list")}
    if name == "rir":
        kwargs = {"sample_rate": SR}
    t = np.arange(SR // 2) / SR
    wav = (0.4 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
    outs = []
    config = {name: {"active": True, **kwargs}, "aug_ratio": 0.3}
    random.seed(5)
    np.random.seed(5)
    outs.append(jaug.Augmentation(config).process(wav))
    random.seed(77)
    np.random.seed(77)
    state = random.getstate(), np.random.get_state()[1].copy()
    aug = taug.Augmentation(config, seed=5)
    assert aug.available()
    outs.append(aug.process(wav))
    assert random.getstate() == state[0]
    np.testing.assert_array_equal(np.random.get_state()[1], state[1])
    np.testing.assert_array_equal(outs[1], outs[0])
    assert outs[1].dtype == np.float32 and np.abs(outs[1]).max() <= 1.0


def test_augmentation_registry_errors():
    assert not taug.Augmentation(None).available()
    assert not taug.Augmentation({"hz": {"active": False}}).available()
    with pytest.raises(KeyError, match="No augmentation named"):
        taug.Augmentation({"reverb9": {"active": True}})
    with pytest.raises(NotImplementedError, match="not ported"):
        taug.Augmentation({"vc": {"active": True, "model_path": "m.onnx"}})


def test_prefetch_iterator_forwards_errors_and_stops():
    calls = []

    def producer():
        calls.append(1)
        if len(calls) > 3:
            raise ValueError("boom")
        return len(calls)

    it = PrefetchIterator(producer, depth=2, num_workers=1)
    got = [next(it) for _ in range(3)]
    assert got == [1, 2, 3]
    with pytest.raises(ValueError, match="boom"):
        next(it)
    it.close()
    assert all(not t.is_alive() for t in it._threads)
    assert parallel_map(lambda x: x * x, list(range(9)), num_workers=3) == \
        [x * x for x in range(9)]


def test_audio_helpers_match_jax(tmp_path):
    wav = (np.random.default_rng(0).standard_normal(8000) * 0.3).astype(
        np.float32)
    taudio.write_wav(str(tmp_path / "t.wav"), wav, 8000)
    jaudio.write_wav(str(tmp_path / "j.wav"), wav, 8000)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    for target in (None, SR):
        got, sr_got = taudio.read_wav(str(tmp_path / "t.wav"), target)
        want, sr_want = jaudio.read_wav(str(tmp_path / "t.wav"), target)
        assert sr_got == sr_want
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(taudio.resample(wav, 8000, 22050),
                                  jaudio.resample(wav, 8000, 22050))
    sc = {"sample_rate": SR, "stride_ms": 10, "reduction_factor": 4}
    np.testing.assert_array_equal(
        taudio.SpeechFeaturizer(sc).pad_signal(wav),
        jaudio.SpeechFeaturizer(sc).pad_signal(wav))


def test_text_helpers_match_jax(corpus):
    cfg = {"vocabulary": str(corpus / "chars.txt"), "blank_at_zero": False}
    want, got = jtext.TextFeaturizer(cfg), ttext.TextFeaturizer(cfg)
    assert (got.startid(), got.endid(), got.blank, got.num_classes) == \
        (want.startid(), want.endid(), want.blank, want.num_classes)
    assert got.extract(["ni3", "jie4"]) == want.extract(["ni3", "jie4"])
    assert got.has("ni3") and not got.has("wo3")
    p2p_t = ttext.load_pinyin2phone(str(corpus / "p2p.map"))
    assert p2p_t == jtext.load_pinyin2phone(str(corpus / "p2p.map"))
    p2p_t["ma5"] = ["m", "a5"]
    phone_f = ttext.TextFeaturizer({"vocabulary": str(corpus / "phones.txt")})
    for pins in (["ni3", "hao3"], ["ma"], ["sh"], ["xyz"]):
        assert ttext.tokens_to_phones(pins, p2p_t, phone_f) == \
            jtext.tokens_to_phones(pins, p2p_t, phone_f)
    assert ttext.only_chinese("你好, world 世界!") == "你好世界"
    (corpus / "lex.tsv").write_text("你\tni3\n好\thao3\n", encoding="utf-8")
    for mod in (jtext, ttext):
        conv = mod.PinyinConverter(lexicon_path=str(corpus / "lex.tsv"))
        assert conv.available
    assert ttext.PinyinConverter.from_pinyin_text("ni3 hao3") == \
        ["ni3", "hao3"]


tokens = st.lists(st.integers(0, 4), max_size=12)


@settings(max_examples=150, deadline=None, database=None)
@given(ref=tokens, hyp=tokens)
def test_levenshtein_matches_jax_package(ref, hyp):
    got = tmetrics.levenshtein(ref, hyp)
    assert got == jmetrics.levenshtein(ref, hyp)
    s, d, i = got
    assert len(ref) - d + i == len(hyp)              # the counts add up
    assert tmetrics.cer(ref, hyp) == jmetrics.cer(ref, hyp)
    if ref == hyp:
        assert got == (0, 0, 0)


@settings(max_examples=40, deadline=None, database=None)
@given(pairs=st.lists(st.tuples(tokens, tokens), min_size=1, max_size=6))
def test_error_rate_accumulator_matches_jax_package(pairs):
    want, got = (m.ErrorRateAccumulator("cer") for m in (jmetrics, tmetrics))
    for ref, hyp in pairs:
        want.update(ref, hyp)
    got.update_batch(*zip(*pairs))
    assert got.result() == want.result()
    got.reset()
    assert got.result()["N"] == 0 and got.cer == 0.0


def test_throughput_meter_counts():
    meter = ThroughputMeter(window=3)
    assert meter.rates()["steps_per_s"] == 0.0
    for _ in range(5):
        meter.update(4, 32.0)
    rates, summary = meter.rates(), meter.summary()
    assert rates["steps_per_s"] > 0
    assert rates["audio_seconds_per_s"] == pytest.approx(
        8 * rates["examples_per_s"])
    assert summary["total_steps"] == 5 and summary["total_examples"] == 20
    assert summary["total_audio_seconds"] == 160.0


# -- weight export back to the JAX package ------------------------------------

TINY = dict(dmodel=32, num_blocks=2, head_size=16, num_heads=2,
            kernel_size=8, ctcdecoder_num_blocks=1, ctcdecoder_kernel_size=8,
            translator_num_blocks=2, translator_kernel_size=8)


def _unflatten(flat):
    tree = {}
    for name, arr in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(arr)
    return tree


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_exported_weights_score_the_same_in_the_jax_package(scan, tmp_path):
    """A port model (seeded init, then its BatchNorm buffers and biases
    perturbed so nothing is at its default) written by ``save_npz``: the
    file loads back into an equal state_dict, and the JAX model run on it
    gives the port's outputs."""
    cfg = tconf.ConformerConfig(**TINY, mel_layer_trainable=True)
    model = tconf.build_model(cfg, 11, 17, device="cpu", seed=5)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("bias", "running_mean")):
                t.add_(torch.randn(t.shape, generator=g) * 0.1)
            if name.endswith("running_var"):
                t.mul_(torch.rand(t.shape, generator=g) + 0.5)
    path = str(tmp_path / "port.npz")
    convert.save_npz(model, path, scan_layers=scan)
    back = convert.load_npz(path, cfg)
    state = model.state_dict()
    assert back.keys() == state.keys()
    for k in state:
        assert torch.equal(back[k], state[k]), k

    with np.load(path) as data:
        variables = _unflatten({k: data[k] for k in data.files})
    jcfg = jconf.ConformerConfig(**TINY, mel_layer_trainable=True,
                                 scan_layers=scan)
    jmodel = jconf.ConformerCTC(jcfg, 11, 17)
    rng = np.random.default_rng(2)
    wav = (rng.standard_normal((2, 8000)) * 0.1).astype(np.float32)
    ids = rng.integers(0, 11, (2, 6)).astype(np.int32)
    want = jax.jit(jmodel.apply)(variables, wav, ids)
    with torch.no_grad():
        got = model(torch.from_numpy(wav), torch.from_numpy(ids))
    for w, g_ in zip(want, got):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
