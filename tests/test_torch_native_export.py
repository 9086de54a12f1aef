"""The port's native export against the JAX package's: from the same weights
``export_native`` (JAX model built with and without ``scan_layers``, a
trainable mel matrix, the plain spectrogram frontend),
``export_native_chunk`` (both stack layouts) and ``export_native_vad`` write
the same files byte for byte; the refusals are JAX's; an artifact read back
through its manifest holds the model's weights bit for bit; and
``cli.test_asr`` / ``cli.test_chunk_asr`` ``--export_native`` write it.

The ``slow`` tests run the ``cpp/serving`` engines (built with cmake) on
artifacts the port wrote, as ``tests/test_native_{engine,chunk,vad}.py`` do
on the JAX package's."""

import dataclasses
import filecmp
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_chunk import tiny_cfg
from tests.test_torch_chunk import build_pair, with_scan
from tests.test_torch_serve import (  # noqa: F401 (a fixture)
    TINY,
    cli_configs,
    pair,
    randomize,
    speech,
)
from tensorflowasr_tpu.export import native_export as jexport
from tensorflowasr_tpu.models import conformer as jconf
from tensorflowasr_tpu.models import vad as jvad
from tensorflowasr_tpu_torch.export import native_export as texport
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.models import vad as tvad
from tensorflowasr_tpu_torch.utils.audio import read_wav, write_wav

torch.set_num_threads(2)

SR = 16000
FILES = ("weights.bin", "manifest.json", "manifest.txt")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same_files(a, b, names=FILES):
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name),
                           shallow=False), name


def vocabs(tmp_path, n_phone, n_char):
    pv, cv = tmp_path / "phones.txt", tmp_path / "chars.txt"
    pv.write_text("\n".join(f"p{i}" for i in range(n_phone - 1)),
                  encoding="utf-8")
    cv.write_text("\n".join(["<S>", "</S>"] + [f"c{i}" for i in
                                               range(n_char - 3)]),
                  encoding="utf-8")
    return str(pv), str(cv)


def offline_pair(seed=3, n_phone=9, n_char=14, **kw):
    """(flax model, its variables, the port's model), in the JAX model's
    own layout (scanned or not)."""
    jcfg = jconf.ConformerConfig(dropout=0.0, ctcdecoder_dropout=0.0,
                                 translator_dropout=0.0, n_mels=40,
                                 **TINY, **kw)
    jmodel = jconf.ConformerCTC(jcfg, n_phone, n_char)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3200), jnp.float32),
                            jnp.ones((1, 4), jnp.int32))
    variables = randomize(shapes, seed)
    if kw.get("mel_layer_trainable"):
        mel = variables["params"]["encoder"]["mel_layer"]
        mel["freq2mel"] = np.random.default_rng(seed).uniform(
            0, 1e-3, mel["freq2mel"].shape).astype(np.float32)
    tcfg = tconf.ConformerConfig(n_mels=40, **TINY, **kw)
    tmodel = tconf.ConformerCTC(tcfg, n_phone, n_char)
    tmodel.load_state_dict(convert.convert_flax_variables(variables, tcfg))
    return jmodel, variables, tmodel.eval()


@pytest.mark.parametrize("variant", ["unrolled", "scanned", "trainable_mel",
                                     "spectrogram"])
def test_export_native_equals_jax(tmp_path, variant):
    kw = {"scanned": dict(scan_layers=True),
          "trainable_mel": dict(mel_layer_trainable=True),
          "spectrogram": dict(mel_layer_type="Spectrogram")}.get(variant, {})
    jmodel, variables, tmodel = offline_pair(**kw)
    pv, cv = vocabs(tmp_path, 9, 14)
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    jexport.export_native(jmodel, variables, want, phone_vocab=pv,
                          char_vocab=cv)
    texport.export_native(tmodel, got, phone_vocab=pv, char_vocab=cv)
    same_files(want, got, FILES + ("phones.txt", "chars.txt"))
    tensors = texport.read_native(got)
    assert ("frontend/freq2mel" in tensors) == (variant != "spectrogram")
    assert "params/encoder/conformer_block_1/mhsa/mha/query/kernel" in \
        tensors
    if variant == "trainable_mel":
        # JAX looks for the trained matrix at the top level, where a
        # ConformerCTC has none (it is the encoder's), and so writes the
        # fixed basis there; the trained one is among the params
        from tensorflowasr_tpu_torch.ops import frontend as fe

        fixed = fe._frontend_constants(fe.LogMelFrontendConfig(n_mels=40))[1]
        assert np.array_equal(tensors["frontend/freq2mel"], fixed)
        assert not np.array_equal(
            tensors["params/encoder/mel_layer/freq2mel"], fixed)


def test_artifact_holds_the_weights_and_is_deterministic(tmp_path):
    from tensorflowasr_tpu_torch.ops import frontend as fe

    _, _, tmodel = offline_pair(seed=4)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    texport.export_native(tmodel, a)
    texport.export_native(tmodel, b)
    same_files(a, b)
    assert not os.path.exists(os.path.join(a, "phones.txt"))
    tensors = texport.read_native(a)
    flat = convert.to_flax_names(tmodel)
    dft, fb = fe._frontend_constants(fe.LogMelFrontendConfig(n_mels=40))
    assert sorted(tensors) == sorted(
        list(flat) + ["frontend/dft", "frontend/freq2mel"])
    for name, arr in flat.items():
        assert np.array_equal(tensors[name], arr), name
    assert np.array_equal(tensors["frontend/dft"], dft)
    assert np.array_equal(tensors["frontend/freq2mel"], fb)
    state = tmodel.state_dict()
    assert np.array_equal(
        tensors["batch_stats/encoder/conformer_block_0/conv_module/bn/var"],
        state["encoder.blocks.0.conv_module.bn.running_var"].numpy())


@pytest.mark.parametrize("scan", [False, True])
def test_export_native_chunk_equals_jax(tmp_path, scan):
    jmodel, variables, tmodel = build_pair(with_scan(tiny_cfg(), scan),
                                           seed=5)
    pv, cv = vocabs(tmp_path, jmodel.num_phone_classes,
                    jmodel.num_char_classes)
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    jexport.export_native_chunk(jmodel, variables, want, phone_vocab=pv,
                                char_vocab=cv)
    texport.export_native_chunk(tmodel, got, phone_vocab=pv, char_vocab=cv)
    same_files(want, got, FILES + ("phones.txt", "chars.txt"))
    tensors = texport.read_native(got)
    for name, arr in convert.to_flax_names(tmodel).items():
        assert np.array_equal(tensors[name], arr), name


def test_export_native_vad_equals_jax(tmp_path):
    from tests.test_torch_vad_punc import vad_pair

    jmodel, variables, tmodel = vad_pair("OnlineVAD", seed=6)
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    jexport.export_native_vad(jmodel, variables, want)
    texport.export_native_vad(tmodel, got)
    same_files(want, got)
    tensors = texport.read_native(got)
    assert len(tensors) == 14 and "params/audio_voice_mask/kernel" not in \
        tensors
    assert np.array_equal(tensors["params/cnn2/kernel"],
                          np.asarray(variables["params"]["cnn2"]["kernel"]))


def test_export_refusals_are_jax(tmp_path):
    jmodel, variables, tmodel = offline_pair()
    for change, match in ((dict(mel_layer_type="leaf"), "Melspectrogram"),
                          (dict(add_wav_info=True), "add_wav_info"),
                          (dict(streaming=True), "offline model")):
        tmodel.cfg = dataclasses.replace(tmodel.cfg, **change)
        jm = jconf.ConformerCTC(dataclasses.replace(jmodel.cfg, **change),
                                9, 14)
        with pytest.raises(ValueError, match=match):
            jexport.export_native(jm, variables, str(tmp_path / "j"))
        with pytest.raises(ValueError, match=match):
            texport.export_native(tmodel, str(tmp_path / "t"))
        tmodel.cfg = dataclasses.replace(
            tmodel.cfg, mel_layer_type="Melspectrogram", add_wav_info=False,
            streaming=False)
    for j, t in ((jvad.OfflineVAD(), tvad.OfflineVAD()),
                 (object(), tmodel)):
        with pytest.raises(ValueError, match="supports OnlineVAD"):
            jexport.export_native_vad(j, {"params": {}}, str(tmp_path / "j"))
        with pytest.raises(ValueError, match="supports OnlineVAD"):
            texport.export_native_vad(t, str(tmp_path / "t"))
    assert not os.path.exists(tmp_path / "t")


def test_cli_test_asr_export_native(cli_configs, tmp_path,  # noqa: F811
                                   capsys):
    from tensorflowasr_tpu.utils.text import TextFeaturizer
    from tensorflowasr_tpu_torch.cli.test_asr import main

    tmp, data_yml, model_yml, wav_path = cli_configs
    phone_f = TextFeaturizer({"vocabulary": str(tmp / "phones.txt")})
    char_f = TextFeaturizer({"vocabulary": str(tmp / "chars.txt")})
    # the weights tests/test_torch_serve.py decodes this wav with
    jmodel, variables, _ = pair(phone_f.num_classes, char_f.num_classes,
                                seed=15)
    weights = tmp / "weights.npz"
    np.savez(weights, **dict(jexport._flatten(variables)))
    want = str(tmp_path / "jax")
    jexport.export_native(jmodel, variables, want,
                          phone_vocab=str(tmp / "phones.txt"),
                          char_vocab=str(tmp / "chars.txt"))
    got = str(tmp_path / "port")
    args = ["--data_config", data_yml, "--model_config", model_yml,
            "--wav", wav_path, "--device", "cpu",
            "--compute_dtype", "float32", "--weights", str(weights)]
    assert main(args + ["--export_native", got]) == 0
    assert f"native artifact written to {got}" in capsys.readouterr().out
    same_files(want, got, FILES + ("phones.txt", "chars.txt"))
    with pytest.raises(NotImplementedError, match="not ported"):
        main(args + ["--export_savedmodel", str(tmp_path / "sm")])


# ---------------------------------------------------------------------------
# The cpp/serving engines on artifacts the port wrote (slow: a cmake build)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpp_build(tmp_path_factory):
    if shutil.which("cmake") is None:
        pytest.skip("cmake not available")
    build = str(tmp_path_factory.mktemp("portnative"))
    gen = ["-G", "Ninja"] if shutil.which("ninja") else []
    subprocess.run(["cmake", "-S", os.path.join(REPO, "cpp", "serving"),
                    "-B", build] + gen, check=True, capture_output=True)
    subprocess.run(["cmake", "--build", build], check=True,
                   capture_output=True)
    return build


def round_trip_wav(path, wav, sr=SR):
    """What the C++ engines read: the wav written as 16-bit and read back."""
    write_wav(path, wav, sr)
    return read_wav(path)[0]


@pytest.mark.slow
def test_offline_engine_on_port_artifact(cpp_build, tmp_path):
    from tensorflowasr_tpu_torch.ops.ctc import ctc_greedy_decode

    _, _, tmodel = offline_pair(seed=8)
    outdir = str(tmp_path / "artifact")
    texport.export_native(tmodel, outdir, *vocabs(tmp_path, 9, 14))
    wav_path = str(tmp_path / "x.wav")
    wav = round_trip_wav(wav_path, speech(1.0, seed=9))
    wav = wav / np.abs(wav).max()
    with torch.no_grad():
        enc = tmodel.encode(torch.from_numpy(wav[None]))
        logits = tmodel.ctc_logits(enc)
        ids, lens = ctc_greedy_decode(
            logits, torch.tensor([logits.shape[1]], dtype=torch.int32), 8)
        n = int(lens[0])
        padded = torch.nn.functional.pad(ids[:, :n], (0, 10))
        char_ids = tmodel.translate(padded, enc).argmax(-1)[0].tolist()
    dump = str(tmp_path / "logits.bin")
    out = subprocess.run([os.path.join(cpp_build, "asr_offline"), outdir,
                          wav_path, "--dump", dump],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    with open(dump, "rb") as f:
        tt, vv = np.frombuffer(f.read(8), np.int32)
        native = np.frombuffer(f.read(), np.float32).reshape(tt, vv)
    np.testing.assert_allclose(native, logits[0].numpy(), atol=2e-3,
                               rtol=1e-3)
    lines = {ln.split(":")[0]: ln.split(":", 1)[1].split()
             for ln in out.stdout.splitlines() if ":" in ln}
    assert [int(i) for i in lines["phone_ids"]] == ids[0, :n].tolist()
    assert len(set(ids[0, :n].tolist())) > 1
    assert [int(i) for i in lines["char_ids"]] == char_ids


@pytest.mark.slow
def test_chunk_engine_on_port_artifact(cpp_build, tmp_path):
    """As ``tests/test_native_chunk.py``'s base case: the JAX init's
    weights, carried into the port, 4 chunks of noise."""
    from tests.test_torch_chunk import port_cfg
    from tensorflowasr_tpu.models.chunk_conformer import ChunkConformer
    from tensorflowasr_tpu_torch.models import chunk_conformer as tcc
    from tensorflowasr_tpu_torch.serve.chunk_session import (
        ChunkStreamSession,
    )

    cfg = tiny_cfg()
    jmodel = ChunkConformer(cfg, 11, 13)
    variables = jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.chunk_samples)),
        jnp.ones((1, 4), jnp.int32), 8, False,
        method=ChunkConformer.train_forward)
    tmodel = tcc.ChunkConformer(port_cfg(cfg), 11, 13)
    tmodel.load_state_dict(convert.convert_flax_variables(
        jax.device_get(variables), port_cfg(cfg)))
    outdir = str(tmp_path / "artifact")
    texport.export_native_chunk(tmodel.eval(), outdir,
                                *vocabs(tmp_path, 11, 13))
    wav_path = str(tmp_path / "utt.wav")
    rng = np.random.default_rng(11)
    wav = round_trip_wav(wav_path, (0.1 * rng.standard_normal(
        4 * cfg.chunk_samples)).astype(np.float32))
    session = ChunkStreamSession(tmodel, device="cpu")
    session.feed(wav)
    want = session.flush()
    out = subprocess.run([os.path.join(cpp_build, "asr_chunk"), outdir,
                          wav_path, "--quiet"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = {ln.split("]")[0][1:]: ln.split("]", 1)[1].strip()
             for ln in out.stdout.splitlines() if ln.startswith("[")}
    assert lines["phones"].split() == [f"p{i}" for i in want["phone_ids"]]
    assert [int(x) for x in lines["chars"].split()] == want["char_ids"]
    assert want["phone_ids"] and want["char_ids"]


@pytest.mark.slow
def test_vad_engine_on_port_artifact(cpp_build, tmp_path):
    from tests.test_torch_vad_punc import vad_pair

    wav_path = str(tmp_path / "x.wav")
    rng = np.random.default_rng(0)
    wav = round_trip_wav(wav_path, (0.3 * rng.standard_normal(SR)).astype(
        np.float32))
    ds = wav[::2]
    frames = ds[:len(ds) // 80 * 80].reshape(1, -1, 80)
    _, _, tmodel = vad_pair("OnlineVAD", seed=7, calibrate_on=frames)
    outdir = str(tmp_path / "vad")
    texport.export_native_vad(tmodel, outdir)
    with torch.no_grad():
        want = torch.sigmoid(tmodel.infer(torch.from_numpy(frames)))[0, :, 0]
    dump = str(tmp_path / "probs.bin")
    out = subprocess.run([os.path.join(cpp_build, "asr_vad"), outdir,
                          wav_path, "--dump", dump],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    with open(dump, "rb") as f:
        n = np.frombuffer(f.read(4), np.int32)[0]
        got = np.frombuffer(f.read(), np.float32)
    assert n == frames.shape[1]
    np.testing.assert_allclose(got, want.numpy(), atol=1e-4, rtol=1e-4)
    assert (want > 0.5).any() and (want < 0.5).any()
