"""The port's chunk-streaming serving against the JAX package's, from the same
weights on the CPU: ``ChunkStreamSession`` (and its equality with the
offline decode), ``MultiStreamChunkServer`` with interleaved streams, slot
reuse and the JAX server beside it, and ``cli.test_chunk_asr`` on a
synthetic wav with ``--weights`` in both stack layouts."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from tests.test_chunk import N_CHAR, N_PHONE, tiny_cfg
from tests.test_torch_chunk import SR, State, build_pair, speech
from tensorflowasr_tpu.serve.chunk_session import (
    ChunkStreamSession as JChunkStreamSession,
)
from tensorflowasr_tpu.serve.multi_session import (
    MultiStreamChunkServer as JMultiStreamChunkServer,
)
from tensorflowasr_tpu_torch.serve.chunk_session import (
    ChunkStreamSession,
    collapse,
)
from tensorflowasr_tpu_torch.serve.multi_session import (
    MultiStreamChunkServer,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    jcfg = tiny_cfg()
    calib = np.stack([speech(6 * jcfg.chunk_samples / SR, seed=s)
                      for s in (21, 22)])
    return build_pair(jcfg, seed=1, calib=calib)


def packets(wav, sizes):
    """``wav`` cut into consecutive packets of the sizes in turn."""
    out, i, k = [], 0, 0
    while i < len(wav):
        n = sizes[k % len(sizes)]
        out.append(wav[i:i + n])
        i, k = i + n, k + 1
    return out


def test_chunk_stream_session_matches_jax_and_offline(pair):
    jmodel, variables, tmodel = pair
    wav = speech(2.1, seed=40)
    session = ChunkStreamSession(tmodel, device="cpu")
    jsession = JChunkStreamSession(jmodel, variables)
    for pkt in packets(wav, [1000, 3001, 517]):
        assert session.feed(pkt) == jsession.feed(pkt)
        assert session._decode.char_ids == jsession._char_ids
        assert session._decode.provisional_ids == jsession._provisional_ids
    out, jout = session.flush(), jsession.flush()
    assert out == jout
    assert len(set(out["phone_ids"])) > 2 and len(out["char_ids"]) > 2

    # the offline phone argmax of the padded signal, collapsed
    cs = tmodel.cfg.chunk_samples
    padded = np.zeros(-(-len(wav) // cs) * cs, np.float32)
    padded[:len(wav)] = wav
    with torch.no_grad():
        logits, _ = tmodel.encode_to_phones(torch.from_numpy(padded[None]))
    assert out["phone_ids"] == collapse(
        np.argmax(logits[0].numpy(), -1).tolist(), N_PHONE - 1)

    session.reset()
    assert session.result() == {"phone_ids": [], "char_ids": []}


def test_multi_stream_server_matches_sessions_and_jax(pair):
    """4 slots, 3 streams fed interleaved odd-sized packets, one closed
    early and its slot reused by a fourth: each equals its own session and
    the JAX server's result."""
    jmodel, variables, tmodel = pair
    wavs = [speech(s, seed=50 + i) for i, s in enumerate((1.3, 0.7, 1.9,
                                                          1.1))]
    singles = []
    for w in wavs:
        session = ChunkStreamSession(tmodel, device="cpu")
        session.feed(w)
        singles.append(session.flush())

    results = []
    for server in (MultiStreamChunkServer(tmodel, n_slots=4, device="cpu"),
                   JMultiStreamChunkServer(jmodel, variables, n_slots=4)):
        queues, stream_of, got = {}, {}, {}
        for i in range(3):
            slot = server.open()
            queues[slot] = packets(wavs[i], [2203, 777, 4100])
            stream_of[slot] = i
        while queues:
            for slot in list(queues):
                server.feed(slot, queues[slot].pop(0))
            server.tick()
            for slot in [s for s in queues if not queues[s]]:
                got[stream_of[slot]] = server.close(slot)
                del queues[slot]
                if 3 not in stream_of.values():   # the 4th reuses a slot
                    new = server.open()
                    assert new == slot
                    queues[new] = packets(wavs[3], [1500])
                    stream_of[new] = 3
        assert server.n_active == 0
        results.append(got)
    mine, theirs = results
    assert mine == theirs
    assert [mine[i] for i in range(4)] == singles
    with pytest.raises(ValueError, match="not an open stream"):
        MultiStreamChunkServer(tmodel, n_slots=1, device="cpu").feed(
            0, wavs[0])


def test_full_pool_raises(pair):
    server = MultiStreamChunkServer(pair[2], n_slots=2, device="cpu")
    server.open()
    server.open()
    with pytest.raises(RuntimeError, match="busy"):
        server.open()


def test_cuda_without_cuda_raises(pair):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ChunkStreamSession(pair[2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MultiStreamChunkServer(pair[2], n_slots=2)


# ---------------------------------------------------------------------------
# cli.test_chunk_asr
# ---------------------------------------------------------------------------

def _stack_section(stack):
    return {k: getattr(stack, k) for k in (
        "dmodel", "num_blocks", "head_size", "num_heads", "kernel_size",
        "fc_factor", "dropout", "win_front", "win_back")}


@pytest.fixture()
def cli_configs(tmp_path):
    cfg = tiny_cfg()
    (tmp_path / "phones.txt").write_text(
        "\n".join(f"p{i}" for i in range(N_PHONE - 1)), encoding="utf-8")
    (tmp_path / "chars.txt").write_text(
        "\n".join(["<S>", "</S>"] + [f"c{i}" for i in range(N_CHAR - 3)]),
        encoding="utf-8")
    data_cfg = {
        "speech_config": {"sample_rate": SR, "stride_ms": 10,
                          "reduction_factor": 4, "num_feature_bins": 20},
        "inp_config": {"vocabulary": str(tmp_path / "phones.txt"),
                       "blank_at_zero": False},
        "tar_config": {"vocabulary": str(tmp_path / "chars.txt"),
                       "blank_at_zero": False},
    }
    model_cfg = {"model_config": {
        "name": "ChunkConformer",
        "ChunkConformerFront": {
            "dmodel": cfg.dmodel, "reduction_factor": cfg.reduction_factor,
            "dropout": 0.0, "sample_rate": SR, "n_mels": cfg.n_mels,
            "stride_ms": 10, "chunk_num": cfg.chunk_num},
        "ChunkConformerEncoder": _stack_section(cfg.encoder),
        "ChunkCTCPicker": _stack_section(cfg.picker),
        "ChunkCTCDecoder": _stack_section(cfg.decoder),
        "ContextHelper": _stack_section(cfg.helper),
    }}
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


def _scanned(flat):
    """The same variables in the scanned layout: each stack's block_{i}
    leaves stacked on axis 0 under ``block``."""
    groups, out = {}, {}
    for name, arr in flat.items():
        m = re.match(r"^(.*)/block_(\d+)/(.*)$", name)
        if m:
            groups.setdefault(f"{m.group(1)}/block/{m.group(3)}",
                              {})[int(m.group(2))] = arr
        else:
            out[name] = arr
    for name, layers in groups.items():
        out[name] = np.stack([layers[i] for i in sorted(layers)])
    return out


def test_cli_test_chunk_asr_matches_jax(pair, cli_configs, capsys):
    from tensorflowasr_tpu.export.native_export import _flatten
    from tensorflowasr_tpu.train.chunk_trainer import make_chunk_predict_step
    from tensorflowasr_tpu.utils.audio import read_wav
    from tensorflowasr_tpu.utils.text import TextFeaturizer
    from tensorflowasr_tpu_torch.cli.test_chunk_asr import main

    jmodel, variables, _ = pair
    tmp_path, data_yml, model_yml, wav_path = cli_configs
    phone_f = TextFeaturizer({"vocabulary": str(tmp_path / "phones.txt")})
    char_f = TextFeaturizer({"vocabulary": str(tmp_path / "chars.txt")})
    assert (phone_f.num_classes, char_f.num_classes) == (N_PHONE, N_CHAR)

    # the JAX package on the same wav: offline predict step, then a session
    wav, _ = read_wav(wav_path, target_sr=SR)
    cs = jmodel.cfg.chunk_samples
    n_chunks = -(-len(wav) // cs)
    padded = np.zeros(n_chunks * cs, np.float32)
    padded[:len(wav)] = wav
    state = State(variables["params"], variables["batch_stats"])
    char_ids, char_lens, ph_ids, ph_lens = (
        np.asarray(x) for x in make_chunk_predict_step(jmodel)(
            state, jnp.asarray(padded[None]),
            jnp.asarray([n_chunks * jmodel.cfg.sub_length], jnp.int32)))
    session = JChunkStreamSession(jmodel, variables, phone_f, char_f)
    for i in range(n_chunks):
        session.feed(padded[i * cs:(i + 1) * cs])
    stream = session.flush()
    want = {
        "offline phones:": " ".join(phone_f.iextract(
            list(ph_ids[0, :ph_lens[0]]))),
        "offline chars :": "".join(char_f.iextract(
            list(char_ids[0, :char_lens[0]]))),
        "stream  phones:": " ".join(stream["phones"]),
        "stream  chars :": stream["text"],
    }
    assert len(want["stream  phones:"].split()) > 3

    flat = dict(_flatten(variables))
    args = ["--data_config", data_yml, "--model_config", model_yml,
            "--wav", wav_path, "--device", "cpu",
            "--compute_dtype", "float32"]
    for layout, weights in (("unrolled", flat), ("scanned", _scanned(flat))):
        path = tmp_path / f"{layout}.npz"
        np.savez(path, **weights)
        assert main(args + ["--weights", str(path)]) == 0
        out = capsys.readouterr().out
        assert "RTF" in out and "on cpu" in out
        for label, line in want.items():
            assert _printed(out, label) == line, (layout, label)

    # no weights: seeded random init, with a warning
    assert main(args) == 0
    captured = capsys.readouterr()
    assert "random init" in captured.err and "stream  phones:" in \
        captured.out
    # --export_native writes JAX's artifact from the same weights, byte for
    # byte (tests/test_torch_native_export.py holds the exporter itself);
    # --export_savedmodel (TF) stays refused
    from tensorflowasr_tpu.export.native_export import export_native_chunk

    path = tmp_path / "unrolled.npz"
    assert main(args + ["--weights", str(path), "--export_native",
                        str(tmp_path / "native")]) == 0
    assert "native chunk artifact written" in capsys.readouterr().out
    export_native_chunk(jmodel, variables, str(tmp_path / "jax_native"),
                        phone_vocab=str(tmp_path / "phones.txt"),
                        char_vocab=str(tmp_path / "chars.txt"))
    for name in ("weights.bin", "manifest.json", "manifest.txt",
                 "phones.txt", "chars.txt"):
        assert (tmp_path / "native" / name).read_bytes() == \
            (tmp_path / "jax_native" / name).read_bytes(), name
    with pytest.raises(NotImplementedError, match="not ported"):
        main(args + ["--export_savedmodel", str(tmp_path / "sm")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(args[:-4])
