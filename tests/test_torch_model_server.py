"""The port's socket serving stack against the JAX package's, on the CPU:
the wire bytes (``encode_tensor``) for every dtype and rank; the port's
client with a JAX server and the JAX client with the port's server, error
replies keeping the connection usable; the worker loop; ``build_asr_ops``
against the JAX package's on the same weights (values within 1e-5 of each
output's largest entry, ``info`` and the energy ``vad`` identical);
``BatchingStreamFront`` with concurrent clients, a close waking blocked
feeders, a ticker crash reaching them, the ops over a socket and (slow) the
close/feed race stress; ``cli.serve_model.build_chunk_stream_ops`` on a
trained checkpoint and its ``main`` in a subprocess; and (slow) the C++
hosts ``asr_client`` and ``asr_stream`` against the port's server.

Every thread here is a daemon joined with a timeout and every wait is
bounded, so a hang fails one test instead of stalling the suite."""

import os
import queue
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_chunk import N_CHAR, N_PHONE, tiny_cfg
from tests.test_torch_chunk import SR, build_pair, close, speech
from tensorflowasr_tpu.models import conformer as jconf
from tensorflowasr_tpu.models import vad as jvad
from tensorflowasr_tpu.serve import model_server as jms
from tensorflowasr_tpu.serve.engines import ASREngine as JASREngine
from tensorflowasr_tpu.serve.engines import VADEngine as JVADEngine
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.models import vad as tvad
from tensorflowasr_tpu_torch.serve import model_server as tms
from tensorflowasr_tpu_torch.serve.chunk_session import ChunkStreamSession
from tensorflowasr_tpu_torch.serve.engines import ASREngine, VADEngine
from tensorflowasr_tpu_torch.serve.multi_session import (
    BatchingStreamFront,
    MultiStreamChunkServer,
    build_stream_ops,
)
from tensorflowasr_tpu_torch.utils.audio import read_wav, write_wav

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120


def join_all(threads, timeout=JOIN_S):
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), f"{t.name} still running"


def spawn(target, *args):
    t = threading.Thread(target=target, args=args, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# The wire
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32", "int64", "float64"])
def test_encode_tensor_bytes_equal_jax(dtype):
    rng = np.random.default_rng(0)
    for shape in [(), (3,), (2, 5), (2, 1, 4), (0,), (3, 0, 2)]:
        arr = (rng.standard_normal(shape) * 1000).astype(dtype)
        assert tms.encode_tensor(arr) == jms.encode_tensor(arr), shape
        # a strided view serializes as its contiguous copy
        if arr.ndim >= 2:
            view = arr[..., ::2]
            assert tms.encode_tensor(view) == jms.encode_tensor(view)


def echo_ops():
    def fail(*ts):
        raise ValueError("bad input")

    return {"echo": lambda *ts: list(ts),
            "shape": lambda x: np.asarray(x.shape, np.int64),
            "half": lambda x: x.astype(np.float64) / 2,
            "fail": fail}


def check_echo_calls(client):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3)).astype(np.float32)
    ids = np.arange(4, dtype=np.int32)
    out = client.call("echo", x, ids)
    assert [o.dtype for o in out] == [np.float32, np.int32]
    np.testing.assert_array_equal(out[0], x)
    np.testing.assert_array_equal(out[1], ids)
    (shape,) = client.call("shape", x)
    assert shape.dtype == np.int32 and shape.tolist() == [2, 3]
    (half,) = client.call("half", x)
    assert half.dtype == np.float32
    np.testing.assert_array_equal(half, x / 2)
    assert client.call("echo") == []
    # an error reply keeps the wire in step: the next call works
    with pytest.raises(RuntimeError, match="bad input"):
        client.call("fail", x)
    np.testing.assert_array_equal(client.call("echo", ids)[0], ids)
    with pytest.raises(RuntimeError, match="no_such_op"):
        client.call("no_such_op", x)
    np.testing.assert_array_equal(client.call("echo", x)[0], x)


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_client_server_interop(server_side):
    """The port's client against a JAX server, and the JAX client against
    the port's server, on an echo op table."""
    server_cls, client_cls = (
        (jms.ModelServer, tms.ModelClient) if server_side == "jax"
        else (tms.ModelServer, jms.ModelClient))
    server = server_cls(echo_ops(), tcp_port=0)
    server.start()
    try:
        client = client_cls(tcp_port=server.tcp_port)
        try:
            check_echo_calls(client)
        finally:
            client.close()
    finally:
        server.stop()


def test_worker_loop_runs_queued_ops(tmp_path):
    """``inline_exec=False`` on a unix socket: ops run on the thread in
    ``run_worker_loop``, the inline ones on the connection's thread, and a
    failing op's error reaches the client."""
    path = str(tmp_path / "s.sock")
    ran_on = []
    ops = {**echo_ops(),
           "queued": lambda: ran_on.append(threading.get_ident()) or [],
           "inline": lambda: ran_on.append(threading.get_ident()) or []}
    server = tms.ModelServer(ops, unix_path=path, inline_exec=False,
                             inline_ops={"echo", "inline"})
    server.start()
    idents = {}

    def worker():
        idents["worker"] = threading.get_ident()
        server.run_worker_loop()

    loop = spawn(worker)
    try:
        client = tms.ModelClient(unix_path=path)
        try:
            check_echo_calls(client)
            assert client.call("queued") == client.call("inline") == []
            assert ran_on[0] == idents["worker"] != ran_on[1]
        finally:
            client.close()
    finally:
        server.stop()
        join_all([loop], timeout=10)
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# build_asr_ops
# ---------------------------------------------------------------------------

def tiny_conformer():
    """The JAX test's tiny ConformerCTC (tests/test_cpp_serving.py) and the
    port's with its weights: (flax model, variables, port model)."""
    kw = dict(dmodel=32, num_blocks=1, head_size=8, num_heads=2,
              kernel_size=8, ctcdecoder_num_blocks=1,
              translator_num_blocks=1)
    jmodel = jconf.ConformerCTC(jconf.ConformerConfig(dropout=0.0, **kw),
                                8, 12)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8000), jnp.float32),
                            jnp.ones((1, 4), jnp.int32))
    tcfg = tconf.ConformerConfig(**kw)
    tmodel = tconf.ConformerCTC(tcfg, 8, 12)
    tmodel.load_state_dict(convert.convert_flax_variables(variables, tcfg))
    return jmodel, variables, tmodel.eval()


def test_build_asr_ops_match_jax():
    jmodel, variables, tmodel = tiny_conformer()
    jops = jms.build_asr_ops(JASREngine(jmodel, variables, chunk_seconds=0.5,
                                        sample_rate=SR))
    ops = tms.build_asr_ops(ASREngine(tmodel, chunk_seconds=0.5,
                                      sample_rate=SR))
    assert sorted(ops) == sorted(jops)
    np.testing.assert_array_equal(ops["info"](), jops["info"]())
    # one 7680-sample quantum and a 320-sample rest: chunk_frames + 1 rows
    wav = speech(0.5, seed=3)[None]
    enc = ops["encode"](wav)
    jenc = np.asarray(jops["encode"](wav))
    rows = ASREngine(tmodel).chunk_frames + 1
    assert enc.dtype == np.float32 and enc.shape == (rows, 32)
    close(enc, jenc)
    for arg in (jenc, jenc[None]):                 # [T, d] or [1, T, d]
        got = ops["ctc_logits"](arg)
        assert got.dtype == np.float32 and got.shape == (rows, 8)
        close(got, jops["ctc_logits"](arg))
    ids = np.array([[3, 1, 4, 1, 5, 0, 0]], np.int32)
    got = ops["translate"](ids, jenc)
    assert got.dtype == np.float32 and got.shape == (7, 12)
    close(got, jops["translate"](ids, jenc))
    frames = np.concatenate([np.zeros((1, 3, 80), np.float32),
                             speech(0.05, seed=4).reshape(1, 10, 80)], 1)
    np.testing.assert_array_equal(ops["vad"](frames), jops["vad"](frames))
    assert (ops["vad"](frames)[:3] < 0).all() and \
        (ops["vad"](frames)[3:] > 0).any()
    # with a VAD engine (ported), the vad op is that engine's, as JAX's
    jvad_model = jvad.OnlineVAD(dmodel=8)
    vad_vars = jvad_model.init(jax.random.PRNGKey(1),
                               jnp.zeros((1, 4, 80), jnp.float32))
    tvad_model = convert.load_flax_variables(tvad.OnlineVAD(dmodel=8),
                                             vad_vars)
    ops = tms.build_asr_ops(ASREngine(tmodel),
                            vad_engine=VADEngine(tvad_model, device="cpu"))
    jops = jms.build_asr_ops(JASREngine(jmodel, variables),
                             JVADEngine(jvad_model, vad_vars))
    want = np.asarray(jops["vad"](frames))
    np.testing.assert_allclose(ops["vad"](frames), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert len(np.unique(np.round(want, 4))) > 3


# ---------------------------------------------------------------------------
# BatchingStreamFront and the stream ops
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chunk_model():
    jcfg = tiny_cfg()
    calib = np.stack([speech(6 * jcfg.chunk_samples / SR, seed=s)
                      for s in (21, 22)])
    return build_pair(jcfg, seed=1, calib=calib)[2]


def sessions(model, wavs):
    out = []
    for w in wavs:
        session = ChunkStreamSession(model, device="cpu")
        session.feed(w)
        out.append(session.flush())
    return out


def test_batching_front_concurrent_clients(chunk_model):
    """Concurrent client threads through the front and its op table decode
    as independent sessions."""
    cs = chunk_model.cfg.chunk_samples
    wavs = [speech(n / SR, seed=60 + i) for i, n in
            enumerate([3 * cs, 2 * cs + cs // 3, 4 * cs + 77])]
    expected = sessions(chunk_model, wavs)
    assert sum(len(e["char_ids"]) for e in expected) > 4
    front = BatchingStreamFront(
        MultiStreamChunkServer(chunk_model, n_slots=3, device="cpu"),
        max_wait_ms=5.0)
    ops = build_stream_ops(front)
    assert ops["stream_info"]().tolist() == [cs, SR, 3]
    results = [None] * len(wavs)

    def client(i):
        slot = ops["stream_open"]()
        for off in range(0, len(wavs[i]), cs):       # a chunk a feed
            ops["stream_feed"](slot, wavs[i][off:off + cs])
        ops["stream_result"](slot)
        ph, ch = ops["stream_close"](slot)
        results[i] = {"phone_ids": ph.tolist(), "char_ids": ch.tolist()}

    try:
        join_all([spawn(client, i) for i in range(len(wavs))])
    finally:
        front.shutdown()
    assert results == expected


def test_batching_front_close_wakes_blocked_feeders(chunk_model):
    """A close runs a drain tick that also consumes another slot's buffered
    chunk: the feeder blocked on that slot must wake."""
    cs = chunk_model.cfg.chunk_samples
    rng = np.random.default_rng(7)
    # a long coalescing window keeps the ticker waiting, so the close
    # performs the drain tick itself
    front = BatchingStreamFront(
        MultiStreamChunkServer(chunk_model, n_slots=2, device="cpu"),
        max_wait_ms=2000.0, feed_deadline_s=30.0)
    try:
        a, b = front.open(), front.open()
        done = threading.Event()

        def feeder():
            front.feed(b, rng.standard_normal(cs).astype(np.float32))
            done.set()

        t = spawn(feeder)
        time.sleep(0.3)                   # the feeder blocks in its wait
        front.feed(a, rng.standard_normal(cs // 2).astype(np.float32))
        front.close(a)
        assert done.wait(timeout=10), \
            "feeder still blocked after close() drained its chunk"
        join_all([t], timeout=10)
        front.close(b)
    finally:
        front.shutdown()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_batching_front_ticker_crash_reaches_feeder(chunk_model):
    cs = chunk_model.cfg.chunk_samples
    server = MultiStreamChunkServer(chunk_model, n_slots=1, device="cpu")

    def broken_tick():
        raise RuntimeError("tick failed")

    server.tick = broken_tick
    front = BatchingStreamFront(server, max_wait_ms=0.0,
                                feed_deadline_s=30.0)
    errors = []

    def feeder(slot):
        try:
            front.feed(slot, np.zeros(cs, np.float32))
        except RuntimeError as e:
            errors.append(e)

    try:
        join_all([spawn(feeder, front.open())], timeout=30)
    finally:
        front.shutdown()
    assert len(errors) == 1 and "ticker thread crashed" in str(errors[0])
    assert str(errors[0].__cause__) == "tick failed"


@pytest.mark.slow
def test_batching_front_stress_close_feed_races(chunk_model):
    """Many rounds of concurrent clients whose closes race other clients'
    feeds through one front: every round completes and decodes as
    independent sessions (slots reused ~30 times)."""
    cs = chunk_model.cfg.chunk_samples
    wavs = [speech(n / SR, seed=70 + i) for i, n in
            enumerate([3 * cs, cs // 2, 4 * cs + 77, 2 * cs + cs // 3])]
    expected = sessions(chunk_model, wavs)
    front = BatchingStreamFront(
        MultiStreamChunkServer(chunk_model, n_slots=4, device="cpu"),
        max_wait_ms=2.0, feed_deadline_s=60.0)
    try:
        for r in range(30):
            results, errors = [None] * len(wavs), []

            def client(i):
                try:
                    slot = front.open()
                    # ragged packets stagger the finishes and the closes
                    pkt = cs if i % 2 == 0 else cs // 2 + 13
                    for off in range(0, len(wavs[i]), pkt):
                        front.feed(slot, wavs[i][off:off + pkt])
                    results[i] = front.close(slot)
                except Exception as e:          # surfaced below
                    errors.append((i, e))

            threads = [spawn(client, i) for i in range(len(wavs))]
            for t in threads:
                t.join(timeout=JOIN_S)
                assert not t.is_alive(), \
                    f"round {r}: client hung; {front._debug_state()}"
            assert not errors, f"round {r}: {errors}"
            assert results == expected, f"round {r}"
    finally:
        front.shutdown()


def test_stream_ops_over_socket(chunk_model):
    """The whole wire path: a ModelServer with the stream ops inline, two
    concurrent TCP clients streaming different audio in odd-sized
    packets."""
    cs = chunk_model.cfg.chunk_samples
    wavs = [speech(3 * cs / SR, seed=80), speech((2 * cs + 11) / SR, seed=81)]
    expected = sessions(chunk_model, wavs)
    front = BatchingStreamFront(
        MultiStreamChunkServer(chunk_model, n_slots=2, device="cpu"),
        max_wait_ms=5.0)
    ops = build_stream_ops(front)
    server = tms.ModelServer(ops, tcp_port=0, inline_exec=False,
                             inline_ops=set(ops))
    server.start()
    results = [None] * len(wavs)

    def client(i):
        cli = tms.ModelClient(tcp_port=server.tcp_port)
        try:
            slot = cli.call("stream_open")[0]
            for off in range(0, len(wavs[i]), 1999):
                cli.call("stream_feed", slot, wavs[i][off:off + 1999])
            ph, ch = cli.call("stream_close", slot)
            results[i] = {"phone_ids": ph.tolist(), "char_ids": ch.tolist()}
        finally:
            cli.close()

    try:
        join_all([spawn(client, i) for i in range(len(wavs))])
    finally:
        server.stop()
        front.shutdown()
    assert results == expected


# ---------------------------------------------------------------------------
# cli.serve_model
# ---------------------------------------------------------------------------

def _sine(freq, seconds, amp=0.5):
    t = np.arange(int(seconds * SR)) / SR
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def write_configs(tmp_path):
    """The chunk CLI corpus of tests/test_cli_extra.py (a 2-utterance train
    list, a pinyin map, phone and char vocabularies, the tiny chunk model)
    and a tiny offline ConformerCTC config with its own outdir. Returns
    (chunk data yml, chunk model yml, offline data yml, offline model
    yml)."""
    lines = []
    for i, txt in enumerate(["ni3 hao3", "shi4 jie4"]):
        p = tmp_path / f"u{i}.wav"
        write_wav(str(p), _sine(200 + 40 * i, 1.0), SR)
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
    vocab = {"inp_config": {"vocabulary": str(tmp_path / "phones.txt"),
                            "blank_at_zero": False},
             "tar_config": {"vocabulary": str(tmp_path / "chars.txt"),
                            "blank_at_zero": False}}
    data_cfg = {
        "speech_config": {
            "sample_rate": SR, "stride_ms": 10, "reduction_factor": 4,
            "wav_max_duration": 2,
            "train_list": str(tmp_path / "train.list"),
            "eval_list": str(tmp_path / "train.list"),
            "pinyin_map": str(tmp_path / "p2p.map"),
            "transcripts_are_pinyin": True,
        },
        **vocab,
        "augments_config": None,
        "optimizer_config": {"lr": 0.003},
        "running_config": {"batch_size": 2, "log_interval_steps": 2,
                           "save_interval_steps": 2,
                           "outdir": str(tmp_path / "logs")},
    }
    stack = dict(dmodel=16, head_size=8, num_heads=2, kernel_size=4,
                 fc_factor=0.5, dropout=0.0, win_front=6)
    model_cfg = {"model_config": {
        "name": "ChunkConformer",
        "ChunkConformerFront": {"dmodel": 16, "reduction_factor": 4,
                                "sample_rate": SR, "n_mels": 20,
                                "stride_ms": 10, "chunk_num": 16},
        "ChunkConformerEncoder": {**stack, "num_blocks": 1, "win_back": 0},
        "ChunkCTCPicker": {**stack, "num_blocks": 1, "win_back": 0},
        "ChunkCTCDecoder": {**stack, "num_blocks": 1, "win_back": 2},
        "ContextHelper": {**stack, "num_blocks": 1, "win_back": 0},
    }}
    offline_data = {
        "speech_config": {"sample_rate": SR, "stride_ms": 10,
                          "reduction_factor": 4},
        **vocab,
        "running_config": {"outdir": str(tmp_path / "offline_logs")},
    }
    offline_model = {"model_config": dict(
        name="OfflineConformerCTC", dmodel=32, num_blocks=1, head_size=8,
        num_heads=2, kernel_size=8, ctcdecoder_num_blocks=1,
        translator_num_blocks=1)}
    paths = []
    for name, cfg in (("d.yml", data_cfg), ("m.yml", model_cfg),
                      ("od.yml", offline_data), ("om.yml", offline_model)):
        (tmp_path / name).write_text(yaml.dump(cfg), encoding="utf-8")
        paths.append(str(tmp_path / name))
    return paths


def test_serve_model_cli(tmp_path, capsys):
    """``cli.train_asr`` on the chunk config for 2 steps, then
    ``build_chunk_stream_ops`` restores the checkpoint and serves
    deterministic decodes equal to a session's; then ``main`` in a
    subprocess on a unix socket answers ``info`` and one stream."""
    from tensorflowasr_tpu_torch.cli.serve_model import (
        build_chunk_stream_ops,
    )
    from tensorflowasr_tpu_torch.cli.train_asr import main as train_main

    dp, mp, odp, omp = write_configs(tmp_path)
    assert train_main(["--data_config", dp, "--model_config", mp,
                       "--total_steps", "2", "--compute_dtype", "float32",
                       "--device", "cpu", "--data_workers", "0"]) == 0
    capsys.readouterr()
    ops, front = build_chunk_stream_ops(dp, mp, n_slots=2, max_wait_ms=2.0,
                                        device="cpu")
    assert "no chunk ASR checkpoint" not in capsys.readouterr().err
    wav = _sine(220, 1.0)
    try:
        info = ops["stream_info"]()
        cs = int(info[0])
        assert info.tolist() == [cs, SR, 2]

        def run_once():
            slot = ops["stream_open"]()
            for off in range(0, len(wav), cs):
                ops["stream_feed"](slot, wav[off:off + cs])
            return [x.tolist() for x in ops["stream_close"](slot)]

        first = run_once()
        assert run_once() == first        # slot reuse decodes the same
        want = sessions(front._srv.model, [wav])[0]
        assert first == [want["phone_ids"], want["char_ids"]]
    finally:
        front.shutdown()

    sock = str(tmp_path / "serve.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tensorflowasr_tpu_torch.cli.serve_model",
         "--data_config", odp, "--model_config", omp,
         "--chunk_data_config", dp, "--chunk_model_config", mp,
         "--socket", sock, "--stream_slots", "2", "--stream_wait_ms", "2",
         "--device", "cpu", "--compute_dtype", "float32",
         "--log_level", "WARNING"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    lines: "queue.Queue" = queue.Queue()
    spawn(lambda: [lines.put(ln) for ln in proc.stdout])
    try:
        deadline = time.monotonic() + 120
        ready = ""
        while "model server ready" not in ready:
            assert proc.poll() is None, proc.stderr.read()
            try:
                ready = lines.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                pytest.fail("no 'model server ready' within 120 s")
        assert ready.strip() == f"model server ready on {sock}"
        client = tms.ModelClient(unix_path=sock)
        try:
            (info,) = client.call("info")
            assert info.tolist() == [7680, SR, 32]
            (sinfo,) = client.call("stream_info")
            assert sinfo.tolist() == [cs, SR, 2]
            slot = client.call("stream_open")[0]
            for off in range(0, len(wav), 3001):
                client.call("stream_feed", slot, wav[off:off + 3001])
            got = [x.tolist() for x in client.call("stream_close", slot)]
            assert got == first
        finally:
            client.close()
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
    assert "no ASR checkpoint" in proc.stderr.read()


def test_serve_model_refuses_unported_options(tmp_path):
    from tensorflowasr_tpu_torch.cli.serve_model import main

    base = ["--data_config", "unused.yml", "--model_config", "unused.yml",
            "--device", "cpu"]
    # the beam and the LM are ported (tests/test_torch_lm_cli.py serves
    # with them), and so are the VAD configs (tests/test_torch_stream_
    # session.py): no refusal, the missing config file is what fails
    for extra in (["--beam_width", "4"], ["--lm", "lm.npz"],
                  ["--vad_data_config", "v.yml", "--vad_model_config",
                   "vm.yml"]):
        with pytest.raises(FileNotFoundError, match="unused.yml"):
            main(base + extra)


def test_serve_model_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    from tensorflowasr_tpu_torch.cli.serve_model import main

    _, _, odp, omp = write_configs(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--data_config", odp, "--model_config", omp])


# ---------------------------------------------------------------------------
# The C++ serving hosts against the port's server
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpp_build(tmp_path_factory):
    from tests.test_cpp_serving import _build_cpp

    return _build_cpp(tmp_path_factory.mktemp("cppbuild"))


@pytest.mark.slow
def test_cpp_asr_client_against_port_server(cpp_build, tmp_path):
    """``asr_client`` (VAD, encode, CTC and translate through the wire)
    against the port's offline ops with the energy VAD."""
    _, _, tmodel = tiny_conformer()
    engine = ASREngine(tmodel, chunk_seconds=0.5, sample_rate=SR)
    server = tms.ModelServer(tms.build_asr_ops(engine), tcp_port=0)
    server.start()
    try:
        client = tms.ModelClient(tcp_port=server.tcp_port)
        try:
            assert client.call("info")[0][0] == engine.chunk_samples
            enc = client.call("encode", np.zeros((1, 8000), np.float32))[0]
            assert enc.shape == (engine.chunk_frames + 1, 32)
            assert client.call("ctc_logits", enc)[0].shape == (
                engine.chunk_frames + 1, 8)
        finally:
            client.close()
        phone_vocab = tmp_path / "phones.txt"
        phone_vocab.write_text("\n".join(f"p{i}" for i in range(7)),
                               encoding="utf-8")
        char_vocab = tmp_path / "chars.txt"
        char_vocab.write_text(
            "\n".join(["<S>", "</S>"] + [f"c{i}" for i in range(9)]),
            encoding="utf-8")
        wav = np.concatenate([np.zeros(SR // 2, np.float32),
                              _sine(300, 1.5, amp=0.6),
                              np.zeros(SR, np.float32)])
        wav_path = tmp_path / "utt.wav"
        write_wav(str(wav_path), wav, SR)
        out = subprocess.run(
            [os.path.join(cpp_build, "asr_client"),
             f"127.0.0.1:{server.tcp_port}", str(phone_vocab),
             str(char_vocab), str(wav_path)],
            capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        assert "[start]" in out.stdout, (out.stdout, out.stderr)
        assert "[end]" in out.stdout or "[final]" in out.stdout, out.stdout
    finally:
        server.stop()


@pytest.mark.slow
def test_cpp_asr_stream_against_port_server(cpp_build, chunk_model,
                                            tmp_path):
    """Two ``asr_stream`` processes stream different wavs through the port's
    slot pool; each ``[final]`` equals its independent session's text."""
    tokens = ["<S>", "</S>"] + [f"c{i}" for i in range(N_CHAR - 3)]
    char_vocab = tmp_path / "chars.txt"
    char_vocab.write_text("\n".join(tokens), encoding="utf-8")
    cs = chunk_model.cfg.chunk_samples
    paths, expected = [], []
    for i, n in enumerate([3 * cs, 2 * cs + cs // 2]):
        p = tmp_path / f"utt{i}.wav"
        write_wav(str(p), speech(n / SR, seed=90 + i), SR)
        paths.append(p)
        # the session hears what the C++ host reads: the 16-bit file
        out = sessions(chunk_model, [read_wav(str(p), SR)[0]])[0]
        expected.append("".join(tokens[i] for i in out["char_ids"]
                                if i < len(tokens)
                                and tokens[i] not in ("<S>", "</S>")))
    front = BatchingStreamFront(
        MultiStreamChunkServer(chunk_model, n_slots=2, device="cpu"),
        max_wait_ms=5.0)
    ops = build_stream_ops(front)
    server = tms.ModelServer(ops, tcp_port=0, inline_exec=False,
                             inline_ops=set(ops))
    server.start()
    try:
        procs = [subprocess.Popen(
            [os.path.join(cpp_build, "asr_stream"),
             f"127.0.0.1:{server.tcp_port}", str(char_vocab), str(p)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for p in paths]
        for proc, want in zip(procs, expected):
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err
            final = [ln for ln in out.splitlines() if ln.startswith("[final]")]
            assert final and final[0] == f"[final] {want}", (out, want)
    finally:
        server.stop()
        front.shutdown()
