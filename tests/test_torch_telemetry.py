"""The port's recorder (``utils/telemetry.py``): rings of a fixed size that
keep no Python object a record, the records each instrumented layer makes
(the stream pool's dispatches and their phases, both train steps' phases,
the file engine's pieces, the Conformer's stage ranges in a profiler's
trace) and what ``fit`` writes of them."""

import contextlib
import gc
import itertools
import json
import sys
import threading

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch.models import chunk_conformer as tcc
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models.layers import set_generator
from tensorflowasr_tpu_torch.serve.engines import ASREngine, predict_step
from tensorflowasr_tpu_torch.serve.multi_session import MultiStreamChunkServer
from tensorflowasr_tpu_torch.serve.offline_session import OfflineASRSession
from tensorflowasr_tpu_torch.train import asr_trainer as ttrain
from tensorflowasr_tpu_torch.train import chunk_trainer as tct
from tensorflowasr_tpu_torch.train import state as tstate
from tensorflowasr_tpu_torch.utils import telemetry

SR = 16000
STAGES = ("forward", "loss", "backward", "optimizer")
N_PHONE, N_CHAR = 11, 17
TINY = dict(dmodel=16, num_blocks=1, head_size=8, num_heads=2,
            kernel_size=4, ctcdecoder_num_blocks=1, ctcdecoder_kernel_size=4,
            translator_num_blocks=1, translator_kernel_size=4, dropout=0.0,
            ctcdecoder_dropout=0.0, translator_dropout=0.0)
STACK = tcc.ChunkStackConfig(dmodel=16, num_blocks=1, head_size=8,
                             num_heads=2, kernel_size=4, win_front=6)


@pytest.fixture(autouse=True)
def fresh_recorder():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture()
def clock(monkeypatch):
    """The recorder's clock reading 0, 1, 2, ... a call."""
    ticks = itertools.count()
    monkeypatch.setattr(telemetry, "_clock", lambda: float(next(ticks)))


def tones(n, seed=0):
    """``n`` samples of three seeded tones."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f = rng.uniform(150, 900, 3)
    return (0.3 * np.sin(2 * np.pi * f[:, None] * t).sum(0)
            ).astype(np.float32)


def chunk_model():
    cfg = tcc.ChunkConformerConfig(
        dmodel=16, encoder=STACK, picker=STACK,
        decoder=tcc.ChunkStackConfig(**{**STACK.__dict__, "win_back": 2}),
        helper=STACK)
    return tcc.build_chunk_model(cfg, N_PHONE, N_CHAR, device="cpu")


def conformer_model():
    return tconf.build_model(tconf.ConformerConfig(**TINY), N_PHONE, N_CHAR,
                             device="cpu")


# -- the rings ------------------------------------------------------------------

def test_ring_keeps_the_newest_records_and_between_selects_by_start(clock):
    rec = telemetry.Recorder()
    n = telemetry.RING + 10
    for i in range(n):
        rec.count("c", float(i))              # counted at clock i
    kept = rec.between("c")
    assert kept.shape == (telemetry.RING, 2)
    assert kept[0].tolist() == [10.0, 10.0]
    assert kept[-1].tolist() == [n - 1.0, n - 1.0]
    assert rec.between("c", 100, 200)[:, 1].tolist() == list(range(100, 200))
    assert rec.between("c", n, n + 5).shape == (0, 2)
    assert rec.between("unknown").shape == (0, 2)

    with rec.span("s"):                       # n .. n + 3
        with rec.span("s"):                   # n + 1 .. n + 2
            pass
    spans = rec.between("s")
    assert spans.tolist() == [[n, n + 3.0], [n + 1.0, n + 2.0]]
    assert rec.between("s", n + 1, n + 2).tolist() == [[n + 1.0, n + 2.0]]
    summary = rec.summary(n - 5, n + 10)
    assert summary["c"] == {"count": 5, "sum": float(sum(range(n - 5, n)))}
    assert summary["s"]["count"] == 2
    assert summary["s"]["median_ms"] == pytest.approx(2000.0)
    assert summary["s"]["p95_ms"] == pytest.approx(2900.0)
    assert rec.summary(0, 5) == {}            # overwritten
    assert rec.summary(10, 12) == {"c": {"count": 2, "sum": 21.0}}


def test_a_record_keeps_no_python_object():
    rec = telemetry.Recorder()
    names = ("s", "shared", "c")

    def record():
        with rec.span("s"):
            pass
        with rec.span("shared", shared=True):
            pass
        rec.count("c", 2.0)

    record()
    gc.collect()
    before = len(gc.get_objects())
    for _ in range(34_000):
        record()
    grown = len(gc.get_objects()) - before
    assert grown <= 50, grown
    assert [rec.summary()[n]["count"] for n in names] == [34_001] * 3


def test_a_shared_name_loses_no_record_across_threads():
    rec = telemetry.Recorder()
    n_threads, each = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with rec.span("shared", shared=True):
                    pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = rec.between("shared")
    assert len(got) == n_threads * each
    assert np.all(got[:, 1] >= got[:, 0]) and np.all(got[:, 0] > 0)


def test_a_shared_counter_loses_no_record_across_threads():
    rec = telemetry.Recorder()
    n_threads, each = 8, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(each):
                rec.count("pieces", k, shared=True)

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(1, n_threads + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = rec.between("pieces")
    assert len(got) == n_threads * each
    assert got[:, 1].sum() == each * n_threads * (n_threads + 1) / 2
    assert rec.summary()["pieces"]["count"] == n_threads * each


def test_no_record_function_without_a_profiler(monkeypatch):
    opened = []

    def record_function(name):
        opened.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(telemetry, "_record_function", record_function)
    with telemetry.span("pool.stage"):
        pass
    with telemetry.span("conformer.stack", leaf=True):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with telemetry.span("pool.stage"):
            pass
        with telemetry.span("conformer.stack", leaf=True):
            pass
    assert opened == ["tasr.pool.stage", "tasr::conformer.stack"]
    assert len(telemetry.between("pool.stage")) == 2


def test_an_unlinked_leaf_span_opens_a_plain_range(monkeypatch):
    opened = []

    def record_function(name):
        opened.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(telemetry, "_record_function", record_function)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with telemetry.span("conformer.stack", leaf=True):
            pass
        with telemetry.span("conformer.stack", leaf=True, linked=False):
            pass
    # one name, one ring: the range's name alone differs
    assert opened == ["tasr::conformer.stack", "tasr.conformer.stack"]
    assert len(telemetry.between("conformer.stack")) == 2


# -- the layers' records --------------------------------------------------------

def test_pool_records_a_ticks_dispatches_and_their_phases():
    pool = MultiStreamChunkServer(chunk_model(), n_slots=1, device="cpu")
    slot = pool.open()
    pool.feed(slot, tones(3 * pool.cfg.chunk_samples))
    pool.tick()
    pool.tick()                               # dispatches nothing
    assert telemetry.between("pool.dispatches")[:, 1].tolist() == [3.0]
    phases = [telemetry.between(f"pool.{p}")
              for p in ("stage", "enqueue", "fetch", "unpack")]
    assert [len(p) for p in phases] == [3, 3, 3, 3]
    starts = np.stack([p[:, 0] for p in phases], 1).ravel()
    assert np.all(np.diff(starts) > 0)        # in order, dispatch by dispatch
    pool.close(slot)                          # nothing left to drain
    assert len(telemetry.between("pool.dispatches")) == 1


def _ctc_trainer(tmp_path):
    config = {"model_config": TINY, "speech_config": {},
              "optimizer_config": {"lr": 5e-3},
              "running_config": {"outdir": str(tmp_path),
                                 "log_interval_steps": 2,
                                 "save_interval_steps": 100,
                                 "eval_interval_steps": 1000}}
    trainer = ttrain.CTCTrainer(config, N_PHONE, N_CHAR, N_PHONE - 1,
                                device="cpu")
    trainer.init_state(seed=0)
    return trainer


def _ctc_batch():
    wav = np.stack([tones(SR, 1), tones(SR, 2)])
    return {"wav": wav, "input_length": np.array([25, 12], np.int32),
            "phones": np.array([[1, 2, 3], [4, 5, 6]], np.int32),
            "phone_length": np.array([3, 3], np.int32),
            "chars": np.array([[2, 3, 1], [4, 5, 1]], np.int32),
            "char_length": np.array([3, 3], np.int32)}


def _chunk_batch(chunk_samples, n_chunks=3):
    wav = np.stack([tones(n_chunks * chunk_samples, s) for s in (3, 4)])
    batch = {"wav": wav,
             "input_length": np.array([4 * n_chunks, 4 * n_chunks - 4],
                                      np.int32)}
    for key, ids in (("phones", [1, 2, 3, 4]), ("chars", [2, 3, 1]),
                     ("extra_phones", [5, 6, 7]), ("extra_chars", [4, 2])):
        batch[key] = np.array([ids, ids], np.int32)
        batch[key[:-1] + "_length"] = np.array([len(ids)] * 2, np.int32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _chunk_state():
    model = chunk_model()
    gen = torch.Generator().manual_seed(1)
    set_generator(model, gen)
    return tstate.ASRTrainState(
        model, tstate.make_optimizer(model.parameters(), {"lr": 3e-3}), gen)


@pytest.mark.parametrize("kind", ["ctc", "chunk"])
def test_train_steps_record_their_four_phases_and_still_mark(kind, tmp_path):
    marks = []
    if kind == "ctc":
        trainer = _ctc_trainer(tmp_path)
        state = trainer.state
        batch = trainer._prepare_batch(_ctc_batch())
        step = ttrain.make_train_step(trainer.blank_id, mark=marks.append)
    else:
        state = _chunk_state()
        batch = _chunk_batch(state.model.cfg.chunk_samples)
        step = tct.make_chunk_train_step(max_pick=8, mark=marks.append)
    for _ in range(2):
        state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["train_loss"]))
    assert marks == list(STAGES) * 2
    spans = [telemetry.between(f"step.{s}") for s in STAGES]
    assert [len(s) for s in spans] == [2, 2, 2, 2]
    for call in range(2):
        starts = [s[call, 0] for s in spans]
        assert starts == sorted(starts)
        # the phases follow one another without overlapping
        assert all(spans[i][call, 1] <= spans[i + 1][call, 0]
                   for i in range(3))


def test_fit_logs_unpadded_audio_and_the_recorders_summary(tmp_path):
    trainer = _ctc_trainer(tmp_path)
    batch = _ctc_batch()
    trainer.fit(itertools.repeat(batch), total_steps=4)
    lines = [json.loads(line) for line in
             (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [2, 4]
    for m in lines:
        # 37 of the batch's 50 frames of 640 samples are audio
        assert m["audio_seconds_unpadded_per_s"] == pytest.approx(
            m["audio_seconds_per_s"] * 37 * 640 / (2 * SR))
        rec = m["telemetry"]
        for s in STAGES:
            assert rec[f"step.{s}"]["count"] == 2
            assert rec[f"step.{s}"]["p95_ms"] >= \
                rec[f"step.{s}"]["median_ms"] > 0
        # train forward: one stack, one CTC head, two translator passes
        assert rec["conformer.stack"]["count"] == 2
        assert rec["conformer.translator"]["count"] == 4


def test_engine_records_each_piece_and_one_decode():
    engine = ASREngine(conformer_model(), chunk_seconds=0.5)
    session = OfflineASRSession(engine)
    wav = tones(2 * SR)                       # 4 pieces of 7680, one of 1280
    segs = session.transcribe_wav(wav)
    assert isinstance(segs[0]["text"], str)
    # the 5 pieces in one encode of 8 rows (whole groups of pad_chunks 4)
    (s, e), = telemetry.between("engine.encode")
    (at, pieces), = telemetry.between("engine.pieces")
    assert pieces == -(-len(wav) // engine.chunk_samples) == 5
    assert s <= at <= e
    decode = telemetry.between("engine.decode")
    assert len(decode) == 1
    # the encode runs the stack once; the decode runs both heads inside
    assert len(telemetry.between("conformer.stack")) == 1
    for head in ("conformer.ctc_head", "conformer.translator"):
        (s, e), = telemetry.between(head)
        assert decode[0, 0] <= s and e <= decode[0, 1]


def test_engine_single_chunk_is_one_encode_without_pieces():
    engine = ASREngine(conformer_model(), chunk_seconds=0.5)
    assert engine.encode_pieces([]) == []         # a segment with no piece
    rows = engine.extract_feature(tones(engine.chunk_samples))
    assert rows.shape[0] == engine.chunk_frames
    assert len(telemetry.between("engine.encode")) == 1
    assert len(telemetry.between("conformer.stack")) == 1
    assert len(telemetry.between("engine.pieces")) == 0


def test_stage_ranges_are_leaves_in_a_trace():
    model = conformer_model()
    wav = torch.from_numpy(np.stack([tones(SR, 5), tones(SR, 6)]))
    lengths = torch.tensor([25, 20], dtype=torch.int32)
    predict_step(model, wav, lengths)         # warm
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        predict_step(model, wav, lengths)
    events = [(e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()]
    tasr = [e for e in events if e[2].startswith("tasr::")]
    stages = [e for e in tasr if e[2].startswith("tasr::conformer.")]
    assert sorted(e[2] for e in stages) == [
        "tasr::conformer.ctc_head", "tasr::conformer.stack",
        "tasr::conformer.translator"]
    assert any(e[2] == "tasr::log_mel_spectrogram" for e in tasr)
    for s, e, name, thread in stages:
        inside = [o[2] for o in tasr if o[3] == thread and o[2] != name
                  and s <= o[0] <= e]
        assert inside == [], (name, inside)
    mel = min(o[0] for o in tasr if o[2] == "tasr::log_mel_spectrogram")
    stack = [o for o in stages if o[2] == "tasr::conformer.stack"][0]
    assert mel < stack[0]
