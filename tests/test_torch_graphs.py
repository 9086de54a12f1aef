"""The Conformer's leaf stages as CUDA graphs (``models/graphs.py``), on the
CPU: when a stage may replay (each condition of ``may_replay``), that no
stage captures here and each gives what its eager body gives, bit for bit,
recording ``conformer.graph`` 0 once a call; and the bookkeeping of a
stage's graphs (a signature's first call eager, its second eager then
captured, replays after it, the caps, training mode and moves dropping
them, copies starting empty) with a stand-in for the capture or for the
card's graph calls. The card's own tests are in
``tests/test_torch_graphs_cuda.py``."""

import contextlib
import copy
import io
import types

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import graphs, layers
from tensorflowasr_tpu_torch.models.ebranchformer import (
    EBranchformerConfig,
)
from tensorflowasr_tpu_torch.ops import frontend as fe
from tensorflowasr_tpu_torch.serve.engines import predict_step
from tensorflowasr_tpu_torch.utils import telemetry

SR = 16000
N_PHONE, N_CHAR = 11, 17
TINY = dict(dmodel=16, num_blocks=2, head_size=8, num_heads=2,
            kernel_size=4, ctcdecoder_num_blocks=1, ctcdecoder_kernel_size=4,
            translator_num_blocks=1, translator_kernel_size=4, dropout=0.0,
            ctcdecoder_dropout=0.0, translator_dropout=0.0)


@pytest.fixture(autouse=True)
def fresh_recorder():
    telemetry.reset()
    yield
    telemetry.reset()


def model(**extra):
    return tconf.build_model(tconf.ConformerConfig(**{**TINY, **extra}),
                             N_PHONE, N_CHAR, device="cpu", seed=3)


def batch(b=2, seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    wav = torch.from_numpy((0.1 * rng.standard_normal(
        (b, int(seconds * SR)))).astype(np.float32))
    return wav, torch.full((b,), int(seconds * 25), dtype=torch.int32)


def graph_records():
    return telemetry.between("conformer.graph")[:, 1].tolist()


# -- when a stage may replay ---------------------------------------------------

@pytest.fixture()
def on_card(monkeypatch):
    """A stand-in input on a card, no capture in progress, nothing
    compiling: ``may_replay`` reads only these."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: False)
    return types.SimpleNamespace(is_cuda=True)


def test_may_replay_on_a_card_in_eval_without_gradients(on_card):
    stage = tconf.CTCDecoder(tconf.ConformerConfig(**TINY), N_PHONE).eval()
    with torch.no_grad():
        assert graphs.may_replay(stage, on_card)
    with torch.inference_mode():
        assert graphs.may_replay(stage, on_card)


@pytest.mark.parametrize("condition", [
    "device", "gradient", "mode", "capture_in_progress", "compiling"])
def test_may_replay_refuses(condition, on_card, monkeypatch):
    stage = tconf.CTCDecoder(tconf.ConformerConfig(**TINY), N_PHONE).eval()
    x, grad = on_card, False
    if condition == "device":
        x = torch.zeros(1)
    elif condition == "gradient":
        grad = True
    elif condition == "mode":
        stage.train()
    elif condition == "capture_in_progress":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
    else:
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with torch.set_grad_enabled(grad):
        assert not graphs.may_replay(stage, x)


def test_may_replay_is_false_while_torch_export_traces(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    on_card = types.SimpleNamespace(is_cuda=True)
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            # only the export's own flag can refuse the stand-in
            seen.append((torch.compiler.is_compiling(),
                         graphs.may_replay(self, on_card)))
            return x * 2

    probe = Probe().eval()
    with torch.no_grad():
        assert graphs.may_replay(probe, on_card)
        torch.export.export(probe, (torch.ones(3),), strict=False)
    assert seen == [(True, False)]


# -- on the CPU: the eager bodies, bit for bit --------------------------------

@pytest.mark.parametrize("extra", [{}, {"add_wav_info": True}],
                         ids=["conformer", "add_wav_info"])
def test_cpu_stages_equal_their_eager_bodies(extra):
    m = model(**extra)
    wav, lengths = batch()
    with torch.no_grad():
        phones, phone_lens, chars = predict_step(m, wav, lengths)
        mel = m.encoder.mel_layer(fe.wav_to_float(wav))
        enc_body = m.encoder._stack_body(
            mel, *(() if m.encoder.wav_layer is None else (wav,)))
        enc = m.encode(wav)
        logits = m.ctc_logits(enc)
        ids = torch.nn.functional.pad(phones, (0, 10))
        char_logits = m.translate(ids, enc)
        assert torch.equal(enc, enc_body)
        assert torch.equal(logits, m.ctc_decoder._body(enc))
        assert torch.equal(char_logits, m.translator._body(ids, enc))
        assert torch.equal(chars, torch.argmax(
            char_logits, -1).to(torch.int32))
    assert all(not s.stage_graphs.graphs for s in
               (m.encoder, m.ctc_decoder, m.translator))


def test_cpu_predict_step_records_zero_once_a_stage_call():
    m = model()
    wav, lengths = batch()
    predict_step(m, wav, lengths)
    predict_step(m, wav, lengths)
    assert graph_records() == [0.0] * 6
    rec = telemetry.between("conformer.graph")
    for name in ("conformer.stack", "conformer.ctc_head",
                 "conformer.translator"):
        spans = telemetry.between(name)
        assert len(spans) == 2
        # each stage's record lies inside its span
        assert all(((rec[:, 0] >= s) & (rec[:, 0] <= e)).sum() == 1
                   for s, e in spans)


def test_training_forward_records_zero_for_each_stage_call():
    m = model().train()
    wav, lengths = batch()
    phones = torch.ones((2, 3), dtype=torch.int32)
    m.train_forward(wav, phones, lengths)
    # one stack, one CTC head, two translator passes
    assert graph_records() == [0.0] * 4


def test_block_streaming_encoder_records_one_stack_call():
    m = model(streaming=True)
    wav = torch.zeros((1, 3 * m.cfg.chunk_samples))
    with torch.no_grad():
        enc = m.encode(wav)
    assert enc.shape[1] == 3 * m.cfg.chunk_samples // (
        m.cfg.hop_size * m.cfg.reduction_factor)
    assert graph_records() == [0.0]


def test_ebranchformer_heads_record_and_its_stack_does_not():
    cfg = EBranchformerConfig(**{**TINY, "num_blocks": 1},
                              linear_units=32, cgmlp_linear_units=32,
                              cgmlp_conv_kernel=3, merge_conv_kernel=3)
    m = tconf.build_model(cfg, N_PHONE, N_CHAR, device="cpu", seed=1)
    wav, lengths = batch()
    predict_step(m, wav, lengths)
    assert graph_records() == [0.0, 0.0]
    assert len(telemetry.between("conformer.stack")) == 0


# -- the bookkeeping, with a stand-in capture ----------------------------------

class FakeGraph:
    """What ``StageGraphs._capture`` returns, on the CPU: a replay runs the
    captured body on the new inputs and counts itself."""

    def __init__(self, body):
        self.body = body
        self.replays = 0

    def run(self, name, inputs, done):
        assert done is None          # no event: the stand-in made no pool
        self.replays += 1
        with graphs._span(name):
            telemetry.count(graphs.COUNTER, 1, shared=True)
            return self.body(*inputs).clone()


@pytest.fixture()
def stand_in(monkeypatch):
    captured = []

    def capture(self, body, inputs):
        captured.append(tuple(t.shape for t in inputs))
        return FakeGraph(body)

    monkeypatch.setattr(graphs, "may_replay", lambda module, x: True)
    monkeypatch.setattr(graphs.StageGraphs, "_capture", capture)
    return captured


@pytest.fixture()
def card_calls(monkeypatch):
    """The card's graph calls as stand-ins that run the captured body
    eagerly, so that ``StageGraphs._capture`` itself runs on the CPU."""

    @contextlib.contextmanager
    def graph(cuda_graph, pool=None, capture_error_mode=None):
        yield

    class Stub:
        def replay(self):
            pass

        def record(self):
            pass

        def wait_event(self, event):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Stub)
    monkeypatch.setattr(torch.cuda, "Event", Stub)
    monkeypatch.setattr(torch.cuda, "current_stream", Stub)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    monkeypatch.setattr(torch.cuda, "graph", graph)


def test_first_call_is_eager_then_captured_then_replayed(stand_in):
    m = model()
    enc = torch.randn(2, 7, 16)
    first = m.ctc_logits(enc)
    assert stand_in == [] and not m.ctc_decoder.stage_graphs.graphs
    second = m.ctc_logits(enc - 1)       # the second call: eager, captured
    third = m.ctc_logits(enc + 1)
    (graph,) = m.ctc_decoder.stage_graphs.graphs.values()
    assert stand_in == [((2, 7, 16),)] and graph.replays == 1
    assert torch.equal(first, m.ctc_decoder._body(enc))
    assert torch.equal(second, m.ctc_decoder._body(enc - 1))
    assert torch.equal(third, m.ctc_decoder._body(enc + 1))
    assert graph_records() == [0.0, 0.0, 1.0]
    # every call inside its own span, the replay's too
    assert len(telemetry.between("conformer.ctc_head")) == 3


def test_the_second_call_captures_after_its_eager_body(monkeypatch):
    order = []

    def capture(self, body, inputs):
        order.append("capture")
        return FakeGraph(body)

    def body(x):
        order.append("body")
        return x + 1

    monkeypatch.setattr(graphs, "may_replay", lambda module, x: True)
    monkeypatch.setattr(graphs.StageGraphs, "_capture", capture)
    stage = tconf.CTCDecoder(tconf.ConformerConfig(**TINY), N_PHONE).eval()
    for _ in range(3):
        stage.stage_graphs(stage, "conformer.ctc_head", body,
                           (torch.zeros(1, 3, 16),))
    # the eager warm-up fills the caches the capture then reads
    assert order == ["body", "body", "capture", "body"]


def test_a_replay_opens_a_range_no_trace_reduction_credits(card_calls,
                                                          monkeypatch):
    opened = []

    def record_function(name):
        opened.append(name)
        return contextlib.nullcontext()

    monkeypatch.setattr(telemetry, "_record_function", record_function)
    monkeypatch.setattr(graphs, "may_replay", lambda module, x: True)
    stage = tconf.CTCDecoder(tconf.ConformerConfig(**TINY), N_PHONE).eval()
    x = torch.randn(1, 4, 16)
    with torch.no_grad(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            stage(x)
    # eager, eager then captured, a replay (its copy-in and clone inside)
    assert opened == ["tasr::conformer.ctc_head"] * 2 + [
        "tasr.conformer.ctc_head"]
    assert graph_records() == [0.0, 0.0, 1.0]
    assert len(telemetry.between("conformer.ctc_head")) == 3


def test_a_signature_seen_once_is_never_captured(stand_in):
    m = model()
    for t in range(1, 40):
        m.ctc_decoder(torch.zeros(1, t, 16))
    assert stand_in == [] and not m.ctc_decoder.stage_graphs.graphs
    assert len(m.ctc_decoder.stage_graphs.seen) == 39


def test_a_stage_remembers_at_most_max_seen_signatures(stand_in,
                                                        monkeypatch):
    monkeypatch.setattr(graphs, "MAX_SEEN", 4)
    stage = model().ctc_decoder
    for t in range(1, 6):                    # 1 is forgotten for 5
        stage(torch.zeros(1, t, 16))
    assert len(stage.stage_graphs.seen) == 4
    stage(torch.zeros(1, 1, 16))             # a first call again
    stage(torch.zeros(1, 5, 16))             # a second: captured
    assert stand_in == [((1, 5, 16),)]


def test_a_capture_under_inference_mode_replays_under_no_grad(card_calls):
    stage = tconf.CTCDecoder(tconf.ConformerConfig(**TINY), N_PHONE).eval()
    x = torch.randn(1, 4, 16)
    with torch.inference_mode():
        graph = stage.stage_graphs._capture(stage._body, (x,))
    (static,) = graph.inputs
    assert not static.is_inference()
    with torch.no_grad():
        static.copy_(x + 1)                  # what a replay does first
    assert torch.equal(static, x + 1)



def test_signatures_are_shapes_dtypes_and_devices(stand_in):
    m = model()
    for _ in range(2):
        for x in (torch.zeros(1, 5, 16), torch.zeros(1, 6, 16),
                  torch.zeros(2, 5, 16), torch.zeros(1, 5, 16,
                                                     dtype=torch.float64)):
            m.ctc_decoder.stage_graphs(m.ctc_decoder, "conformer.ctc_head",
                                       lambda t: t + 1, (x,))
    m.ctc_decoder.stage_graphs(m.ctc_decoder, "conformer.ctc_head",
                               lambda t: t + 1, (torch.zeros(1, 5, 16),))
    assert len(stand_in) == 4
    assert graph_records() == [0.0] * 8 + [1.0]


def test_seventeenth_signature_runs_eagerly(stand_in):
    m = model()
    stage = m.ctc_decoder
    for t in range(1, graphs.MAX_SIGNATURES + 2):
        stage(torch.zeros(1, t, 16))
        stage(torch.zeros(1, t, 16))
    assert len(stand_in) == len(stage.stage_graphs.graphs) == \
        graphs.MAX_SIGNATURES
    stage(torch.zeros(1, graphs.MAX_SIGNATURES + 1, 16))   # again: eager
    stage(torch.zeros(1, 1, 16))                           # a replay
    assert graph_records() == \
        [0.0] * (2 * graphs.MAX_SIGNATURES + 3) + [1.0]


def test_training_mode_and_moves_drop_the_graphs(stand_in):
    m = model()
    wav, lengths = batch()
    stages = (m.encoder, m.ctc_decoder, m.translator)
    predict_step(m, wav, lengths)
    predict_step(m, wav, lengths)
    assert all(len(s.stage_graphs.graphs) == 1 for s in stages)
    m.eval()                                    # staying in eval keeps them
    assert all(len(s.stage_graphs.graphs) == 1 for s in stages)
    m.train()
    assert all(not s.stage_graphs.graphs and not s.stage_graphs.seen
               for s in stages)
    m.eval()
    predict_step(m, wav, lengths)
    predict_step(m, wav, lengths)
    m.to("cpu")
    assert all(not s.stage_graphs.graphs and not s.stage_graphs.seen
               for s in stages)


def test_copies_and_pickles_start_empty(stand_in):
    m = model()
    wav, lengths = batch()
    predict_step(m, wav, lengths)
    predict_step(m, wav, lengths)
    twin = copy.deepcopy(m)
    buf = io.BytesIO()
    torch.save(m, buf)
    buf.seek(0)
    loaded = torch.load(buf, weights_only=False)
    for other in (twin, loaded):
        for a, b in zip((m.encoder, m.ctc_decoder, m.translator),
                        (other.encoder, other.ctc_decoder,
                         other.translator)):
            assert a.stage_graphs.graphs and not b.stage_graphs.graphs
            assert b.stage_graphs.lock is not a.stage_graphs.lock
    with torch.no_grad():
        assert torch.equal(twin.encode(wav), m.encode(wav))


def test_collect_constants_gathers_cached_tables_inside_the_block():
    table = layers._pe_table(3, 4, torch.device("cpu"))
    with layers.collect_constants() as outer:
        with layers.collect_constants() as inner:
            layers._pe_table(3, 4, torch.device("cpu"))
        layers._pe_table(3, 4, torch.device("cpu"))
    layers._pe_table(3, 4, torch.device("cpu"))
    assert [t is table for t in inner] == [True]
    assert [t is table for t in outer] == [True]


def test_a_capture_of_the_translator_holds_its_position_table(card_calls):
    m = model()
    ids = torch.ones((2, 6), dtype=torch.int32)
    enc = torch.randn(2, 5, 16)
    with torch.no_grad():
        graph = m.translator.stage_graphs._capture(m.translator._body,
                                                   (ids, enc))
    # one RBlock: its cached [6, 16] table, the very tensor of the cache
    (table,) = graph.held
    assert table is layers._pe_table(6, 16, torch.device("cpu"))
