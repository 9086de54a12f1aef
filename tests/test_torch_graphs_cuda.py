"""The Conformer's leaf stages replayed as CUDA graphs (``models/graphs.py``)
against their eager bodies, on the card. These tests import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs_cuda.py

Without a CUDA card they skip. The eager side is the same module with
``graphs.may_replay`` answering no, so it runs each stage's body as the CPU
does; the graphed side calls a shape twice (eager, then eager and
captured) and compares its replays.
"""

import threading

import numpy as np
import pytest
import torch

from tensorflowasr_tpu_torch.export.exporter import (
    export_offline_asr,
    load_exported,
)
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import graphs
from tensorflowasr_tpu_torch.serve.engines import ASREngine, phone_decoder
from tensorflowasr_tpu_torch.testing import N_CHAR, N_PHONE, SR, shipped_config
from tensorflowasr_tpu_torch.utils import telemetry

DECODE_B = 32
BUCKETS = (4, 8, 12, 16)               # seconds, the decode cell's buckets
PIECES = (3, 10)                       # request pieces: rows 4 and 12
TINY = dict(dmodel=16, num_blocks=2, head_size=8, num_heads=2,
            kernel_size=4, ctcdecoder_num_blocks=1, ctcdecoder_kernel_size=4,
            translator_num_blocks=1, translator_kernel_size=4, dropout=0.0,
            ctcdecoder_dropout=0.0, translator_dropout=0.0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def fresh_recorder():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture(scope="module")
def conformer_s():
    """The shipped ConformerCTC(S) in bf16 on the card, seeded weights."""
    _card()
    cfg = tconf.ConformerConfig.from_user_config(shipped_config(),
                                                 "bfloat16")
    return tconf.build_model(cfg, N_PHONE, N_CHAR, device="cuda", seed=0)


def tiny(seed=0):
    return tconf.build_model(tconf.ConformerConfig(**TINY), 11, 17,
                             device="cuda", seed=seed)


def noise(shape, seed):
    return torch.from_numpy((0.1 * np.random.default_rng(seed)
                             .standard_normal(shape)).astype(np.float32))


def eager(monkeypatch, fn):
    """``fn()`` with every stage running its eager body."""
    with monkeypatch.context() as m:
        m.setattr(graphs, "may_replay", lambda module, x: False)
        return fn()


def graph_records():
    return telemetry.between("conformer.graph")[:, 1].tolist()


def close(got, want):
    """Within bf16 rounding of the largest entry."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max()) or 1.0
    assert float((got - want).abs().max()) <= 2 ** -7 * scale


@torch.no_grad()
def stages(model, wav, lengths):
    """``engines.predict_step``'s stages, keeping the logits: (enc, CTC
    logits, phone ids, phone lengths, char logits)."""
    enc = model.encode(wav, lengths)
    logits = model.ctc_logits(enc)
    ids, lens = phone_decoder(model.num_phone_classes - 1,
                              model.num_phone_classes)(logits, lengths)
    chars = model.translate(torch.nn.functional.pad(ids, (0, 10)), enc)
    return enc, logits, ids, lens, chars


@pytest.mark.cuda
@pytest.mark.parametrize("seconds", BUCKETS)
def test_decode_bucket_replays_as_its_eager_bodies(conformer_s, seconds,
                                                   monkeypatch):
    wav = noise((DECODE_B, seconds * SR), seconds).cuda()
    lengths = torch.full((DECODE_B,), seconds * 25, dtype=torch.int32,
                         device="cuda")
    want = eager(monkeypatch, lambda: stages(conformer_s, wav, lengths))
    for _ in range(2):                           # eager, then captured
        stages(conformer_s, wav, lengths)
    telemetry.reset()
    got = stages(conformer_s, wav, lengths)
    assert graph_records() == [1.0, 1.0, 1.0]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    close(got[0], want[0])
    close(got[1], want[1])
    close(got[4], want[4])
    # the served ids
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert torch.equal(got[4].argmax(-1), want[4].argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("n_pieces", PIECES)
def test_request_encode_and_decode_replay_as_their_eager_bodies(
        conformer_s, n_pieces, monkeypatch):
    engine = ASREngine(conformer_s, chunk_seconds=0.5)
    pieces = [noise(engine.chunk_samples, 100 + i).numpy()
              for i in range(n_pieces)]
    pieces[-1] = pieces[-1][:3000]
    want_enc = eager(monkeypatch, lambda: engine.encode_pieces(pieces))
    want_dec = eager(monkeypatch, lambda: engine._decode(want_enc, 4))
    for _ in range(2):                           # eager, then captured
        engine.encode_pieces(pieces)
        engine._decode(want_enc, 4)
    telemetry.reset()
    got_enc = engine.encode_pieces(pieces)
    got_dec = engine._decode(want_enc, 4)
    assert graph_records() == [1.0, 1.0, 1.0]
    for g, w in zip(got_enc, want_enc):
        close(torch.from_numpy(g), torch.from_numpy(w))
    for g, w in zip(got_dec, want_dec):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_a_replay_returns_its_own_inputs_outputs_and_keeps_the_last():
    _card()
    m = tiny()
    head = m.ctc_decoder
    x1, x2 = noise((2, 9, 16), 1).cuda(), noise((2, 9, 16), 2).cuda()
    with torch.no_grad():
        head(x1)
        head(x1)                                   # eager, then captured
        first = head(x1)
        kept = first.clone()
        second = head(x2)
        want1, want2 = head._body(x1), head._body(x2)
    assert graph_records() == [0.0, 0.0, 1.0, 1.0]
    close(first, want1)
    close(second, want2)
    assert not torch.equal(first, second)
    assert torch.equal(first, kept)
    assert first.data_ptr() != second.data_ptr()


@pytest.mark.cuda
def test_a_weight_changed_in_place_is_read_by_the_next_replay():
    _card()
    m = tiny()
    x = noise((2, 9, 16), 3).cuda()
    with torch.no_grad():
        m.ctc_logits(x)
        m.ctc_logits(x)
        before = m.ctc_logits(x)
        m.ctc_decoder.fully_connected.bias.add_(1.0)
        m.ctc_decoder.project.weight.mul_(0.5)
        after = m.ctc_logits(x)
        want = m.ctc_decoder._body(x)
    assert graph_records() == [0.0, 0.0, 1.0, 1.0]
    assert float((after - before).abs().max()) > 0.5
    close(after, want)


@pytest.mark.cuda
def test_training_gradients_and_a_seventeenth_signature_run_eagerly():
    _card()
    m = tiny()
    head = m.ctc_decoder
    x = noise((1, 5, 16), 4).cuda()
    with torch.no_grad():
        for _ in range(3):
            head(x)
    assert len(head.stage_graphs.graphs) == 1
    out = head(x.requires_grad_())               # gradients: eager
    assert out.requires_grad
    out.sum().backward()
    m.train()                                    # training: graphs dropped
    assert not head.stage_graphs.graphs
    with torch.no_grad():
        head(x)
    m.eval()
    assert graph_records() == [0.0, 0.0, 1.0, 0.0, 0.0]
    assert not head.stage_graphs.graphs
    telemetry.reset()
    with torch.no_grad():
        for t in range(1, graphs.MAX_SIGNATURES + 2):
            for _ in range(2):
                head(noise((1, t, 16), t).cuda())
        assert len(head.stage_graphs.graphs) == graphs.MAX_SIGNATURES
        y = noise((1, graphs.MAX_SIGNATURES + 1, 16), 5).cuda()
        close(head(y), head._body(y))
        head(noise((1, 1, 16), 6).cuda())
    assert graph_records() == \
        [0.0] * (2 * graphs.MAX_SIGNATURES + 3) + [1.0]


@pytest.mark.cuda
def test_threads_replaying_one_stage_each_get_their_own_answer():
    _card()
    m = tiny()
    head = m.ctc_decoder
    xs = [noise((4, 12, 16), 10 + i).cuda() for i in range(6)]
    with torch.no_grad():
        head(xs[0])
        head(xs[0])
        want = [head._body(x) for x in xs]
    errors = []

    def worker(i):
        try:
            with torch.no_grad():
                for _ in range(50):
                    close(head(xs[i]), want[i])
        except Exception as e:             # reported by the main thread
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,)) for i in
               range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert graph_records().count(1.0) == 50 * len(xs)


@pytest.mark.cuda
def test_export_of_the_encoder_on_the_card_runs_no_graph(conformer_s,
                                                         tmp_path):
    wav = noise((1, 2 * SR), 7).cuda()
    with torch.no_grad():
        conformer_s.encode(wav)
        conformer_s.encode(wav)                 # a graph of this shape
        want = conformer_s.encode(wav)
    n_graphs = len(conformer_s.encoder.stage_graphs.graphs)
    telemetry.reset()
    export_offline_asr(conformer_s, str(tmp_path), batch=1, seconds=2.0)
    assert set(graph_records()) <= {0.0}
    assert len(conformer_s.encoder.stage_graphs.graphs) == n_graphs
    got = load_exported(str(tmp_path))["encoder"](wav.cpu().numpy())
    close(torch.from_numpy(got), want.cpu())


@pytest.mark.cuda
def test_a_capture_under_inference_mode_replays_under_no_grad():
    _card()
    head = tiny().ctc_decoder
    x1, x2 = noise((2, 9, 16), 8).cuda(), noise((2, 9, 16), 9).cuda()
    with torch.inference_mode():
        head(x1)
        head(x1)                                   # eager, then captured
    with torch.no_grad():
        got = head(x2)
        want = head._body(x2)
    assert graph_records() == [0.0, 0.0, 1.0]
    close(got, want)


@pytest.mark.cuda
def test_a_replays_range_is_one_no_trace_reduction_credits():
    _card()
    head = tiny().ctc_decoder
    x = noise((2, 9, 16), 11).cuda()
    with torch.no_grad():
        head(x)
        head(x)                                    # eager, then captured
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            head(x)
            torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == cpu}
    # the replay, its copy-in and its clone under the plain range alone
    assert "tasr.conformer.ctc_head" in names
    assert "tasr::conformer.ctc_head" not in names
    assert {"aten::copy_", "aten::clone"} <= names
    assert graph_records() == [0.0, 0.0, 1.0]
