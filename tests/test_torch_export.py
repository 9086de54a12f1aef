"""The port's ``torch.export`` artifacts (``export/exporter.py``) against
``tests/test_export.py``'s round trip: the offline three graphs and the
chunk model's stateful picker and decoder, reloaded and run from numpy
inputs, against the port's eager model and the JAX package's outputs from
the same weights; the manifests against JAX's; the ``tasr::`` frontend ops
(a node of every exported graph that holds the frontend) under
``torch.library.opcheck``; and ``cli.test_asr``'s ``--export_durations``
in both packages."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_chunk import tiny_cfg
from tests.test_torch_chunk import build_pair, close, jfn, t_
from tests.test_torch_model import jax_model, torch_model
from tensorflowasr_tpu.export import exporter as jexporter
from tensorflowasr_tpu.models import chunk_conformer as jcc
from tensorflowasr_tpu.models import conformer as jconf
from tensorflowasr_tpu_torch.export import exporter
from tensorflowasr_tpu_torch.ops import frontend as fe

torch.set_num_threads(2)

# exported program against the eager model it came from: the same ops on
# the same device, so the tolerance of tests/test_export.py is ample
ROUND_TRIP = dict(atol=1e-5, rtol=1e-4)


def frontend_nodes(program) -> list:
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("tasr.")]


def test_offline_export_roundtrip(tmp_path):
    jmodel, variables = jax_model()
    tmodel = torch_model(variables)
    graphs = exporter.export_offline_asr(tmodel, str(tmp_path / "port"),
                                         batch=1, seconds=1.0,
                                         max_phones=16)
    assert frontend_nodes(graphs["encoder"]) == \
        ["tasr.log_mel_spectrogram.default"]
    loaded = exporter.load_exported(str(tmp_path / "port"))
    assert set(loaded) == {"encoder", "ctc_model", "translator"}

    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((1, 16000)) * 0.1).astype(np.float32)
    ids = rng.integers(0, 11, (1, 16)).astype(np.int32)
    enc = loaded["encoder"](wav)
    logits = loaded["ctc_model"](enc)
    chars = loaded["translator"](ids, enc)
    with torch.no_grad():
        enc_live = tmodel.encode(t_(wav))
        live = (enc_live, tmodel.ctc_logits(enc_live),
                tmodel.translate(t_(ids), enc_live))
    jenc = jmodel.apply(variables, wav, method=jconf.ConformerCTC.encode)
    jax_out = (jenc,
               jmodel.apply(variables, jenc,
                            method=jconf.ConformerCTC.ctc_logits),
               jmodel.apply(variables, jnp.asarray(ids), jenc,
                            method=jconf.ConformerCTC.translate))
    for got, eager, want, what in zip((enc, logits, chars), live, jax_out,
                                      ("encoder", "ctc", "translator")):
        np.testing.assert_allclose(got, eager.numpy(), err_msg=what,
                                   **ROUND_TRIP)
        close(got, want)       # 1e-5 of the largest entry: f32 both sides

    jexporter.export_offline_asr(jmodel, variables, str(tmp_path / "jax"),
                                 batch=1, seconds=1.0, max_phones=16)
    manifests = [json.load(open(tmp_path / d / "manifest.json"))
                 for d in ("port", "jax")]
    assert manifests[0] == manifests[1]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "ctc_model.pt2", "encoder.pt2", "manifest.json", "translator.pt2"]


def test_chunk_export_streaming_state_threading(tmp_path):
    jcfg = tiny_cfg()
    jmodel, variables, tmodel = build_pair(jcfg, seed=1)
    graphs = exporter.export_chunk_streaming(tmodel, str(tmp_path / "port"),
                                             batch=1, decoder_step=2)
    assert frontend_nodes(graphs["picker"]) == \
        ["tasr.log_mel_spectrogram.default"]
    assert frontend_nodes(graphs["decoder"]) == []
    loaded = exporter.load_exported(str(tmp_path / "port"))
    assert set(loaded) == {"picker", "decoder"}
    manifest = json.load(open(tmp_path / "port" / "manifest.json"))
    jexporter.export_chunk_streaming(jmodel, variables, str(tmp_path / "jax"),
                                     batch=1, decoder_step=2)
    assert manifest == json.load(open(tmp_path / "jax" / "manifest.json"))
    pk_keys, dec_keys = (manifest["picker_cache_keys"],
                         manifest["decoder_cache_keys"])
    assert pk_keys == sorted(pk_keys) and "wav" in pk_keys

    rng = np.random.default_rng(1)
    cs = jcfg.chunk_samples
    wav = (rng.standard_normal((1, 3 * cs)) * 0.1).astype(np.float32)
    flat = [c.numpy() for c in map(tmodel.init_picker_caches(1).get,
                                   pk_keys)]
    live = tmodel.init_picker_caches(1)
    jcaches = jmodel.apply(variables, 1,
                           method=jcc.ChunkConformer.init_picker_caches)
    jstep = jfn(jmodel, jcc.ChunkConformer.picker_stream_step)
    for i in range(3):
        chunk = wav[:, i * cs:(i + 1) * cs]
        out = loaded["picker"](chunk, *flat)
        flat = out[3:]
        with torch.no_grad():
            eager = tmodel.picker_stream_step(t_(chunk), live)
        live = eager[3]
        want = jstep(variables, jnp.asarray(chunk), jcaches)
        jcaches = want[3]
        for j in range(3):
            np.testing.assert_allclose(out[j], eager[j].numpy(),
                                       **ROUND_TRIP)
            close(out[j], want[j])
        for k, got in zip(pk_keys, flat):
            np.testing.assert_allclose(got, live[k].numpy(), **ROUND_TRIP)

    picked = rng.standard_normal((3, 1, 2, jcfg.dmodel)).astype(np.float32)
    flat = [c.numpy() for c in map(tmodel.init_decoder_caches(1).get,
                                   dec_keys)]
    live = tmodel.init_decoder_caches(1)
    jcaches = jmodel.apply(variables, 1,
                           method=jcc.ChunkConformer.init_decoder_caches)
    jstep = jfn(jmodel, jcc.ChunkConformer.decoder_stream_step)
    for x in picked:
        out = loaded["decoder"](x, *flat)
        flat = out[3:]
        with torch.no_grad():
            eager = tmodel.decoder_stream_step(t_(x), live)
        live = eager[3]
        want = jstep(variables, jnp.asarray(x), jcaches)
        jcaches = want[3]
        for j in range(3):
            np.testing.assert_allclose(out[j], eager[j].numpy(),
                                       **ROUND_TRIP)
            close(out[j], want[j])


@pytest.mark.parametrize("same", [True, False], ids=["same", "valid"])
def test_frontend_ops_pass_opcheck(same):
    """Schema, fake implementation (static and dynamic shapes) and the
    given matrix's registered autograd, on CPU tensors."""
    rng = np.random.default_rng(2)
    wav = torch.from_numpy((rng.standard_normal((2, 3200 + 37)) * 0.1
                            ).astype(np.float32))
    weights = torch.from_numpy(fe.mel_filterbank(16000, 1024, 80))
    cfg = (16000, 1024, 10, same)
    torch.library.opcheck(fe.power_spectrogram_op, (wav,) + cfg)
    torch.library.opcheck(fe.log_mel_spectrogram_op,
                          (wav,) + cfg + (80, 0.0, None, 80.0))
    torch.library.opcheck(fe.log_mel_spectrogram_weights_op,
                          (wav, weights.requires_grad_()) + cfg + (80.0,))
    # the fake implementation's shape is the CPU implementation's
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = fe.log_mel_spectrogram_op(mode.from_tensor(wav), *cfg, 80,
                                         0.0, None, 80.0)
    assert tuple(fake.shape) == (2, 21, 80)


def test_test_asr_parsers_accept_export_durations(monkeypatch):
    """Both packages' ``cli.test_asr`` parse ``--export_durations 2,4``
    (the port reads it only beside ``--export_savedmodel``, which still
    raises)."""
    from tensorflowasr_tpu.cli import test_asr as jcli
    from tensorflowasr_tpu_torch.cli import test_asr as tcli

    class Parsed(Exception):
        pass

    def stop(args):
        raise Parsed(args.export_durations)

    argv = ["--data_config", "d.yml", "--model_config", "m.yml", "--wav",
            "x.wav", "--export_durations", "2,4"]
    for cli in (jcli, tcli):
        monkeypatch.setattr(cli, "load_config", stop)
        with pytest.raises(Parsed, match="^2,4$"):
            cli.main(argv)
    with pytest.raises(NotImplementedError, match="not ported"):
        tcli.main(argv + ["--export_savedmodel", "sm"])
