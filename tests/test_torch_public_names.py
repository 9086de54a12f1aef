"""The public names of the JAX package that the port added last, against
JAX's: ``utils.metrics.wer``, the ``utils`` package's re-exports,
``models.conformer.count_params`` (offline and chunk models, the number the
trainers log), ``utils.telemetry.RTFMeter``, ``trace`` and
``start_profiler_server``. Counts and results must be equal."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorflowasr_tpu.utils as jutils
import tensorflowasr_tpu_torch.utils as tutils
from tensorflowasr_tpu.models import chunk_conformer as jcc
from tensorflowasr_tpu.models import conformer as jconf
from tensorflowasr_tpu.utils import metrics as jmetrics
from tensorflowasr_tpu.utils import telemetry as jtelemetry
from tensorflowasr_tpu_torch.models import chunk_conformer as tcc
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.utils import metrics as tmetrics
from tensorflowasr_tpu_torch.utils import telemetry as ttelemetry
from tests.test_chunk import N_CHAR, N_PHONE, tiny_cfg
from tests.test_torch_chunk import port_cfg
from tests.test_torch_serve import TINY

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", range(4))
def test_wer_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        ref = list(rng.integers(0, 6, rng.integers(0, 12)))
        hyp = list(rng.integers(0, 6, rng.integers(0, 12)))
        assert tmetrics.wer(ref, hyp) == jmetrics.wer(ref, hyp)
    words = "ni hao shi jie zai jian".split()
    ref = [words[i] for i in rng.integers(0, 6, 9)]
    hyp = [words[i] for i in rng.integers(0, 6, 7)]
    assert tmetrics.wer(ref, hyp) == jmetrics.wer(ref, hyp)


def test_utils_exports_jax_s_names():
    assert tutils.__all__ == jutils.__all__
    for name in tutils.__all__:
        assert callable(getattr(tutils, name)), name
    assert tutils.wer is tmetrics.wer


def jax_offline_params(n_phone, n_char, **kw):
    jmodel = jconf.ConformerCTC(jconf.ConformerConfig(**kw), n_phone, n_char)
    return jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 3200), jnp.float32),
                          jnp.ones((1, 4), jnp.int32))["params"]


# the tiny serving config, it with a trainable mel matrix and with the wav
# branch, and the head-to-head quick run's model (run_ours.py's defaults
# over the quick corpus' 247 phones and 122 chars, each with its blank)
OFFLINE = {
    "tiny": (TINY, 20, 30),
    "tiny_trainable_mel": (dict(TINY, mel_layer_trainable=True), 20, 30),
    "tiny_wav_info": (dict(TINY, add_wav_info=True), 20, 30),
    "headtohead": (dict(dmodel=64, num_blocks=4, head_size=16, num_heads=4,
                        kernel_size=16, ctcdecoder_kernel_size=16,
                        translator_num_blocks=1, translator_kernel_size=16),
                   248, 123),
}


@pytest.mark.parametrize("name", sorted(OFFLINE))
def test_count_params_offline_equals_jax(name):
    kw, n_phone, n_char = OFFLINE[name]
    want = jconf.count_params(jax_offline_params(n_phone, n_char, **kw))
    model = tconf.ConformerCTC(tconf.ConformerConfig(**kw), n_phone, n_char)
    assert tconf.count_params(model) == want
    if name == "headtohead":
        assert want == 821_875


def test_count_params_chunk_equals_jax():
    jcfg = tiny_cfg()
    jmodel = jcc.ChunkConformer(jcfg, N_PHONE, N_CHAR)
    shapes = jax.eval_shape(
        lambda k, w, p: jmodel.init(k, w, p, 8, False,
                                    method=jcc.ChunkConformer.train_forward),
        jax.random.PRNGKey(0), jnp.zeros((1, jcfg.chunk_samples)),
        jnp.ones((1, 4), jnp.int32))
    model = tcc.ChunkConformer(port_cfg(jcfg), N_PHONE, N_CHAR)
    assert tcc.count_params(model) == jcc.count_params(shapes["params"])
    assert tcc.count_params is tconf.count_params


def test_rtf_meter_equals_jax():
    calls = [(0.12, 2.0), (0.05, 0.48), (0.31, 8.0), (0.0, 0.0)]
    meters = ttelemetry.RTFMeter(), jtelemetry.RTFMeter()
    assert meters[0].result() == meters[1].result()
    for compute_s, audio_s in calls:
        for m in meters:
            m.add(compute_s, audio_s)
        assert meters[0].result() == meters[1].result()
    assert meters[0].result()["calls"] == 4
    assert meters[0].rtf == pytest.approx(0.48 / 10.48)


def test_trace_writes_a_trace_file(tmp_path):
    logdir = tmp_path / "trace"
    with ttelemetry.trace(str(logdir)):
        y = torch.nn.functional.relu(torch.ones(64, 64) @ torch.ones(64, 64))
    assert float(y[0, 0]) == 64.0
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)


def test_start_profiler_server_raises_with_its_reason():
    with pytest.raises(NotImplementedError, match="no on-demand profiler"):
        ttelemetry.start_profiler_server(9999)
