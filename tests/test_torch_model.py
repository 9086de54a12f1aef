"""The PyTorch ConformerCTC against the flax one, from the same weights.

The flax variables (random, every leaf drawn from a numpy seed so biases and
BatchNorm statistics are non-trivial) move through ``models/convert.py``;
both models then see the same numpy wav and phone ids on the CPU.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.models import conformer as jconf
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models import convert
from tensorflowasr_tpu_torch.models.layers import set_generator

torch.set_num_threads(2)

N_PHONE, N_CHAR = 11, 17
TINY = dict(dmodel=32, num_blocks=2, head_size=16, num_heads=2,
            kernel_size=8, ctcdecoder_num_blocks=1, ctcdecoder_kernel_size=8,
            translator_num_blocks=2, translator_kernel_size=8)


def randomize(shapes, seed):
    """Every leaf drawn from a numpy seed (variances positive), so no zero
    bias or unit statistic hides a mapping error."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.standard_normal(x.shape) * 0.2).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_model(scan=False, dtype="float32", **kw):
    cfg = jconf.ConformerConfig(dropout=0.0, ctcdecoder_dropout=0.0,
                                translator_dropout=0.0, scan_layers=scan,
                                dtype_str=dtype, **TINY, **kw)
    model = jconf.ConformerCTC(cfg, N_PHONE, N_CHAR)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3200), jnp.float32),
                            jnp.ones((1, 4), jnp.int32))
    return model, randomize(shapes, seed=7)


def torch_model(variables, dtype="float32", **kw):
    cfg = tconf.ConformerConfig(dtype_str=dtype, **TINY, **kw)
    model = tconf.ConformerCTC(cfg, N_PHONE, N_CHAR)
    model.load_state_dict(convert.convert_flax_variables(variables, cfg))
    return model.eval()


def inputs(seed=0, b=2, t=16000 + 123, u=9):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((b, t)) * 0.1).astype(np.float32)
    ids = rng.integers(0, N_PHONE, (b, u)).astype(np.int32)
    return wav, ids


def run_both(jmodel, variables, tmodel, wav, ids):
    @jax.jit
    def forward(variables, wav, ids):
        enc = jmodel.apply(variables, wav, method=jconf.ConformerCTC.encode)
        return (enc,
                jmodel.apply(variables, enc,
                             method=jconf.ConformerCTC.ctc_logits),
                jmodel.apply(variables, ids, enc,
                             method=jconf.ConformerCTC.translate))

    enc_j, ctc_j, chr_j = forward(variables, wav, ids)
    with torch.no_grad():
        enc_t = tmodel.encode(torch.from_numpy(wav))
        # the heads get the JAX encoder output, so each stage is held
        # on its own
        enc_in = torch.from_numpy(np.array(enc_j))
        ctc_t = tmodel.ctc_logits(enc_in)
        chr_t = tmodel.translate(torch.from_numpy(ids), enc_in)
    return ([np.asarray(a, np.float32) for a in (enc_j, ctc_j, chr_j)],
            [a.float().numpy() for a in (enc_t, ctc_t, chr_t)])


@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
def test_conformer_ctc_f32_matches_flax(scan):
    jmodel, variables = jax_model(scan=scan)
    tmodel = torch_model(variables)
    want, got = run_both(jmodel, variables, tmodel, *inputs())
    for name, w, g in zip(("encode", "ctc_logits", "translate"), want, got):
        assert g.shape == w.shape, name
        # f32 end to end; the difference is summation order only (measured
        # about 5e-7 at this size)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)


def test_conformer_ctc_bf16_matches_flax():
    jmodel, variables = jax_model(dtype="bfloat16")
    tmodel = torch_model(variables, dtype="bfloat16")
    want, got = run_both(jmodel, variables, tmodel, *inputs(seed=1))
    for name, w, g in zip(("encode", "ctc_logits", "translate"), want, got):
        # bf16 keeps 8 mantissa bits (eps 2**-8 = 0.0039) and the two
        # frameworks round at other places (XLA fuses elementwise chains in
        # f32, the port softmaxes in f32): hold the outputs to a few bf16
        # ulps of their scale (measured max 0.0075, mean 0.0008 of it)
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 0.02 * scale, name
        assert np.abs(g - w).mean() <= 0.002 * scale, name


def test_int16_wav_matches_float():
    jmodel, variables = jax_model()
    tmodel = torch_model(variables)
    wav, _ = inputs(seed=2)
    pcm = (wav * 32768).clip(-32768, 32767).astype(np.int16)
    want = np.asarray(jax.jit(functools.partial(
        jmodel.apply, method=jconf.ConformerCTC.encode))(variables, pcm))
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(pcm)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(mel_layer_type="Spectrogram"),
    dict(mel_layer_trainable=True),
], ids=["spectrogram", "trainable_fb"])
def test_frontend_variants_match_flax(kw):
    jmodel, variables = jax_model(**kw)
    tmodel = torch_model(variables, **kw)
    wav, _ = inputs(seed=3, t=8000)
    want = np.asarray(jax.jit(functools.partial(
        jmodel.apply, method=jconf.ConformerCTC.encode))(variables, wav))
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_convert_rejects_missing_and_unused_keys():
    _, variables = jax_model()
    flat = convert.flatten(variables)
    cfg = tconf.ConformerConfig(**TINY)
    missing = {k: v for k, v in flat.items()
               if "ctc_decoder/project/kernel" not in k}
    with pytest.raises(KeyError, match="missing"):
        convert.convert_flat(missing, cfg)
    extra = dict(flat, **{"params/encoder/stray/kernel":
                          np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="unused"):
        convert.convert_flat(extra, cfg)
    deeper = dataclasses.replace(cfg, num_blocks=3)
    with pytest.raises(KeyError, match="missing"):
        convert.convert_flat(flat, deeper)


def test_npz_weights_round_trip(tmp_path):
    """The CLI's --weights format: native_export's flattened names."""
    from tensorflowasr_tpu.export.native_export import _flatten

    _, variables = jax_model(scan=True)
    path = tmp_path / "w.npz"
    np.savez(path, **dict(_flatten(variables)))
    cfg = tconf.ConformerConfig(**TINY)
    from_npz = convert.load_npz(str(path), cfg)
    direct = convert.convert_flax_variables(variables, cfg)
    assert from_npz.keys() == direct.keys()
    for k in direct:
        assert torch.equal(from_npz[k], direct[k]), k
    assert convert.num_classes(direct) == (N_PHONE, N_CHAR)


def _train_inputs(seed=4, b=2, t=8000, l=7):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((b, t)) * 0.1).astype(np.float32)
    phones = rng.integers(1, N_PHONE - 1, (b, l)).astype(np.int32)
    in_len = np.array([t // 640, t // 640 - 3], np.int32)
    return wav, phones, in_len


def test_train_forward_matches_flax():
    """Training mode with dropout 0: all five outputs of ``train_forward``
    and the BatchNorm statistics it leaves behind (the translator runs
    twice, so its statistics move twice)."""
    jmodel, variables = jax_model()
    tmodel = torch_model(variables, dropout=0.0, ctcdecoder_dropout=0.0,
                         translator_dropout=0.0).train()
    wav, phones, in_len = _train_inputs()
    want, new = jax.jit(functools.partial(
        jmodel.apply, method=jconf.ConformerCTC.train_forward,
        mutable=["batch_stats"]))(variables, wav, phones, in_len)
    got = tmodel.train_forward(*map(torch.from_numpy,
                                    (wav, phones, in_len)))
    names = ("enc", "ctc_logits", "decoded", "label_out", "ctc_out")
    t_enc = -(-(-(-wav.shape[1] // 160)) // 4)
    assert got[3].shape == (2, phones.shape[1] + 5, N_CHAR)
    assert got[4].shape == (2, t_enc, N_CHAR)      # width T', not U
    for name, w, g in zip(names, want, got):
        w, g = np.asarray(w), g.detach().numpy()
        assert g.shape == w.shape, name
        if name == "decoded":
            np.testing.assert_array_equal(g, w)
        else:
            # f32, summation order only
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5,
                                       err_msg=name)
    stats = convert.to_torch_names(convert.flatten(
        {"batch_stats": jax.tree.map(np.asarray, new["batch_stats"])}))
    buffers = dict(tmodel.named_buffers())
    assert set(stats) == set(buffers)
    for name, value in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def test_remat_blocks_changes_no_number():
    """``remat_blocks`` recomputes the encoder blocks in the backward pass:
    with dropout on, the same loss, gradients and running statistics as
    without it (the recomputation replays the same masks and does not move
    the statistics a second time)."""
    wav, phones, in_len = map(torch.from_numpy, _train_inputs(seed=5))
    results = []
    for remat in (False, True):
        cfg = tconf.ConformerConfig(**TINY, remat_blocks=remat)
        model = tconf.build_model(cfg, N_PHONE, N_CHAR, device="cpu",
                                  seed=3).train()
        set_generator(model, torch.Generator().manual_seed(11))
        out = model.train_forward(wav, phones, in_len)
        (out[1].sum() + out[3].sum() + out[4].sum()).backward()
        results.append((out[1].detach(),
                        [p.grad for p in model.parameters()],
                        [b.clone() for b in model.buffers()]))
    (logits_a, grads_a, bufs_a), (logits_b, grads_b, bufs_b) = results
    assert torch.equal(logits_a, logits_b)
    for a, b in zip(grads_a + bufs_a, grads_b + bufs_b):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_eval_mode_is_unchanged_by_the_training_fields():
    """Dropout rates and SpecAugment do nothing in eval mode."""
    _, variables = jax_model()
    wav, ids = inputs(seed=6, t=8000)
    plain = torch_model(variables, dropout=0.0, ctcdecoder_dropout=0.0,
                        translator_dropout=0.0)
    full = torch_model(variables, spec_augment=True)
    with torch.no_grad():
        for a, b in zip(plain(torch.from_numpy(wav), torch.from_numpy(ids)),
                        full(torch.from_numpy(wav), torch.from_numpy(ids))):
            assert torch.equal(a, b)


def test_unported_options_raise():
    """``add_wav_info`` and ``mel_layer_type: leaf`` are ported (held to
    JAX by tests/test_torch_wav_model.py and tests/test_torch_leaf.py):
    both build. A mel_layer_type that is none of the three raises."""
    for kw, sub in ((dict(add_wav_info=True), "wav_layer"),
                    (dict(mel_layer_type="leaf"), "mel_layer.leaf")):
        model = tconf.ConformerCTC(tconf.ConformerConfig(**TINY, **kw),
                                   N_PHONE, N_CHAR)
        assert model.encoder.get_submodule(sub) is not None
    with pytest.raises(ValueError, match="unknown mel_layer_type"):
        tconf.ConformerCTC(tconf.ConformerConfig(**TINY,
                                                 mel_layer_type="mfcc"),
                           N_PHONE, N_CHAR)


def test_build_model_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tconf.build_model(tconf.ConformerConfig(**TINY), N_PHONE, N_CHAR)


def test_from_user_config_reads_the_shipped_yamls():
    from tensorflowasr_tpu.utils.config import UserConfig as JUserConfig
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = tuple(os.path.join(root, "configs", n)
                  for n in ("am_data.yml", "conformerS.yml"))
    got = tconf.ConformerConfig.from_user_config(UserConfig(*paths))
    want = jconf.ConformerConfig.from_user_config(JUserConfig(*paths))
    for f in dataclasses.fields(got):
        if f.name != "dtype_str":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
