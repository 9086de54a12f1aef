"""SpecAugment in the port against ``tensorflowasr_tpu.ops.specaug``.

The two frameworks' generators give different numbers, so the bands are
drawn once with ``jax.random`` (the same calls the JAX function makes
internally) and handed to the port's apply step; the drawing is held to its
bounds on its own."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorflowasr_tpu.ops import specaug as jspec
from tensorflowasr_tpu_torch.models import conformer as tconf
from tensorflowasr_tpu_torch.models.layers import set_generator
from tensorflowasr_tpu_torch.ops import specaug as tspec

B, T, F_ = 4, 120, 80


def mel_batch(seed=0):
    return (np.random.default_rng(seed).standard_normal((B, T, F_)) * 10
            - 40).astype(np.float32)


def jax_bands(key_w, key_s, n_masks, dim, max_width):
    """The (start, width) that ``specaug._axis_masks`` draws from its keys."""
    w = jax.random.randint(key_w, (B, n_masks), 0, max_width + 1)
    u = jax.random.uniform(key_s, (B, n_masks))
    s = jnp.floor(u * (dim - w + 1).astype(jnp.float32)).astype(jnp.int32)
    return (torch.from_numpy(np.array(s, np.int32)),
            torch.from_numpy(np.array(w, np.int32)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_bands_matches_jax_on_the_same_bands(seed):
    mel = mel_batch(seed)
    rng = jax.random.PRNGKey(seed)
    want = np.asarray(jspec.spec_augment(jnp.asarray(mel), rng,
                                         n_freq_masks=2, freq_width=27,
                                         n_time_masks=2, time_ratio=0.05))
    kfw, kfs, ktw, kts = jax.random.split(rng, 4)
    got = tspec.apply_bands(
        torch.from_numpy(mel), jax_bands(kfw, kfs, 2, F_, 27),
        jax_bands(ktw, kts, 2, T, int(round(T * 0.05)))).numpy()
    # masked cells hold the utterance mean (a sum of 9600 values in two
    # orders: 1e-4 on values near -40), the others are untouched
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got == mel, want == mel)
    assert (got != mel).any()


def test_fill_is_the_detached_utterance_mean():
    mel = torch.from_numpy(mel_batch(3)).requires_grad_()
    s = torch.tensor([[5]] * B, dtype=torch.int32)
    w = torch.tensor([[10]] * B, dtype=torch.int32)
    out = tspec.apply_bands(mel, (s, w), None)
    for b in range(B):
        assert torch.all(out[b, :, 5:15] == mel[b].mean().detach())
    assert torch.equal(out[:, :, :5], mel[:, :, :5])
    assert torch.equal(out[:, :, 15:], mel[:, :, 15:])
    out.sum().backward()
    # no gradient into masked cells, and none through the fill
    assert torch.all(mel.grad[:, :, 5:15] == 0)
    assert torch.all(mel.grad[:, :, :5] == 1)


def test_drawn_bands_stay_inside_their_bounds():
    g = torch.Generator().manual_seed(0)
    for dim, max_width in ((80, 27), (30, 6), (10, 50), (5, 0)):
        s, w = tspec.draw_bands(g, 500, 2, dim, max_width)
        cap = min(max_width, dim)
        assert int(w.min()) >= 0 and int(w.max()) <= cap
        assert int(s.min()) >= 0 and int((s + w).max()) <= dim
        if cap:
            assert int(w.max()) == cap        # the top width does occur
    a = tspec.draw_bands(torch.Generator().manual_seed(4), 8, 2, 80, 27)
    b = tspec.draw_bands(torch.Generator().manual_seed(4), 8, 2, 80, 27)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_spec_augment_masks_at_most_the_configured_share():
    mel = torch.from_numpy(mel_batch(5))
    out = tspec.spec_augment(mel, torch.Generator().manual_seed(1))
    changed = out != mel
    assert changed.any()
    # at most 2 x 27 mel bins and 2 x round(0.05 T) frames per utterance,
    # and every changed cell lies in such a band
    cols, rows = changed.all(dim=1), changed.all(dim=2)
    assert int(cols.sum(dim=1).max()) <= 2 * 27
    assert int(rows.sum(dim=1).max()) <= 2 * round(T * 0.05)
    assert torch.equal(changed, cols[:, None, :] | rows[:, :, None])
    untouched = tspec.spec_augment(mel, torch.Generator().manual_seed(1),
                                   n_freq_masks=0, n_time_masks=0)
    assert torch.equal(untouched, mel)


def test_encoder_applies_it_only_in_training_mode():
    cfg = tconf.ConformerConfig(
        dmodel=32, num_blocks=1, head_size=16, num_heads=2, kernel_size=8,
        dropout=0.0, ctcdecoder_dropout=0.0, translator_dropout=0.0,
        spec_augment=True)
    model = tconf.build_model(cfg, 11, 17, device="cpu", seed=0)
    wav = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (2, 8000)) * 0.1).astype(np.float32))
    plain_cfg = tconf.ConformerConfig(**{**cfg.__dict__,
                                         "spec_augment": False})
    plain = tconf.build_model(plain_cfg, 11, 17, device="cpu", seed=0)
    with torch.no_grad():
        assert torch.equal(model.encode(wav), plain.encode(wav))   # eval
        model.train(), plain.train()
        with pytest.raises(RuntimeError, match="generator"):
            model.encode(wav)
        set_generator(model, torch.Generator().manual_seed(2))
        assert not torch.equal(model.encode(wav), plain.encode(wav))
