"""Seeded random weights made on the device in one draw.

A configuration names its law:

- ``glorot_uniform``: Keras' initializers, as TensorflowASR builds a model
  (glorot-uniform kernels with the depthwise and attention fan rules, zero
  biases, U(-0.05, 0.05) embeddings, unit norms);
- ``fan_in_normal``: kernels N(0, 1 / fan_in), N(0, 1) embeddings, zero
  biases, unit norms, under which a random Conformer's frames differ from
  one another (a Keras-initialised one answers every frame alike).

The leaves come from the plain reference's list of names and shapes; the
program loads the same dict (strictly, so the names agree).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _limit_and_fan(shape, kind: str, heads: int):
    """(glorot limit, fan_in) of a random leaf."""
    if kind == "dense":
        out, inp = shape
        return math.sqrt(6.0 / (inp + out)), inp
    if kind == "attn_in":
        out, inp = shape
        return math.sqrt(6.0 / (heads * inp + out)), inp
    if kind == "attn_out":
        out, inp = shape
        return math.sqrt(6.0 / (inp + heads * out)), inp
    if kind == "conv":
        out, inp, kh, kw = shape
        rf = kh * kw
        return math.sqrt(6.0 / (rf * inp + rf * out)), rf * inp
    if kind == "depthwise":
        c, _, k = shape
        return math.sqrt(6.0 / (k * c + k)), k
    raise ValueError(kind)


def make(spec, law: str, seed: int, device: torch.device, heads: int
         ) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on ``device`` for every leaf of ``spec`` (name ->
    (shape, kind)), drawn from ``seed`` by one generator call."""
    rand = [(n, s, k) for n, (s, k) in spec.items()
            if k not in ("zero", "one")]
    total = sum(math.prod(s) for _, s, _ in rand)
    g = torch.Generator(device=device).manual_seed(
        (2 * int(seed) + 1) % (2 ** 63))
    if law == "glorot_uniform":
        flat = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    elif law == "fan_in_normal":
        flat = torch.randn(total, generator=g, device=device)
    else:
        raise ValueError(f"unknown weight law {law!r}")
    out, at = {}, 0
    for name, shape, kind in rand:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if kind == "embedding":
            scale = 0.05 if law == "glorot_uniform" else 1.0
        else:
            limit, fan_in = _limit_and_fan(shape, kind, heads)
            scale = limit if law == "glorot_uniform" else 1.0 / math.sqrt(
                fan_in)
        out[name] = x * scale
    for name, (shape, kind) in spec.items():
        if kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "one":
            out[name] = torch.ones(shape, device=device)
    return {name: out[name] for name in spec}


def conformer(config: dict, m: dict, seed: int, device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A ConformerCTC configuration's weights: the configuration's law, then
    its calibration (``reference/conformer.py::calibrate``) on gated tones
    drawn from the seed."""
    from benchlib import traffic
    from reference import conformer as ref
    n_phone = config["num_phone_classes"]
    spec = ref.param_spec(m, n_phone, config["num_char_classes"])
    wcfg = config["weights"]
    w = make(spec, wcfg["law"], seed, device, m["num_heads"])
    if wcfg.get("calibration_signals"):
        rng = traffic.rng_for(seed, 5)
        n = int(wcfg["calibration_seconds"] * traffic.SR)
        wav = np.stack([traffic.tones(n, rng)
                        for _ in range(int(wcfg["calibration_signals"]))])
        ref.calibrate(w, m, torch.from_numpy(wav).to(device), n_phone - 1)
    return w
