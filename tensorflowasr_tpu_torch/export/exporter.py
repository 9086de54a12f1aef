"""Model export through ``torch.export``: ``.pt2`` programs and a manifest.

Counterpart of ``tensorflowasr_tpu/export/exporter.py``, which writes
serialized StableHLO; the port writes ``torch.export`` programs instead,
with the same graphs, example shapes and manifest keys:

- offline ASR, three graphs (``ConformerCTC.encode`` / ``ctc_logits`` /
  ``translate``):
    encoder    f32[B, T]               -> f32[B, T', d]
    ctc_model  f32[B, T', d]           -> f32[B, T', Vp]
    translator i32[B, U], f32[B, T', d] -> f32[B, U, Vc]
- chunk streaming, two stateful graphs (``ChunkConformer.
  picker_stream_step`` / ``decoder_stream_step``) whose caches are explicit
  inputs and outputs, flattened in sorted-key order (the manifest's
  ``picker_cache_keys`` / ``decoder_cache_keys``).

The frontend is the ``tasr::`` custom ops of ``ops/frontend.py``, so an
exported encoder or picker holds one ``tasr::log_mel_spectrogram`` node
that launches K1b when the loaded program runs on the card. A program runs
on the device it was exported on (its weights are stored there).
:func:`load_exported` imports ``ops/frontend.py`` first, which registers
the ops, and returns callables that take and return numpy arrays.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

# registers the tasr:: ops before a program that calls them is loaded
from tensorflowasr_tpu_torch.ops import frontend as _frontend  # noqa: F401


class _Call(nn.Module):
    """``fn(model, *args)`` as a module for ``torch.export.export``."""

    def __init__(self, model: nn.Module, fn: Callable):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _export_one(model: nn.Module, fn: Callable, example_args
                ) -> torch.export.ExportedProgram:
    return torch.export.export(_Call(model, fn), tuple(example_args),
                               strict=False)


def save_exported(outdir: str,
                  graphs: Dict[str, torch.export.ExportedProgram],
                  meta: Dict) -> None:
    """Write each program as ``<name>.pt2`` and ``manifest.json``."""
    os.makedirs(outdir, exist_ok=True)
    for name, program in graphs.items():
        torch.export.save(program, os.path.join(outdir, f"{name}.pt2"))
    with open(os.path.join(outdir, "manifest.json"), "w") as f:
        json.dump({"graphs": sorted(graphs), **meta}, f, indent=2)


def _program_device(program: torch.export.ExportedProgram) -> torch.device:
    for tensor in list(program.state_dict.values()) + \
            list(program.constants.values()):
        if isinstance(tensor, torch.Tensor):
            return tensor.device
    return torch.device("cpu")


def load_exported(outdir: str) -> Dict[str, Callable]:
    """-> {graph name: callable taking and returning numpy arrays} (a
    list of arrays for a graph with several outputs); each callable's
    ``program`` is the loaded ``ExportedProgram``."""
    with open(os.path.join(outdir, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name in manifest["graphs"]:
        program = torch.export.load(os.path.join(outdir, f"{name}.pt2"))
        module, device = program.module(), _program_device(program)

        def call(*args, _module=module, _device=device):
            with torch.no_grad():
                res = _module(*[torch.as_tensor(np.asarray(a)).to(_device)
                                for a in args])
            if isinstance(res, (tuple, list)):
                return [r.cpu().numpy() for r in res]
            return res.cpu().numpy()

        call.program = program           # its graph, for inspection
        out[name] = call
    return out


def export_offline_asr(model, outdir: str, batch: int = 1,
                       seconds: float = 7.0, max_phones: int = 64
                       ) -> Dict[str, torch.export.ExportedProgram]:
    """Export a ``ConformerCTC``'s three offline graphs (eval mode) at
    fixed example shapes on the model's device."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    quantum = cfg.hop_size * cfg.reduction_factor
    t = int(seconds * cfg.sample_rate) // quantum * quantum
    t_red = t // quantum
    wav = torch.zeros((batch, t), dtype=torch.float32, device=dev)
    enc_ex = torch.zeros((batch, t_red, cfg.dmodel), dtype=torch.float32,
                         device=dev)
    ids_ex = torch.zeros((batch, max_phones), dtype=torch.int32, device=dev)
    was_training = model.training
    model.eval()
    try:
        graphs = {
            "encoder": _export_one(model, lambda m, w: m.encode(w), (wav,)),
            "ctc_model": _export_one(model, lambda m, e: m.ctc_logits(e),
                                     (enc_ex,)),
            "translator": _export_one(
                model, lambda m, i, e: m.translate(i, e), (ids_ex, enc_ex)),
        }
    finally:
        model.train(was_training)
    save_exported(outdir, graphs, {
        "kind": "offline_asr", "batch": batch, "wav_samples": t,
        "enc_frames": t_red, "dmodel": cfg.dmodel,
        "max_phones": max_phones,
    })
    return graphs


def export_chunk_streaming(model, outdir: str, batch: int = 1,
                           decoder_step: int = 4
                           ) -> Dict[str, torch.export.ExportedProgram]:
    """Export a ``ChunkConformer``'s two stateful streaming graphs (eval
    mode) with explicit cache inputs and outputs:

    picker  (wav [B, chunk_samples], *picker caches) -> (logits, hidden,
            n_final, *new picker caches)
    decoder (picked [B, decoder_step, d], *decoder caches) -> (logits,
            provisional, n_final, *new decoder caches)
    """
    cfg = model.cfg
    dev = next(model.parameters()).device
    pk_caches = model.init_picker_caches(batch)
    dec_caches = model.init_decoder_caches(batch)
    wav_chunk = torch.zeros((batch, cfg.chunk_samples), dtype=torch.float32,
                            device=dev)
    picked = torch.zeros((batch, decoder_step, cfg.dmodel),
                         dtype=torch.float32, device=dev)
    pk_keys = sorted(pk_caches)
    dec_keys = sorted(dec_caches)

    def picker_fn(m, wav, *flat):
        logits, hidden, n_final, new = m.picker_stream_step(
            wav, dict(zip(pk_keys, flat)))
        return (logits, hidden, n_final) + tuple(new[k] for k in pk_keys)

    def decoder_fn(m, x, *flat):
        logits, provisional, n_final, new = m.decoder_stream_step(
            x, dict(zip(dec_keys, flat)))
        return (logits, provisional, n_final) + tuple(new[k]
                                                      for k in dec_keys)

    was_training = model.training
    model.eval()
    try:
        graphs = {
            "picker": _export_one(
                model, picker_fn,
                (wav_chunk,) + tuple(pk_caches[k] for k in pk_keys)),
            "decoder": _export_one(
                model, decoder_fn,
                (picked,) + tuple(dec_caches[k] for k in dec_keys)),
        }
    finally:
        model.train(was_training)
    save_exported(outdir, graphs, {
        "kind": "chunk_streaming", "batch": batch,
        "chunk_samples": cfg.chunk_samples, "decoder_step": decoder_step,
        "picker_cache_keys": pk_keys, "decoder_cache_keys": dec_keys,
    })
    return graphs
