"""Raw-tensor artifacts for the standalone C++ engines, from port weights.

Counterpart of ``tensorflowasr_tpu/export/native_export.py``: the same
files, byte for byte, from the same weights. ``cpp/serving``'s native
engines (``asr_offline``, ``asr_chunk``, the VAD of both) read them with no
Python at runtime.

Artifact layout (<outdir>/):
  weights.bin     every tensor, row-major float32, back to back
  manifest.json   {"config": {...model dims...},
                   "tensors": [{"name", "shape", "offset"}...]}
  manifest.txt    the same, one "config <key> <value>" or
                  "tensor <name> <offset> <ndim> <dims...>" a line
  phones.txt / chars.txt   optional vocabulary copies

The tensors are the model's flax variables (``models/convert.py::
to_flax_names``, blocks unrolled as ``conformer_block_{i}`` /
``block_{i}``, the layout the C++ engines read), ordered as the JAX export
orders them (:func:`_flatten` of the nested ``params``, then of
``batch_stats``), then the frontend constants from the port's own numpy
copy of the JAX frontend (``ops/frontend.py::_frontend_constants``): the
windowed DFT and the Slaney mel basis. Where the JAX export finds a
trainable ``freq2mel`` it writes that instead of the fixed basis; it looks
at the top-level ``mel_layer`` (never present in a ``ConformerCTC``, whose
mel layer sits in the encoder) and at ``front`` (the chunk model's), and so
does this one.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tensorflowasr_tpu_torch.models.convert import to_flax_names
from tensorflowasr_tpu_torch.ops import frontend as fe


def _flatten(tree, prefix="") -> List[Tuple[str, np.ndarray]]:
    """Nested dicts -> [(name, array)], keys sorted at every level."""
    out = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
    else:
        out.append((prefix[:-1], np.asarray(tree)))
    return out


def _nested(model: torch.nn.Module) -> Dict[str, dict]:
    """The model's flax variables, unrolled, as nested dicts by
    collection."""
    tree: Dict[str, dict] = {}
    for name, arr in to_flax_names(model, scan_layers=False).items():
        node = tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return tree


def _tensors(tree: Dict[str, dict]) -> List[Tuple[str, np.ndarray]]:
    tensors = _flatten(tree["params"], "params/")
    if tree.get("batch_stats"):
        tensors.extend(_flatten(tree["batch_stats"], "batch_stats/"))
    return tensors


def _write(outdir: str, config: dict,
           tensors: List[Tuple[str, np.ndarray]],
           vocabs: Tuple[Tuple[Optional[str], str], ...] = ()) -> None:
    os.makedirs(outdir, exist_ok=True)
    manifest: Dict = {"config": config, "tensors": []}
    offset = 0
    with open(os.path.join(outdir, "weights.bin"), "wb") as f:
        for name, arr in tensors:
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            manifest["tensors"].append(
                {"name": name, "shape": list(arr.shape), "offset": offset})
            f.write(arr.tobytes())
            offset += arr.nbytes
    with open(os.path.join(outdir, "manifest.json"), "w",
              encoding="utf-8") as f:
        json.dump(manifest, f, indent=1)
    with open(os.path.join(outdir, "manifest.txt"), "w",
              encoding="utf-8") as f:
        for k, v in manifest["config"].items():
            f.write(f"config {k} {v}\n")
        for t in manifest["tensors"]:
            dims = " ".join(str(d) for d in t["shape"])
            f.write(f"tensor {t['name']} {t['offset']} "
                    f"{len(t['shape'])} {dims}\n")
    for src, dst in vocabs:
        if src:
            shutil.copyfile(src, os.path.join(outdir, dst))


def _frontend(c, padding: str) -> Tuple[np.ndarray, np.ndarray]:
    return fe._frontend_constants(fe.LogMelFrontendConfig(
        sample_rate=c.sample_rate, n_fft=1024, stride_ms=c.stride_ms,
        n_mels=c.n_mels, padding=padding))


def export_native(model, outdir: str, phone_vocab: Optional[str] = None,
                  char_vocab: Optional[str] = None) -> None:
    """Write the artifact of the offline ``ConformerCTC`` pipeline
    (``cpp/serving`` ``asr_offline``)."""
    c = model.cfg
    if c.mel_layer_type not in ("Melspectrogram", "Spectrogram"):
        raise ValueError(f"native export supports Melspectrogram/"
                         f"Spectrogram frontends, got {c.mel_layer_type}")
    if c.add_wav_info:
        raise ValueError("native export does not support add_wav_info")
    if c.streaming:
        raise ValueError("native export is for the offline model")
    tree = _nested(model)
    params = tree["params"]
    tensors = _tensors(tree)
    dft, fb = _frontend(c, "same")
    tensors.append(("frontend/dft", dft))          # [n_fft, 2*n_freq]
    if c.mel_layer_type == "Melspectrogram":
        if c.mel_layer_trainable and "mel_layer" in params and \
                "freq2mel" in params.get("mel_layer", {}):
            fb = np.asarray(params["mel_layer"]["freq2mel"])
        tensors.append(("frontend/freq2mel", fb))  # [n_freq, n_mels]
    config = {
        "dmodel": c.dmodel, "reduction_factor": c.reduction_factor,
        "num_blocks": c.num_blocks, "head_size": c.head_size,
        "num_heads": c.num_heads, "kernel_size": c.kernel_size,
        "fc_factor": c.fc_factor,
        "ctcdecoder_num_blocks": c.ctcdecoder_num_blocks,
        "ctcdecoder_kernel_size": c.ctcdecoder_kernel_size,
        "ctcdecoder_fc_factor": c.ctcdecoder_fc_factor,
        "translator_num_blocks": c.translator_num_blocks,
        "translator_kernel_size": c.translator_kernel_size,
        "translator_fc_factor": c.translator_fc_factor,
        "sample_rate": c.sample_rate, "n_mels": c.n_mels,
        "stride_ms": c.stride_ms, "n_fft": 1024,
        "mel_layer_type": c.mel_layer_type,
        "num_phone_classes": model.num_phone_classes,
        "num_char_classes": model.num_char_classes,
    }
    _write(outdir, config, tensors,
           ((phone_vocab, "phones.txt"), (char_vocab, "chars.txt")))


VAD_LAYERS = ("embed", "dense1", "cnn1", "dense2", "cnn2", "dense3", "fc")


def export_native_vad(model, outdir: str) -> None:
    """Write the artifact of an ``OnlineVAD``'s voice-logit head
    (``cpp/serving``'s ``vad_native_model``); the ``audio_voice_mask``
    head is for training only and is left out."""
    from tensorflowasr_tpu_torch.models.vad import OnlineVAD

    if not isinstance(model, OnlineVAD):
        raise ValueError("native VAD export supports OnlineVAD (the causal "
                         "streaming variant the serving sessions use)")
    params = _nested(model)["params"]
    tensors = [(f"params/{name}/{leaf}", params[name][leaf])
               for name in VAD_LAYERS for leaf in ("kernel", "bias")]
    _write(outdir, {"kind": "vad", "dmodel": model.dmodel,
                    "frame_input": model.frame_input}, tensors)


def export_native_chunk(model, outdir: str,
                        phone_vocab: Optional[str] = None,
                        char_vocab: Optional[str] = None) -> None:
    """Write the artifact of the streaming ``ChunkConformer`` pipeline
    (``cpp/serving`` ``asr_chunk``)."""
    c = model.cfg
    tree = _nested(model)
    params = tree["params"]
    tensors = _tensors(tree)
    dft, fb = _frontend(c, "valid")
    tensors.append(("frontend/dft", dft))
    if c.mel_layer_trainable and "front" in params and \
            "freq2mel" in params.get("front", {}):
        fb = np.asarray(params["front"]["freq2mel"])
    tensors.append(("frontend/freq2mel", fb))
    config = {
        "kind": "chunk",
        "dmodel": c.dmodel, "reduction_factor": c.reduction_factor,
        "sample_rate": c.sample_rate, "n_mels": c.n_mels,
        "stride_ms": c.stride_ms, "chunk_num": c.chunk_num, "n_fft": 1024,
        "num_phone_classes": model.num_phone_classes,
        "num_char_classes": model.num_char_classes,
    }
    for name, st in (("enc", c.encoder), ("pk", c.picker),
                     ("dec", c.decoder), ("hlp", c.helper)):
        config.update({
            f"{name}_dmodel": st.dmodel,
            f"{name}_num_blocks": st.num_blocks,
            f"{name}_head_size": st.head_size,
            f"{name}_num_heads": st.num_heads,
            f"{name}_kernel_size": st.kernel_size,
            f"{name}_fc_factor": st.fc_factor,
            f"{name}_win_front": st.win_front,
            f"{name}_win_back": st.win_back,
        })
    _write(outdir, config, tensors,
           ((phone_vocab, "phones.txt"), (char_vocab, "chars.txt")))


def read_native(outdir: str) -> Dict[str, np.ndarray]:
    """An artifact read back through its manifest: {name: f32 array}."""
    with open(os.path.join(outdir, "manifest.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    raw = np.fromfile(os.path.join(outdir, "weights.bin"), np.float32)
    out = {}
    for t in manifest["tensors"]:
        start = t["offset"] // 4
        n = int(np.prod(t["shape"], dtype=np.int64))
        out[t["name"]] = raw[start:start + n].reshape(t["shape"])
    return out
