"""Weight bridge between flax ``ConformerCTC`` / ``ChunkConformer`` / VAD /
punctuation variables and the torch ``state_dict``, both ways.

The flax tree ``{"params": ..., "batch_stats": ...}`` arrives as nested
dicts of numpy arrays (or flattened to ``params/encoder/.../kernel`` names,
the layout ``tensorflowasr_tpu/export/native_export.py::_flatten`` writes).
The encoder stack may be unrolled (``conformer_block_{i}``) or scanned
(``conformer_blocks/scan/block`` with every leaf stacked on axis 0). A
``ChunkConformer``'s four stacks likewise hold ``block_{i}`` children, or
one ``block`` child whose leaves are stacked on axis 0 (``scan_layers``);
both become ``blocks.{i}``.

Layout changes, by leaf:

- Dense ``kernel`` [in, out]            -> ``weight`` [out, in]
- MHA q/k/v ``kernel`` [d, h, hd]       -> ``weight`` [h*hd, d]
- MHA out ``kernel`` [h, hd, d]         -> ``weight`` [d, h*hd]
- MHA bias [h, hd]                      -> [h*hd]
- Conv ``kernel`` HWIO                  -> ``weight`` OIHW
- 1-D Conv ``kernel`` [K, in, out]      -> ``weight`` [out, in, K], and so
  depthwise [K, 1, C]                   -> [C, 1, K] (neither flipped)
- LayerNorm / BatchNorm ``scale``       -> ``weight``
- BatchNorm stats ``mean`` / ``var``    -> ``running_mean`` / ``running_var``
- Embed ``embedding``                   -> ``weight``
- LEAF (``mel_layer/leaf``): ``preemp_kernel``, ``gabor_params``,
  ``pool_sigma``, ``norm_scale``, ``norm_bias`` and ``pcen/{alpha,delta,
  root,smooth}`` keep their names and layouts
- ``WavePickModel`` (``wav_layer``) is convs only: the 1-D conv rule

Every produced key must exist in the torch model and every model key must
be produced, with matching shapes; anything else raises.

The VAD and punctuation models (``models/vad.py``, ``models/punc.py``)
name their submodules as flax does, so the same leaf rules carry them
across: :func:`load_flax_variables` loads a flax tree into such a model,
checked key by key, and :func:`to_flax_names` reads one back.

A flax gradient tree has the layout of ``params``, so
``to_torch_names(flatten({"params": grads}))`` names each gradient leaf after
the torch parameter it belongs to. :func:`to_flax_names` is the inverse map
(a port model, any kind, back to the flattened flax layout), and
:func:`save_npz` writes it as the ``.npz`` that :func:`load_npz` and the JAX
package read.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Union

import numpy as np
import torch

from tensorflowasr_tpu_torch.models.chunk_conformer import (
    ChunkConformer,
    ChunkConformerConfig,
)
from tensorflowasr_tpu_torch.models.conformer import (
    ConformerConfig,
    ConformerCTC,
)
from tensorflowasr_tpu_torch.models.layers import MultiHeadAttention

_SCAN = "encoder/conformer_blocks/scan/block/"
_BLOCK = re.compile(r"(?:decoder_)?conformer_block_(\d+)$")
_CHUNK_BLOCK = re.compile(r"block_(\d+)$")

AnyConfig = Union[ConformerConfig, ChunkConformerConfig]

# the LEAF frontend's leaves, carried across as they are
_LEAF_PARAMS = frozenset({"preemp_kernel", "gabor_params", "pool_sigma",
                          "norm_scale", "norm_bias", "alpha", "delta",
                          "root", "smooth"})


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {"a/b/leaf": array} (native_export's names)."""
    if isinstance(tree, Mapping):
        out: Dict[str, np.ndarray] = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _unstack_scanned(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for name, arr in flat.items():
        coll, _, rest = name.partition("/")
        if rest.startswith(_SCAN):
            leaf = rest[len(_SCAN):]
            for i in range(arr.shape[0]):
                out[f"{coll}/encoder/conformer_block_{i}/{leaf}"] = arr[i]
        else:
            out[name] = arr
    return out


def _convert_leaf(path: list, arr: np.ndarray):
    """(flax module path + leaf name, array) -> (torch leaf name, array)."""
    leaf, parent = path[-1], path[-2] if len(path) > 1 else ""
    if "leaf" in path[:-1] and leaf in _LEAF_PARAMS:
        return leaf, arr
    if leaf == "kernel":
        if arr.ndim == 2:                                   # Dense
            return "weight", arr.T
        if arr.ndim == 4:                                   # Conv HWIO
            return "weight", arr.transpose(3, 2, 0, 1)
        if parent in ("query", "key", "value"):             # [d, h, hd]
            return "weight", arr.reshape(arr.shape[0], -1).T
        if parent == "out":                                 # [h, hd, d]
            return "weight", arr.reshape(-1, arr.shape[-1]).T
        if arr.ndim == 3:                                   # 1-D conv
            return "weight", arr.transpose(2, 1, 0)
        raise KeyError(f"unknown kernel layout at {'/'.join(path)} "
                       f"{arr.shape}")
    if leaf == "bias":
        return "bias", arr.reshape(-1)
    renamed = {"scale": "weight", "embedding": "weight",
               "mean": "running_mean", "var": "running_var",
               "freq2mel": "freq2mel"}
    if leaf not in renamed:
        raise KeyError(f"unknown leaf {'/'.join(path)}")
    return renamed[leaf], arr


def _torch_state(flat: Mapping[str, np.ndarray], block: re.Pattern
                 ) -> Dict[str, torch.Tensor]:
    """Unstacked flattened flax variables -> torch names: every path
    segment that ``block`` matches becomes ``blocks.{i}``."""
    state: Dict[str, torch.Tensor] = {}
    for name, arr in flat.items():
        coll, *path = name.split("/")
        if coll not in ("params", "batch_stats") or not path:
            raise KeyError(f"unexpected variable {name}")
        modules = [f"blocks.{m.group(1)}" if (m := block.match(p)) else p
                   for p in path[:-1]]
        leaf, value = _convert_leaf(path, np.asarray(arr, np.float32))
        key = ".".join(modules + [leaf])
        if key in state:
            raise KeyError(f"{name} maps onto {key} twice")
        state[key] = torch.from_numpy(np.array(value))
    return state


def to_torch_names(flat: Mapping[str, np.ndarray]
                   ) -> Dict[str, torch.Tensor]:
    """Flattened flax variables of any module of ``models/layers.py`` or
    ``models/conformer.py`` (``params/...`` and ``batch_stats/...`` names)
    -> that module's torch state_dict (f32 CPU tensors), unchecked."""
    return _torch_state(_unstack_scanned(dict(flat)), _BLOCK)


def _unstack_chunk(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    out = {}
    for name, arr in flat.items():
        parts = name.split("/")
        if "block" not in parts:
            items = [(name, arr)]
        else:
            i = parts.index("block")
            items = [("/".join(parts[:i] + [f"block_{layer}"]
                               + parts[i + 1:]), arr[layer])
                     for layer in range(arr.shape[0])]
        for key, value in items:
            if key in out:
                raise KeyError(f"{key} is given in both stack layouts")
            out[key] = value
    return out


def chunk_to_torch_names(flat: Mapping[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """Flattened flax variables of ``models/chunk_conformer.py``'s modules,
    in either stack layout -> the torch state_dict, unchecked."""
    return _torch_state(_unstack_chunk(dict(flat)), _CHUNK_BLOCK)


def convert_flat(flat: Mapping[str, np.ndarray], cfg: AnyConfig
                 ) -> Dict[str, torch.Tensor]:
    """Flattened flax ``ConformerCTC`` (or, for a ``ChunkConformerConfig``,
    ``ChunkConformer``) variables -> a strict state_dict."""
    if isinstance(cfg, ChunkConformerConfig):
        state = chunk_to_torch_names(flat)
    else:
        state = to_torch_names(flat)
    _check_against_model(state, cfg)
    return state


def convert_flax_variables(variables: Mapping, cfg: AnyConfig
                           ) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` nested numpy dicts -> a
    strict state_dict of the model ``cfg`` describes."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    return convert_flat(flatten(dict(variables)), cfg)


def load_npz(path: str, cfg: AnyConfig) -> Dict[str, torch.Tensor]:
    """A ``.npz`` of flattened flax variables -> a strict state_dict."""
    with np.load(path) as data:
        return convert_flat({k: data[k] for k in data.files}, cfg)


def _invert_leaf(module_path: str, leaf: str, arr: np.ndarray,
                 heads: Dict[str, tuple]):
    """(torch module path, torch leaf name, array) -> (collection, flax
    leaf name, array): :func:`_convert_leaf` backwards. ``heads`` maps each
    attention module's path to (num_heads, head_size)."""
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", leaf[len("running_"):], arr
    if leaf == "freq2mel" or (leaf in _LEAF_PARAMS
                              and "leaf" in module_path.split(".")):
        return "params", leaf, arr
    parent, _, name = module_path.rpartition(".")
    if parent in heads and name in ("query", "key", "value", "out"):
        h, hd = heads[parent]
        if leaf == "bias":
            return "params", "bias", arr if name == "out" \
                else arr.reshape(h, hd)
        if name == "out":                                   # [d, h*hd]
            return "params", "kernel", arr.T.reshape(h, hd, -1)
        return "params", "kernel", arr.T.reshape(-1, h, hd)
    if leaf == "bias":
        return "params", "bias", arr
    if name in ("inp_embedding", "sample_helper", "embedding"):
        return "params", "embedding", arr
    if arr.ndim == 1:                                       # norm scale
        return "params", "scale", arr
    if arr.ndim == 2:                                       # Dense
        return "params", "kernel", arr.T
    if arr.ndim == 4:                                       # Conv OIHW
        return "params", "kernel", arr.transpose(2, 3, 1, 0)
    if arr.ndim == 3:                                       # 1-D conv
        return "params", "kernel", arr.transpose(2, 1, 0)
    raise KeyError(f"unknown weight layout at {module_path}.{leaf} "
                   f"{arr.shape}")


def to_flax_names(model: torch.nn.Module,
                  scan_layers: bool = False) -> Dict[str, np.ndarray]:
    """A torch ``ConformerCTC``, ``ChunkConformer``, VAD or punctuation
    model -> its flattened flax variables (``params/...`` and
    ``batch_stats/...`` names, f32 numpy). With ``scan_layers`` the blocks
    are stacked on axis 0, the layout a JAX model built with
    ``scan_layers: true`` reads: under
    ``conformer_blocks/scan/block`` for the encoder of a ``ConformerCTC``,
    under each stack's ``block`` for a ``ChunkConformer``."""
    chunk = isinstance(model, ChunkConformer)
    heads = {name: (m.num_heads, m.head_size)
             for name, m in model.named_modules()
             if isinstance(m, MultiHeadAttention)}
    flat: Dict[str, np.ndarray] = {}
    for key, tensor in model.state_dict().items():
        module_path, _, leaf = key.rpartition(".")
        coll, flax_leaf, arr = _invert_leaf(
            module_path, leaf, tensor.detach().cpu().float().numpy(), heads)
        parts = module_path.split(".")
        name = "block_" if chunk else ("" if parts[0] == "encoder" else
                                       "decoder_") + "conformer_block_"
        path = re.sub(r"blocks/(\d+)", name + r"\1", "/".join(parts))
        flat[f"{coll}/{path}/{flax_leaf}"] = np.ascontiguousarray(arr)
    if not scan_layers:
        return flat
    stacked: Dict[str, list] = {}
    out: Dict[str, np.ndarray] = {}
    if chunk:
        block, scanned = re.compile(r"^(.*)/block_(\d+)/(.+)$"), "{}/block/{}"
    else:
        block = re.compile(r"^(\w+)/encoder/conformer_block_(\d+)/(.+)$")
        scanned = "{}/" + _SCAN + "{}"
    for name, arr in flat.items():
        m = block.match(name)
        if m:
            stacked.setdefault(scanned.format(m.group(1), m.group(3)),
                               []).append((int(m.group(2)), arr))
        else:
            out[name] = arr
    for name, items in stacked.items():
        out[name] = np.stack([a for _, a in sorted(items,
                                                   key=lambda it: it[0])])
    return out


def save_npz(model: Union[ConformerCTC, ChunkConformer], path: str,
             scan_layers: bool = False) -> None:
    """Write ``model``'s weights as the ``.npz`` of flattened flax variables
    that :func:`load_npz` reads back and the JAX package can unflatten."""
    np.savez(path, **to_flax_names(model, scan_layers))


def load_flax_variables(model: torch.nn.Module, variables: Mapping
                        ) -> torch.nn.Module:
    """Load ``{"params": ...}`` nested numpy dicts of the flax twin of
    ``model`` (a VAD or punctuation model, whose torch names are the flax
    names) into ``model``; every key and shape must match. Returns
    ``model``."""
    state = to_torch_names(flatten(dict(variables)))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state.items()}
    if got != want:
        bad = [(k, got[k], s) for k, s in want.items()
               if k in got and got[k] != s]
        raise KeyError(f"flax variables do not fit {type(model).__name__}: "
                       f"missing {sorted(set(want) - set(got))[:8]}, unused "
                       f"{sorted(set(got) - set(want))[:8]}, shapes (key, "
                       f"flax, torch) {bad[:8]}")
    model.load_state_dict(state)
    return model


_HEADS = {ConformerConfig: ("ctc_decoder", "translator", ConformerCTC),
          ChunkConformerConfig: ("phone_picker", "decoder", ChunkConformer)}


def num_classes(state: Mapping[str, torch.Tensor]):
    """(phone classes, char classes) read off the two output heads."""
    for phone, char, _ in _HEADS.values():
        if f"{phone}.fully_connected.weight" in state:
            return (state[f"{phone}.fully_connected.weight"].shape[0],
                    state[f"{char}.fully_connected.weight"].shape[0])
    raise KeyError("no phone head (ctc_decoder or phone_picker) in the "
                   "state_dict")


def _check_against_model(state: Mapping[str, torch.Tensor],
                         cfg: AnyConfig) -> None:
    phone, char, model_cls = _HEADS[type(cfg)]
    for head in (phone, char):
        if f"{head}.fully_connected.weight" not in state:
            raise KeyError(f"missing {head}/fully_connected")
    with torch.device("meta"):
        model = model_cls(cfg, *num_classes(state))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(want) - set(state))
    unused = sorted(set(state) - set(want))
    if missing or unused:
        raise KeyError(f"flax variables do not fit the model: missing "
                       f"{missing[:8]}{'...' if len(missing) > 8 else ''}, "
                       f"unused {unused[:8]}"
                       f"{'...' if len(unused) > 8 else ''}")
    bad = [(k, tuple(state[k].shape), s) for k, s in want.items()
           if tuple(state[k].shape) != s]
    if bad:
        raise ValueError(f"shape mismatch (key, flax, torch): {bad[:8]}")
