"""Plain PyTorch ChunkConformer (SMLTA2-style chunk streaming), offline: the
reference of the ``chunk_conformer_s`` cells.

wav -> 'valid' (causal) log-mel -> causal conv subsampling (time / 4) ->
encoder stack -> phone picker (Dense, stack, Dense to the phones, blank
last) -> the frames whose phone is not blank, in order -> helper stack ->
char decoder (Dense, stack, Dense to the chars).

A stack's blocks are Conformer blocks whose self-attention is banded
(query i sees keys [i - win_front, i + win_back], with TensorflowASR's edge
rule) and whose depthwise conv is causal. Streaming from a cold start gives
the offline outputs, so the served ids of a stream are judged against this
offline pass over the stream's audio.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch

from reference import blocks as B
from reference.conformer import _block_params, subsampling_params
from reference.frontend import log_mel

STACKS = (("encoder", "encoder.blocks"),
          ("picker", "phone_picker.stack.blocks"),
          ("helper", "helper.stack.blocks"),
          ("decoder", "decoder.stack.blocks"))


def param_spec(m: dict, n_phone: int, n_char: int) -> "OrderedDict":
    d = m["dmodel"]
    spec = OrderedDict()
    f_out = ((m["n_mels"] + 4 - 3) // 2 + 1 - 3) // 2 + 1
    subsampling_params(spec, "front.conv_subsampling", d, f_out)
    for i in range(m["encoder"]["num_blocks"]):
        _block_params(spec, f"encoder.blocks.{i}", d,
                      m["encoder"]["kernel_size"])
    for head, n_out, key in (("phone_picker", n_phone, "picker"),
                             ("decoder", n_char, "decoder")):
        spec[f"{head}.project.weight"] = ((d, d), "dense")
        spec[f"{head}.project.bias"] = ((d,), "zero")
        for i in range(m[key]["num_blocks"]):
            _block_params(spec, f"{head}.stack.blocks.{i}", d,
                          m[key]["kernel_size"])
        spec[f"{head}.fully_connected.weight"] = ((n_out, d), "dense")
        spec[f"{head}.fully_connected.bias"] = ((n_out,), "zero")
    spec["helper.sample_helper.weight"] = ((n_phone, d), "embedding")
    for i in range(m["helper"]["num_blocks"]):
        _block_params(spec, f"helper.stack.blocks.{i}", d,
                      m["helper"]["kernel_size"])
    return spec


def band(length: int, win_front: int, win_back: int, device
         ) -> torch.Tensor:
    """[length, length] keys each query sees, with the edge rule: near the
    end a window keeps win_back keys ahead by reaching further back, near
    the start it keeps its width by reaching further ahead."""
    p = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    low = torch.clamp_min(p - win_front, 0)
    high = torch.clamp_max(p + win_back, length)
    low = low - torch.clamp_min(low - (length - win_back), 0)
    high = high + torch.clamp_min(win_back - high, 0)
    return (j >= low) & (j <= high)


class ChunkModel:
    """Offline forward passes (eval mode) over weights ``W`` at ``P``."""

    def __init__(self, W: Dict[str, torch.Tensor], m: dict,
                 P: B.Prec = B.F32):
        self.W, self.m, self.P = W, m, P
        self.hop = m["sample_rate"] * m["stride_ms"] // 1000

    def stack(self, key: str, x: torch.Tensor) -> torch.Tensor:
        s = self.m[key]
        prefix = dict(STACKS)[key]
        mask = band(x.shape[1], s["win_front"], s["win_back"], x.device)
        W, P = self.W, self.P
        for i in range(s["num_blocks"]):
            p = f"{prefix}.{i}"
            x = B.ff_module(W, p + ".ff_module_1", x, P, None,
                            s["fc_factor"])
            y = B.layer_norm(W, p + ".mhsa.ln", x)
            x = x + B.attention(W, p + ".mhsa.mha", y, y, P, s["num_heads"],
                                mask[None, None])
            x = B.conv_module(W, p + ".conv_module", x, P, None, False,
                              causal=True)
            x = B.ff_module(W, p + ".ff_module_2", x, P, None,
                            s["fc_factor"])
            x = B.layer_norm(W, p + ".ln", x)
        return x

    def front(self, wav: torch.Tensor) -> torch.Tensor:
        mel = log_mel(wav, same=False, hop=self.hop, n_mels=self.m["n_mels"])
        rf = self.m["reduction_factor"]
        return B.conv_subsampling(self.W, "front.conv_subsampling", mel,
                                  self.P, None,
                                  ((rf, 0, 2, 2), (0, 0, 0, 0)),
                                  ((rf // 2, 2), (2, 2)))

    def phones(self, wav: torch.Tensor):
        """f32 wav [B, T] -> (phone logits [B, T', Vp], picker hidden)."""
        x = self.stack("encoder", self.front(wav))
        h = self.stack("picker", B.dense(self.W, "phone_picker.project", x,
                                          self.P))
        return B.dense(self.W, "phone_picker.fully_connected", h, self.P,
                       head=True), h

    def chars(self, picked: torch.Tensor) -> torch.Tensor:
        """Picked hidden rows [1, n, d] -> char logits [1, n, Vc]."""
        h = self.stack("helper", picked)
        h = self.stack("decoder", B.dense(self.W, "decoder.project", h,
                                          self.P))
        return B.dense(self.W, "decoder.fully_connected", h, self.P,
                       head=True)


@torch.no_grad()
def calibrate(W: Dict[str, torch.Tensor], m: dict, wav: torch.Tensor,
              first_conv_gain: float, blank: int) -> float:
    """Make a random model pick like a trained one (in place): the first
    conv's weights gain ``first_conv_gain`` (the 'valid' log-mel is not
    normalised and spans about 0.1, so every frame would look alike), and
    the picker's blank bias moves by the median margin of the blank logit
    over the other classes on ``wav`` (a random picker keeps every frame
    or none; after this about half). Returns the bias's move."""
    W["front.conv_subsampling.conv1.weight"].mul_(first_conv_gain)
    logits, _ = ChunkModel(W, m).phones(wav)
    margin = (logits[..., blank] - logits[..., :blank].amax(-1)).median()
    W["phone_picker.fully_connected.bias"][blank] -= margin
    return -float(margin)


@torch.no_grad()
def stream_logits(model: ChunkModel, wav: torch.Tensor,
                  frame_ids: Optional[torch.Tensor], blank: int):
    """One stream's f32 wav [T]: (phone logits [T', Vp], char logits [n,
    Vc]) where the char decoder runs on the frames ``frame_ids`` [T'] did
    not mark blank (the stream's own picks)."""
    logits, hidden = model.phones(wav[None])
    if frame_ids is None:
        frame_ids = torch.argmax(logits[0], -1)
    keep = frame_ids.to(logits.device) != blank
    picked = hidden[0][keep][None]
    if picked.shape[1] == 0:
        return logits[0], logits.new_zeros((0, model.W[
            "decoder.fully_connected.weight"].shape[0]))
    return logits[0], model.chars(picked)[0]
