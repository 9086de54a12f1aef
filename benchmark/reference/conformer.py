"""Plain PyTorch ConformerCTC: TensorflowASR's offline acoustic model and
its training objective, the reference of the ``conformer_s`` cells.

wav -> 'same' log-mel -> conv subsampling (time / 4) -> N Conformer blocks
-> CTC head (Dense, M blocks, Dense to the phones, blank last) and the
non-autoregressive translator (phone embedding -> cross-attention blocks
with a sin / cos PE on the queries -> Dense to the chars).

Training objective (one step): CTC with a 1e-7 probability floor; the
translator on the label phones (+ 5 zero pads) and on the greedy CTC
decode, each scored by ``mask_loss`` (mean CE + the batch means over
non-pad and pad positions); loss = mean(ctc + 2 (2 label + decoded)); Adam.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from reference import blocks as B
from reference.frontend import log_mel


def _block_params(spec, p: str, d: int, k: int, cross: bool = False):
    for ff in ("ff_module_1", "ff_module_2"):
        spec[f"{p}.{ff}.ln.weight"] = ((d,), "one")
        spec[f"{p}.{ff}.ln.bias"] = ((d,), "zero")
        spec[f"{p}.{ff}.ffn1.weight"] = ((4 * d, d), "dense")
        spec[f"{p}.{ff}.ffn1.bias"] = ((4 * d,), "zero")
        spec[f"{p}.{ff}.ffn2.weight"] = ((d, 4 * d), "dense")
        spec[f"{p}.{ff}.ffn2.bias"] = ((d,), "zero")
    a = f"{p}.{'rmhsa' if cross else 'mhsa'}"
    spec[f"{a}.ln.weight"] = ((d,), "one")
    spec[f"{a}.ln.bias"] = ((d,), "zero")
    for proj in ("query", "key", "value", "out"):
        spec[f"{a}.mha.{proj}.weight"] = ((d, d), "attn_out" if proj == "out"
                                          else "attn_in")
        spec[f"{a}.mha.{proj}.bias"] = ((d,), "zero")
    c = f"{p}.conv_module"
    spec[f"{c}.ln.weight"] = ((d,), "one")
    spec[f"{c}.ln.bias"] = ((d,), "zero")
    spec[f"{c}.pw_conv_1.weight"] = ((2 * d, d), "dense")
    spec[f"{c}.pw_conv_1.bias"] = ((2 * d,), "zero")
    spec[f"{c}.dw_conv.weight"] = ((d, 1, k), "depthwise")
    spec[f"{c}.dw_conv.bias"] = ((d,), "zero")
    spec[f"{c}.dw_pw.weight"] = ((2 * d, d), "dense")
    spec[f"{c}.dw_pw.bias"] = ((2 * d,), "zero")
    spec[f"{c}.bn.weight"] = ((2 * d,), "one")
    spec[f"{c}.bn.bias"] = ((2 * d,), "zero")
    spec[f"{c}.bn.running_mean"] = ((2 * d,), "zero")
    spec[f"{c}.bn.running_var"] = ((2 * d,), "one")
    spec[f"{c}.pw_conv_2.weight"] = ((d, 2 * d), "dense")
    spec[f"{c}.pw_conv_2.bias"] = ((d,), "zero")
    spec[f"{p}.ln.weight"] = ((d,), "one")
    spec[f"{p}.ln.bias"] = ((d,), "zero")


def subsampling_params(spec, p: str, d: int, f_out: int):
    spec[f"{p}.conv1.weight"] = ((d, 1, 3, 3), "conv")
    spec[f"{p}.conv1.bias"] = ((d,), "zero")
    spec[f"{p}.conv2.weight"] = ((d, d, 3, 3), "conv")
    spec[f"{p}.conv2.bias"] = ((d,), "zero")
    spec[f"{p}.linear.weight"] = ((d, f_out * d), "dense")
    spec[f"{p}.linear.bias"] = ((d,), "zero")


def param_spec(m: dict, n_phone: int, n_char: int) -> "OrderedDict":
    """name -> (shape, kind) of every weight and statistic, in the model's
    order."""
    d, k = m["dmodel"], m["kernel_size"]
    n_mels = m["num_feature_bins"]
    spec = OrderedDict()
    subsampling_params(spec, "encoder.conv_subsampling", d,
                       -(-(-(-n_mels // 2)) // 2))
    for i in range(m["num_blocks"]):
        _block_params(spec, f"encoder.blocks.{i}", d, k)
    spec["ctc_decoder.project.weight"] = ((d, d), "dense")
    spec["ctc_decoder.project.bias"] = ((d,), "zero")
    for i in range(m["ctcdecoder_num_blocks"]):
        _block_params(spec, f"ctc_decoder.blocks.{i}", d,
                      m["ctcdecoder_kernel_size"])
    spec["ctc_decoder.fully_connected.weight"] = ((n_phone, d), "dense")
    spec["ctc_decoder.fully_connected.bias"] = ((n_phone,), "zero")
    spec["translator.inp_embedding.weight"] = ((n_phone, d), "embedding")
    for i in range(m["translator_num_blocks"]):
        _block_params(spec, f"translator.blocks.{i}", d,
                      m["translator_kernel_size"], cross=True)
    spec["translator.fully_connected.weight"] = ((n_char, d), "dense")
    spec["translator.fully_connected.bias"] = ((n_char,), "zero")
    return spec


class Conformer:
    """The forward passes over weights ``W`` at precision ``P``. With a
    ``Drop`` (training mode) dropout is drawn and BatchNorm uses the batch
    moments; without one, eval mode."""

    def __init__(self, W: Dict[str, torch.Tensor], m: dict,
                 P: B.Prec = B.F32):
        self.W, self.m, self.P = W, m, P
        self.heads = m["num_heads"]
        self.rf = m["reduction_factor"]
        self.hop = m["sample_rate"] * m["stride_ms"] // 1000

    def _block(self, p, x, d, training, enc=None):
        W, P = self.W, self.P
        x = B.ff_module(W, p + ".ff_module_1", x, P, d, self.m["fc_factor"])
        if enc is None:
            y = B.layer_norm(W, p + ".mhsa.ln", x)
            x = x + B.drop(d, B.attention(W, p + ".mhsa.mha", y, y, P,
                                          self.heads))
        else:
            pe = B.positional_encoding(x.shape[1], x.shape[2], x.device)
            y = B.layer_norm(W, p + ".rmhsa.ln", x + pe)
            x = x + B.drop(d, B.attention(W, p + ".rmhsa.mha", y, enc, P,
                                          self.heads))
        x = B.conv_module(W, p + ".conv_module", x, P, d, training,
                          causal=False)
        x = B.ff_module(W, p + ".ff_module_2", x, P, d, self.m["fc_factor"])
        return B.layer_norm(W, p + ".ln", x)

    def encode(self, wav: torch.Tensor, d: Optional[B.Drop] = None
               ) -> torch.Tensor:
        """int16 or f32 wav [B, T] -> [B, ceil(T / 640), dmodel]."""
        if wav.dtype == torch.int16:
            wav = wav.to(torch.float32) / 32768.0
        mel = log_mel(wav, same=True, hop=self.hop,
                      n_mels=self.m["num_feature_bins"])
        strides = ((self.rf // 2, 2), (2, 2))
        pads, t, f = [], mel.shape[1], mel.shape[2]
        for st in strides:
            pads.append((*B.same_pad(t, 3, st[0]), *B.same_pad(f, 3, st[1])))
            t, f = -(-t // st[0]), -(-f // st[1])
        x = B.conv_subsampling(self.W, "encoder.conv_subsampling", mel,
                               self.P, d, pads, strides)
        for i in range(self.m["num_blocks"]):
            x = self._block(f"encoder.blocks.{i}", x, d, d is not None)
        return x

    def ctc_logits(self, enc, d: Optional[B.Drop] = None) -> torch.Tensor:
        x = B.dense(self.W, "ctc_decoder.project", enc, self.P)
        for i in range(self.m["ctcdecoder_num_blocks"]):
            x = self._block(f"ctc_decoder.blocks.{i}", x, d, d is not None)
        return B.dense(self.W, "ctc_decoder.fully_connected", x, self.P,
                       head=True)

    def translate(self, ids, enc, d: Optional[B.Drop] = None
                  ) -> torch.Tensor:
        x = self.W["translator.inp_embedding.weight"][ids.long()]
        for i in range(self.m["translator_num_blocks"]):
            x = self._block(f"translator.blocks.{i}", x, d, d is not None,
                            enc=enc)
        return B.dense(self.W, "translator.fully_connected", x, self.P,
                       head=True)


# ---------------------------------------------------------------------------
# greedy CTC and the training objective
# ---------------------------------------------------------------------------

def collapse(ids: torch.Tensor, lengths: torch.Tensor, blank: int):
    """Frame ids [B, T] -> (merged repeats without blanks, left-justified in
    [B, T] and zero padded; their counts [B])."""
    t = ids.shape[1]
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], 1)
    valid = torch.arange(t, device=ids.device)[None] < lengths[:, None]
    keep = valid & (ids != blank) & (ids != prev)
    out = torch.zeros_like(ids)
    for r in range(ids.shape[0]):
        kept = ids[r][keep[r]]
        out[r, :kept.numel()] = kept
    return out, keep.sum(1)


def mask_loss(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    ce = F.cross_entropy(logits.transpose(1, 2), labels.long(),
                         reduction="none")
    need = (labels != 0).to(torch.float32)
    pad = (labels == 0).to(torch.float32)
    return (ce.mean(dim=-1) + (ce * need).sum() / (need.sum() + 1e-6)
            + (ce * pad).sum() / (pad.sum() + 1e-6))


def train_loss(model: Conformer, batch: Dict[str, torch.Tensor], d: B.Drop,
               rows: Optional[int] = None) -> torch.Tensor:
    """The mean training loss of one batch (training mode, dropout from
    ``d``). ``rows`` keeps only the first rows (a planted fault)."""
    blank = model.W["ctc_decoder.fully_connected.weight"].shape[0] - 1
    if rows is not None:
        batch = {k: v[:rows] for k, v in batch.items()}
    enc = model.encode(batch["wav"], d)
    logits = model.ctc_logits(enc, d)
    ids = torch.argmax(logits.detach(), dim=-1)
    decoded, _ = collapse(ids, batch["input_length"], blank)
    label_out = model.translate(F.pad(batch["phones"], (0, 5)), enc, d)
    ctc_out = model.translate(decoded, enc, d)
    logp = torch.logaddexp(F.log_softmax(logits, dim=-1),
                           torch.tensor(1e-7, device=logits.device).log())
    ctc = F.ctc_loss(logp.transpose(0, 1), batch["phones"].long(),
                     batch["input_length"].long(),
                     batch["phone_length"].long(), blank=blank,
                     reduction="none", zero_infinity=True)
    u = batch["chars"].shape[1]
    translate = 2.0 * mask_loss(batch["chars"], label_out[:, :u]) \
        + mask_loss(batch["chars"], ctc_out[:, :u])
    return (ctc + 2.0 * translate).mean()


class Adam:
    """Adam with bias correction: p -= lr m^ / (sqrt(v^) + eps)."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float, moments=None, t: int = 0):
        self.params, self.lr, self.b1, self.b2, self.eps = \
            params, lr, b1, b2, eps
        if moments is None:
            moments = [(torch.zeros_like(p), torch.zeros_like(p))
                       for p in params]
        self.m = [m.detach().clone() for m, _ in moments]
        self.v = [v.detach().clone() for _, v in moments]
        self.t = int(t)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))


def train_steps(W: Dict[str, torch.Tensor], m: dict, opt: dict,
                batches: List[Dict[str, torch.Tensor]],
                generator: torch.Generator, P: B.Prec = B.F32,
                rows: Optional[int] = None, moments=None) -> dict:
    """Run len(batches) training steps from weights ``W`` (not modified)
    and, where given, Adam's ``moments`` = ({name: (m, v)}, updates made).
    Returns {"loss": [...], "grad1": {name: first gradient}, "delta": {name:
    change of each parameter after the last step}}."""
    names = [k for k, v in W.items()
             if not k.endswith(("running_mean", "running_var"))]
    params = {k: W[k].detach().clone().requires_grad_(True) for k in names}
    start = {k: W[k].detach().clone() for k in names}
    work = dict(W)
    work.update(params)
    model = Conformer(work, m, P)
    by_name, t = moments if moments is not None else (None, 0)
    adam = Adam([params[k] for k in names], opt["lr"], opt["beta1"],
                opt["beta2"], opt["epsilon"],
                None if by_name is None else [by_name[k] for k in names], t)
    drop = B.Drop(m["dropout"], generator)
    losses, grad1 = [], None
    for batch in batches:
        loss = train_loss(model, batch, drop, rows)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        if grad1 is None:
            grad1 = {k: g.detach().clone() for k, g in zip(names, grads)}
        adam.step(list(grads))
        losses.append(float(loss.detach()))
    delta = {k: (params[k].detach() - start[k]) for k in names}
    return {"loss": losses, "grad1": grad1, "delta": delta}


@torch.no_grad()
def greedy(logits: torch.Tensor, lengths: torch.Tensor, blank: int):
    """Greedy CTC: (ids [B, T] left-justified, zero padded; lengths)."""
    return collapse(torch.argmax(logits, -1), lengths, blank)


@torch.no_grad()
def calibrate(W: Dict[str, torch.Tensor], m: dict, wav: torch.Tensor,
              blank: int) -> float:
    """Make a random model tell frames apart and emit phones like a trained
    one (in place). The 'same' log-mel is never positive, so a random first
    conv sees one pattern at many scales and every frame ends alike: its
    bias moves by the conv of the log-mel's mean on ``wav``, which centres
    it. A random CTC head then emits blank everywhere or nowhere: the blank
    bias moves by the median margin of the blank logit over the other
    classes on ``wav``, after which about half the frames are blank.
    Returns the blank bias's move."""
    hop = m["sample_rate"] * m["stride_ms"] // 1000
    mean = log_mel(wav, same=True, hop=hop, n_mels=m["num_feature_bins"]
                   ).mean()
    w = W["encoder.conv_subsampling.conv1.weight"]
    W["encoder.conv_subsampling.conv1.bias"] -= mean * w.sum(dim=(1, 2, 3))
    model = Conformer(W, m)
    logits = model.ctc_logits(model.encode(wav))
    margin = (logits[..., blank] - logits[..., :blank].amax(-1)).median()
    W["ctc_decoder.fully_connected.bias"][blank] -= margin
    return -float(margin)
