"""Batch transcription with an E-Branchformer CTC: the port's
``make_predict_step`` (the 'same' log-mel, subsampling, relative positions
and E-Branchformer blocks, CTC head and greedy decode, translator) on
padded batches made in set-up, each batch's frame lengths handed to the
encoder so that its padded keys are masked; each batch is uploaded,
decoded, and its ids fetched to the host, as ``cli.eval_am`` does.

The program's model is ``models/ebranchformer.py::EBranchformerCTC``; a
program without it fails at once in set-up (ImportError). A traced run
also puts the device time under the program's branch ranges
(``tasr.ebranchformer.attention`` / ``.cgmlp`` / ``.merge``) into the
record, for the per-layer readers.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from benchlib import ebranchformer_flops, judge, program, tracing, traffic
from benchlib import weights
from reference import blocks
from reference import conformer as conformer_ref
from reference import ebranchformer as ref

TRANSLATOR_PAD = 10
BRANCHES = ("ebranchformer.attention", "ebranchformer.cgmlp",
            "ebranchformer.merge")


def make_weights(config: dict, m: dict, seed: int, device: torch.device):
    """The configuration's law, then the reference's calibration on gated
    tones drawn from the seed (as ``weights.conformer``)."""
    n_phone = config["num_phone_classes"]
    spec = ref.param_spec(m, n_phone, config["num_char_classes"])
    wcfg = config["weights"]
    w = weights.make(spec, wcfg["law"], seed, device, m["num_heads"])
    rng = traffic.rng_for(seed, 5)
    n = int(wcfg["calibration_seconds"] * traffic.SR)
    wav = np.stack([traffic.tones(n, rng)
                    for _ in range(int(wcfg["calibration_signals"]))])
    ref.calibrate(w, m, torch.from_numpy(wav).to(device), n_phone - 1)
    return w


def branch_device_s(prof) -> dict:
    """Device seconds of the operations launched inside each of the
    program's ``tasr.<branch>`` ranges, read from the profiler's raw events
    as ``tracing.summarize`` reads its ``tasr::`` ranges."""
    cuda = torch.autograd.DeviceType.CUDA
    wanted = {"tasr." + b: b for b in BRANCHES}
    dev, launches = [], []
    ranges = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and not name.startswith(
                    ("Optimizer.", "bench.")):
                dev.append((e.end_ns() - e.start_ns(),
                            e.linked_correlation_id()))
        elif name in wanted:
            ranges[e.start_thread_id()].append(
                (e.start_ns(), e.end_ns(), wanted[name]))
        else:
            launches.append((e.start_ns(), e.end_ns(), e.start_thread_id(),
                             e.correlation_id()))
    for lst in ranges.values():
        lst.sort()
    under = {}
    for s, e, t, corr in launches:
        lst = ranges.get(t)
        if lst:
            i = bisect.bisect_right(lst, (s, float("inf"), "")) - 1
            if i >= 0 and lst[i][1] >= e:
                under[corr] = lst[i][2]
    out = dict.fromkeys(BRANCHES, 0.0)
    for ns, link in dev:
        if link in under:
            out[under[link]] += ns / 1e9
    return out


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        c = ctx.config
        self.m = program.reference_sizes(c)
        self.n_phone, self.n_char = c["num_phone_classes"], \
            c["num_char_classes"]
        self.blank = self.n_phone - 1
        self.clock = None

    def setup(self):
        # the program's model first: a program without it fails at once
        from tensorflowasr_tpu_torch.models.ebranchformer import (
            EBranchformerConfig,
            EBranchformerCTC,
        )
        from tensorflowasr_tpu_torch.train.asr_trainer import (
            make_predict_step,
        )
        c, mix, dev = self.ctx.config, self.ctx.traffic, self.ctx.device
        self.phases = ph = tracing.Phases()
        sizes = program.batch_sizes(c, self.m)
        self.batches = traffic.warm_order(
            traffic.batches(mix, sizes, self.ctx.seed, dev), 0)
        for b in self.batches:
            b["flops"] = ebranchformer_flops.predict(
                b["wav"].shape[0], b["wav"].shape[1], self.m, self.n_phone,
                self.n_char, TRANSLATOR_PAD)
        ph.mark("traffic")
        self.w0 = make_weights(c, self.m, self.ctx.seed, dev)
        ph.mark("weights")
        cfg = EBranchformerConfig.from_user_config(
            {"model_config": c["model_config"],
             "speech_config": c["speech_config"]}, c["dtype"])
        with torch.device(dev):
            model = EBranchformerCTC(cfg, self.n_phone, self.n_char)
        model.load_state_dict(self.w0, strict=True)
        self.state = SimpleNamespace(model=model.eval())
        self.predict = make_predict_step(self.blank)
        self.outputs = {}
        ph.mark("model")
        seen = set()
        for k, b in enumerate(self.batches):          # one batch a shape
            if b["bucket_s"] not in seen:
                seen.add(b["bucket_s"])
                self._batch(k)
        self.outputs = {}
        ph.mark("warm")

    def _batch(self, k: int):
        b, dev, spans = self.batches[k], self.ctx.device, self.ctx.spans
        with spans("upload"):
            wav = torch.from_numpy(b["wav"]).to(dev)
            lengths = torch.from_numpy(b["input_length"]).to(dev)
        with spans("predict"):
            ids, lens, chars = self.predict(self.state, wav, lengths)
        with spans("fetch"):
            out = (ids.cpu().numpy(), lens.cpu().numpy(), chars.cpu().numpy())
        if self.ctx.fault == "alter_token":
            out[2][0, 0] = (out[2][0, 0] + 1) % self.n_char
        self.outputs[k] = out

    def window(self, clock):
        self.clock = clock
        spans, n = self.ctx.spans, 0
        t0 = clock.start()
        while clock.poll():
            at = time.perf_counter()
            k = n % len(self.batches)
            self._batch(k)
            n += 1
            b = self.batches[k]
            spans.count("audio_s", float(b["seconds"].sum()), at)
            spans.count("flops", b["flops"], at)
        wall = time.perf_counter() - t0
        audio = sum(v for _, v in spans.counts["audio_s"])
        return {"attempted": n, "wall_s": wall, "audio_s": audio}

    def end_to_end(self, rec):
        return {"decode_audio_s_per_s": rec["audio_s"] / rec["wall_s"]}

    def sample(self) -> list:
        """The judged batches: the one with the longest utterance and a
        draw from the seed among the others that completed."""
        return judge.sample(sorted(self.outputs),
                            lambda k: self.batches[k]["seconds"].max(),
                            int(self.ctx.traffic["judged_batches"]),
                            self.ctx.seed)

    def judge(self, rec):
        if self.clock is not None and self.clock.prof is not None:
            rec["branch_device_s"] = branch_device_s(self.clock.prof)
        self.state = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        numbers, failed = {"phone_gap": 0.0, "char_gap": 0.0}, 0
        sample = self.sample()
        for k in sample:
            got = self.readings(k, blocks.F32)
            numbers = {n: max(numbers[n], got[n]) for n in numbers}
            failed += any(got[n] > self.ctx.limits[n] for n in numbers)
        lens = np.concatenate([self.outputs[k][1] for k in sample])
        chars = np.concatenate([self.outputs[k][2].ravel() for k in sample])
        print(f"decode_ebf: judged {len(sample)} batches, {len(lens)} rows, "
              f"{lens.mean():.1f} phones a row, {len(np.unique(chars))} "
              f"distinct chars", file=sys.stderr)
        return numbers, failed

    def _reference(self, k: int, prec):
        b, dev = self.batches[k], self.ctx.device
        model = ref.EBranchformer(self.w0, self.m, prec)
        lengths = torch.from_numpy(b["input_length"]).to(dev)
        enc = model.encode(torch.from_numpy(b["wav"]).to(dev), lengths)
        return model, enc, lengths

    @torch.no_grad()
    def readings(self, k: int, prec) -> dict:
        """The gaps of batch k's served phones and chars under the
        reference at ``prec``."""
        b, dev = self.batches[k], self.ctx.device
        ids, lens, chars = self.outputs[k]
        model, enc, _ = self._reference(k, prec)
        logits = model.ctc_logits(enc).float().cpu().numpy()
        served = torch.from_numpy(ids).to(dev).long()
        char_logits = model.translate(F.pad(served, (0, TRANSLATOR_PAD)),
                                      enc).float().cpu().numpy()
        out = {"phone_gap": 0.0, "char_gap": 0.0}
        for r in range(ids.shape[0]):
            n = int(b["input_length"][r])
            seq = ids[r, :int(lens[r])]
            pg = judge.ctc_gap(logits[r, :n], seq, self.blank) \
                if int(lens[r]) <= ids.shape[1] else judge.INF
            if np.any(ids[r, int(lens[r]):] != 0):
                pg = judge.INF
            cg = judge.frame_gap(char_logits[r], chars[r])
            out["phone_gap"] = max(out["phone_gap"], pg)
            out["char_gap"] = max(out["char_gap"], cg)
        return out

    @torch.no_grad()
    def control(self, prec) -> dict:
        """The tokens the reference at ``prec`` puts first, judged by the
        f32 reference: the greedy phones, and the chars the translator
        gives on the served phones."""
        out = {"phone_gap": 0.0, "char_gap": 0.0}
        dev = self.ctx.device
        for k in self.sample():
            b = self.batches[k]
            ids = torch.from_numpy(self.outputs[k][0]).to(dev).long()
            got = []
            for p in (blocks.F32, prec):
                model, enc, lengths = self._reference(k, p)
                got.append((model.ctc_logits(enc), model.translate(
                    F.pad(ids, (0, TRANSLATOR_PAD)), enc)))
            lo_ids, lo_lens = conformer_ref.greedy(got[1][0], lengths,
                                                   self.blank)
            l32, c32 = (x.float().cpu().numpy() for x in got[0])
            c_lo = got[1][1].argmax(-1).cpu().numpy()
            lo_ids, lo_lens = lo_ids.cpu().numpy(), lo_lens.cpu().numpy()
            for r in range(ids.shape[0]):
                n = int(b["input_length"][r])
                out["phone_gap"] = max(out["phone_gap"], judge.ctc_gap(
                    l32[r, :n], lo_ids[r, :lo_lens[r]], self.blank))
                out["char_gap"] = max(out["char_gap"],
                                      judge.frame_gap(c32[r], c_lo[r]))
        return out
