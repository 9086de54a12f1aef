"""Batch transcription: the port's ``make_predict_step`` (the 'same'
log-mel, subsampling, blocks, CTC head and greedy decode, translator) on
padded batches made in set-up; each batch is uploaded, decoded, and its
ids fetched to the host, as ``cli.eval_am`` does."""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from benchlib import flops, judge, program, tracing, traffic, weights
from reference import blocks
from reference import conformer as ref

TRANSLATOR_PAD = 10


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        c = ctx.config
        self.m = program.reference_sizes(c)
        self.n_phone, self.n_char = c["num_phone_classes"], \
            c["num_char_classes"]
        self.blank = self.n_phone - 1

    def setup(self):
        from tensorflowasr_tpu_torch.train.asr_trainer import make_predict_step
        c, mix, dev = self.ctx.config, self.ctx.traffic, self.ctx.device
        self.phases = ph = tracing.Phases()
        sizes = program.batch_sizes(c, self.m)
        self.batches = traffic.warm_order(
            traffic.batches(mix, sizes, self.ctx.seed, dev), 0)
        for b in self.batches:
            b["flops"] = flops.predict(b["wav"].shape[0], b["wav"].shape[1],
                                       self.m, self.n_phone, self.n_char)
            b["log_mel"] = flops.log_mel(b["wav"].shape[0], b["wav"].shape[1])
        ph.mark("traffic")
        self.w0 = weights.conformer(c, self.m, self.ctx.seed, dev)
        ph.mark("weights")
        self.state = SimpleNamespace(model=program.conformer(c, self.w0, dev))
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
            spans.count("log_mel_flop", b["log_mel"][0], at)
            spans.count("log_mel_bytes", b["log_mel"][1], at)
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
        print(f"decode: judged {len(sample)} batches, {len(lens)} rows, "
              f"{lens.mean():.1f} phones a row, {len(np.unique(chars))} "
              f"distinct chars", file=sys.stderr)
        return numbers, failed

    @torch.no_grad()
    def readings(self, k: int, prec) -> dict:
        """The gaps of batch k's served phones and chars under the
        reference at ``prec``."""
        b, dev = self.batches[k], self.ctx.device
        ids, lens, chars = self.outputs[k]
        model = ref.Conformer(self.w0, self.m, prec)
        enc = model.encode(torch.from_numpy(b["wav"]).to(dev))
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
            wav = torch.from_numpy(b["wav"]).to(dev)
            lengths = torch.from_numpy(b["input_length"]).to(dev)
            got = []
            for p in (blocks.F32, prec):
                model = ref.Conformer(self.w0, self.m, p)
                enc = model.encode(wav)
                got.append((model.ctc_logits(enc), model.translate(
                    F.pad(ids, (0, TRANSLATOR_PAD)), enc)))
            lo_ids, lo_lens = ref.greedy(got[1][0], lengths, self.blank)
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
