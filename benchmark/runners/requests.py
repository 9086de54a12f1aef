"""File requests from one caller, back to back: the port's
``OfflineASRSession(ASREngine(model)).transcribe_wav`` without VAD or
punctuation, as ``cli.test_asr`` runs it. Each 0.5 s piece is one B = 1
encode, then one decode of the joined encoder rows.

The session returns text; its char ids come back through a featurizer
that maps id i to one character. The phone ids that fed the translator
are taken from the engine's decode call as it returns them.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from benchlib import judge, program, tracing, traffic, weights
from reference import blocks
from reference import conformer as ref

MIN_PIECE = 400          # the session drops shorter trailing pieces
TRANSLATOR_PAD = 10
CHAR_BASE = 0x4E00


class IdText:
    """Char id i <-> one character; the end id stops a decode."""

    def __init__(self, end_id: int):
        self.end = end_id

    def endid(self) -> int:
        return self.end

    def iextract(self, i: int) -> str:
        return chr(CHAR_BASE + int(i))


def text_ids(text: str) -> list:
    return [ord(ch) - CHAR_BASE for ch in text]


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        c = ctx.config
        self.m = program.reference_sizes(c)
        self.n_phone, self.n_char = c["num_phone_classes"], \
            c["num_char_classes"]
        self.blank = self.n_phone - 1

    def setup(self):
        from tensorflowasr_tpu_torch.serve.engines import ASREngine
        from tensorflowasr_tpu_torch.serve.offline_session import (
            OfflineASRSession,
        )
        c, mix, dev = self.ctx.config, self.ctx.traffic, self.ctx.device
        self.phases = ph = tracing.Phases()
        self.files = traffic.files(mix, self.ctx.seed)
        ph.mark("traffic")
        self.w0 = weights.conformer(c, self.m, self.ctx.seed, dev)
        ph.mark("weights")
        model = program.conformer(c, self.w0, dev)
        self.engine = ASREngine(model, chunk_seconds=float(mix["piece_s"]),
                                sample_rate=self.m["sample_rate"],
                                text_featurizer=IdText(c["char_end_id"]))
        decode = self.engine._decode
        fault = self.ctx.fault

        def spied(enc_outputs, pad_chunks):
            out = decode(enc_outputs, pad_chunks)
            if fault == "alter_token":
                out[2][0, 0] = (out[2][0, 0] + 1) % self.n_char
            self.last = out
            return out

        self.engine._decode = spied
        self.session = OfflineASRSession(self.engine)
        self.outputs = {}
        ph.mark("model")
        # warm the piece shape and every decode length the mix reaches
        rng = traffic.rng_for(self.ctx.seed, 8)
        self.session.transcribe_wav(traffic.tones(self.engine.chunk_samples,
                                                  rng))
        step = self.engine.chunk_frames * self.engine.pad_chunks
        longest = max(len(f) for f in self.files)
        frames = -(-longest // (self.engine.chunk_samples
                                // self.engine.chunk_frames))
        for n in range(step, frames + step, step):
            self.engine.decode([np.zeros((n, self.m["dmodel"]), np.float32)])
        ph.mark("warm")

    def _request(self, k: int):
        spans = self.ctx.spans
        at = time.perf_counter()
        with spans("request"):
            segs = self.session.transcribe_wav(self.files[k])
        done = time.perf_counter()
        self.outputs[k] = (segs[0]["text"], self.last)
        spans.count("latency_s", done - at, at)

    def window(self, clock):
        n = 0
        clock.start()
        while clock.poll():
            self._request(n % len(self.files))
            n += 1
        lat = [v for _, v in self.ctx.spans.counts["latency_s"]]
        return {"attempted": n, "latency_s": lat}

    def end_to_end(self, rec):
        return {"request_p90_ms": 1e3 * float(
            np.percentile(rec["latency_s"], 90))}

    def sample(self) -> list:
        return judge.sample(sorted(self.outputs),
                            lambda k: len(self.files[k]),
                            int(self.ctx.traffic["judged_requests"]),
                            self.ctx.seed)

    def judge(self, rec):
        self.engine = self.session = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        numbers, failed = {"phone_gap": 0.0, "char_gap": 0.0}, 0
        sample = self.sample()
        for k in sample:
            got = self.readings(k, blocks.F32)
            numbers = {n: max(numbers[n], got[n]) for n in numbers}
            failed += any(got[n] > self.ctx.limits[n] for n in numbers)
        texts = [self.outputs[k][0] for k in sample]
        print(f"requests: judged {len(sample)}, "
              f"{np.mean([int(self.outputs[k][1][1][0]) for k in sample]):.1f}"
              f" phones and {np.mean([len(t) for t in texts]):.1f} chars a "
              f"request, {len(set(''.join(texts)))} distinct chars",
              file=sys.stderr)
        return numbers, failed

    def pieces(self, wav: np.ndarray, piece: int) -> list:
        return [wav[s:s + piece] for s in range(0, len(wav), piece)
                if len(wav[s:s + piece]) >= MIN_PIECE]

    @torch.no_grad()
    def reference_rows(self, model, wav: np.ndarray):
        """The session's encoder rows, rebuilt: every piece zero padded to
        the piece length and encoded alone, its valid rows kept, the rows
        joined and zero padded to whole groups of ``pad_chunks`` pieces."""
        rf = self.m["reduction_factor"]
        hop = self.m["sample_rate"] * self.m["stride_ms"] // 1000
        quantum = hop * rf
        piece = max(quantum, int(float(self.ctx.traffic["piece_s"])
                                 * self.m["sample_rate"]) // quantum
                    * quantum)
        rows_a_piece = piece // quantum
        parts = self.pieces(wav, piece)
        buf = np.zeros((len(parts), piece), np.float32)
        for i, p in enumerate(parts):
            buf[i, :len(p)] = p
        enc = model.encode(torch.from_numpy(buf).to(self.ctx.device))
        keep = [enc[i, :min(max(1, -(-len(p) // quantum)), rows_a_piece)]
                for i, p in enumerate(parts)]
        rows = torch.cat(keep, 0)
        t = rows.shape[0]
        cap = -(-(-(-t // rows_a_piece)) // 4) * 4 * rows_a_piece
        return F.pad(rows, (0, 0, 0, cap - t))[None], t

    @torch.no_grad()
    def readings(self, k: int, prec) -> dict:
        text, (ids, lens, chars) = self.outputs[k]
        model = ref.Conformer(self.w0, self.m, prec)
        enc, t = self.reference_rows(model, self.files[k])
        logits = model.ctc_logits(enc)[0, :t].float().cpu().numpy()
        n = int(lens[0])
        pg = judge.ctc_gap(logits, ids[0, :n], self.blank)
        if ids.shape[1] != enc.shape[1] or np.any(ids[0, n:] != 0):
            pg = judge.INF
        served = torch.from_numpy(ids).to(self.ctx.device).long()
        char_logits = model.translate(F.pad(served, (0, TRANSLATOR_PAD)),
                                      enc)[0].float().cpu().numpy()
        cg = judge.frame_gap(char_logits, chars[0])
        end = self.ctx.config["char_end_id"]
        expect = []
        for v in chars[0]:
            if v == 0 or v == end:
                break
            expect.append(int(v))
        if text_ids(text) != expect:
            cg = judge.INF
        return {"phone_gap": pg, "char_gap": cg}

    @torch.no_grad()
    def control(self, prec) -> dict:
        """As the decode cell's control, over the session's rebuilt rows."""
        out = {"phone_gap": 0.0, "char_gap": 0.0}
        for k in self.sample():
            ids = torch.from_numpy(self.outputs[k][1][0]).to(
                self.ctx.device).long()
            got = []
            for p in (blocks.F32, prec):
                model = ref.Conformer(self.w0, self.m, p)
                enc, t = self.reference_rows(model, self.files[k])
                got.append((model.ctc_logits(enc)[:, :t], model.translate(
                    F.pad(ids, (0, TRANSLATOR_PAD)), enc)))
            t = got[0][0].shape[1]
            lengths = torch.tensor([t], device=self.ctx.device)
            lo_ids, lo_lens = ref.greedy(got[1][0], lengths, self.blank)
            seq = lo_ids[0, :int(lo_lens[0])].cpu().numpy()
            out["phone_gap"] = max(out["phone_gap"], judge.ctc_gap(
                got[0][0][0].float().cpu().numpy(), seq, self.blank))
            out["char_gap"] = max(out["char_gap"], judge.frame_gap(
                got[0][1][0].float().cpu().numpy(),
                got[1][1][0].argmax(-1).cpu().numpy()))
        return out
