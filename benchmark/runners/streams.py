"""Live streams: the port's ``MultiStreamChunkServer`` driven open loop by
one scheduler thread that does what ``BatchingStreamFront._loop`` does:
feed every 160 ms chunk that is due, ``tick()``, then stamp each chunk it
advanced.

Lanes start at phases spread over the first chunk and each plays
utterances back to back with a gap; an utterance opens a slot with its
first chunk and is closed (pad, drain, final result) after its last, so
slot leases and the reset mask run all window long. A chunk's latency is
the time its result is on the host minus the time it was due: its lane's
utterance start + (k + 1) x 160 ms.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchlib import judge, program, tracing, traffic, weights
from reference import blocks
from reference import chunk as ref


def collapse(ids, blank):
    out, prev = [], -1
    for i in ids:
        if i != prev and i != blank:
            out.append(int(i))
        prev = i
    return out


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        c = ctx.config
        self.m = program.reference_sizes(c)
        self.n_phone, self.n_char = c["num_phone_classes"], \
            c["num_char_classes"]
        self.blank, self.char_blank = self.n_phone - 1, self.n_char - 1

    def setup(self):
        from tensorflowasr_tpu_torch.serve.multi_session import (
            MultiStreamChunkServer,
        )
        c, mix, dev, seed = (self.ctx.config, self.ctx.traffic,
                             self.ctx.device, self.ctx.seed)
        wcfg = c["weights"]
        self.phases = ph = tracing.Phases()
        spec = ref.param_spec(self.m, self.n_phone, self.n_char)
        self.w0 = weights.make(spec, wcfg["law"], seed, dev,
                               self.m["encoder"]["num_heads"])
        rng = traffic.rng_for(seed, 5)
        n = int(wcfg["calibration_seconds"] * traffic.SR)
        warm = np.stack([traffic.tones(n, rng)
                         for _ in range(int(wcfg["calibration_signals"]))])
        ref.calibrate(self.w0, self.m, torch.from_numpy(warm).to(dev),
                      float(wcfg["first_conv_gain"]), self.blank)
        ph.mark("weights")
        model = program.chunk_conformer(c, self.w0, dev)
        self.cs = model.cfg.chunk_samples
        self.chunk_s = self.cs / traffic.SR
        self.pool = MultiStreamChunkServer(model, n_slots=int(mix["slots"]),
                                           device=dev)
        ph.mark("model")
        self.n_lanes = int(mix["lanes"])
        self.plan = traffic.lanes(mix, seed, self.n_lanes, self.cs,
                                  self.ctx.seconds + 2.0)
        ph.mark("traffic")
        # warm the pool's tick: every slot opened, fed and closed
        slots = [self.pool.open() for _ in range(self.pool.n_slots)]
        for _ in range(2):
            for s in slots:
                self.pool.feed(s, traffic.tones(self.cs, rng))
            self.pool.tick()
        for s in slots:
            self.pool.close(s)
        ph.mark("warm")

    def window(self, clock):
        pool, spans, plan = self.pool, self.ctx.spans, self.plan
        audio, lanes = plan["pool"], plan["lanes"]
        seconds, cs, chunk_s = self.ctx.seconds, self.cs, self.chunk_s
        n = self.n_lanes
        item = [0] * n
        k = [0] * n
        slot, state = [None] * n, [None] * n
        latency, late, outputs, backlog = [], [], [], []
        t0 = clock.start()
        while True:
            is_open = clock.poll()
            now = time.perf_counter() - t0
            fed, finished, per_lane = [], [], {}
            for lane in range(n):
                if item[lane] >= len(lanes[lane]):
                    continue
                start, u = lanes[lane][item[lane]]
                n_chunks = len(audio[u]) // cs
                while k[lane] < n_chunks:
                    due = start + (k[lane] + 1) * chunk_s
                    if due > now or due > seconds:
                        break
                    if k[lane] == 0:
                        slot[lane] = pool.open()
                        state[lane] = pool._slots[slot[lane]]
                    j = k[lane]
                    with spans("feed"):
                        pool.feed(slot[lane], audio[u][j * cs:(j + 1) * cs])
                    fed.append(due)
                    late.append(now - due)
                    per_lane[lane] = per_lane.get(lane, 0) + 1
                    k[lane] += 1
                if k[lane] == n_chunks and slot[lane] is not None:
                    finished.append(lane)
            if fed:
                backlog.append((now, len(fed)))
                with spans("tick"):
                    pool.tick()
                done = time.perf_counter() - t0
                latency.extend(done - due for due in fed)
                at = spans.spans["tick"][-1][0]
                spans.count("dispatches", max(per_lane.values()), at)
                spans.count("slots", len(fed), at)
                for lane in finished:
                    outputs.append(self._close(slot[lane], state[lane],
                                               lanes[lane][item[lane]][1]))
                    slot[lane] = state[lane] = None
                    item[lane] += 1
                    k[lane] = 0
                continue
            if not is_open:
                break
            nxt = min((lanes[lane][item[lane]][0] + (k[lane] + 1) * chunk_s
                       for lane in range(n) if item[lane] < len(lanes[lane])),
                      default=seconds)
            wait = min(nxt, seconds) - (time.perf_counter() - t0)
            if wait > 0:
                with spans("wait"):
                    time.sleep(wait)
        self.outputs = outputs
        lat, tick = np.asarray(latency), np.asarray([b for _, b in backlog])
        a, b = len(lat) // 3, len(tick) // 3
        print(f"streams: {n} lanes, {len(lat)} chunks, {len(outputs)} "
              f"closed; scheduler lateness p50 {1e3 * np.median(late):.3f} "
              f"p95 {1e3 * np.percentile(late, 95):.3f} max "
              f"{1e3 * max(late):.3f} ms; chunk p95 first third "
              f"{1e3 * np.percentile(lat[:a], 95):.3f} ms, last third "
              f"{1e3 * np.percentile(lat[-a:], 95):.3f} ms; chunks a tick "
              f"first third {tick[:b].mean():.1f}, last third "
              f"{tick[-b:].mean():.1f}", file=sys.stderr, flush=True)
        return {"attempted": len(lat), "latency_s": latency}

    def _close(self, slot, st, u):
        with self.ctx.spans("close"):
            res = self.pool.close(slot)
        if self.ctx.fault == "alter_token" and st.char_ids:
            st.char_ids[0] = (st.char_ids[0] + 1) % self.char_blank
            res = st.result(self.blank, self.char_blank, None, None)
        return {"u": u, "phone_ids": list(res["phone_ids"]),
                "char_ids": list(res["char_ids"]),
                "frames": list(st.phone_ids), "chars": list(st.char_ids),
                "prov": list(st.provisional_ids)}

    def end_to_end(self, rec):
        return {"stream_chunk_p95_ms": 1e3 * float(
            np.percentile(rec["latency_s"], 95))}

    def sample(self) -> list:
        audio = self.plan["pool"]
        return judge.sample(list(range(len(self.outputs))),
                            lambda i: len(audio[self.outputs[i]["u"]]),
                            int(self.ctx.traffic["judged_streams"]),
                            self.ctx.seed)

    def judge(self, rec):
        self.pool = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        numbers, failed = {"phone_gap": 0.0, "char_gap": 0.0}, 0
        sample = self.sample()
        if not sample:
            return {"phone_gap": judge.INF, "char_gap": judge.INF}, 1
        for i in sample:
            got = self.readings(self.outputs[i], blocks.F32)
            numbers = {name: max(numbers[name], got[name])
                       for name in numbers}
            failed += any(got[name] > self.ctx.limits[name]
                          for name in numbers)
        outs = [self.outputs[i] for i in sample]
        picks = sum(sum(f != self.blank for f in o["frames"]) for o in outs)
        frames = sum(len(o["frames"]) for o in outs)
        print(f"streams: judged {len(sample)}, {frames} frames, {picks} "
              f"picked, {np.mean([len(o['char_ids']) for o in outs]):.1f} "
              f"chars a stream", file=sys.stderr)
        return numbers, failed

    @torch.no_grad()
    def readings(self, out: dict, prec) -> dict:
        wav = torch.from_numpy(self.plan["pool"][out["u"]]).to(
            self.ctx.device)
        frames = torch.tensor(out["frames"], dtype=torch.long)
        model = ref.ChunkModel(self.w0, self.m, prec)
        phone_logits, char_logits = ref.stream_logits(model, wav, frames,
                                                      self.blank)
        chars = out["chars"] + out["prov"]
        pg = judge.frame_gap(phone_logits.float().cpu().numpy(),
                             np.asarray(out["frames"]))
        cg = judge.frame_gap(char_logits.float().cpu().numpy(),
                             np.asarray(chars))
        if collapse(out["frames"], self.blank) != out["phone_ids"]:
            pg = judge.INF
        if collapse(chars, self.char_blank) != out["char_ids"]:
            cg = judge.INF
        return {"phone_gap": pg, "char_gap": cg}

    @torch.no_grad()
    def control(self, prec) -> dict:
        """The tokens the reference at ``prec`` puts first, at each frame
        (phones) and at each of the stream's picked frames (chars), judged
        by the f32 reference."""
        out = {"phone_gap": 0.0, "char_gap": 0.0}
        for i in self.sample():
            o = self.outputs[i]
            wav = torch.from_numpy(self.plan["pool"][o["u"]]).to(
                self.ctx.device)
            frames = torch.tensor(o["frames"], dtype=torch.long)
            got = [ref.stream_logits(ref.ChunkModel(self.w0, self.m, p), wav,
                                     frames, self.blank)
                   for p in (blocks.F32, prec)]
            for j, name in enumerate(("phone_gap", "char_gap")):
                out[name] = max(out[name], judge.frame_gap(
                    got[0][j].float().cpu().numpy(),
                    got[1][j].argmax(-1).cpu().numpy()))
        return out
