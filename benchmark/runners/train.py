"""Training: the fit step of the port's ``CTCTrainer`` (``_prepare_batch``,
then ``train_step``; the metrics fetched every ``log_interval_steps`` as
``train/base.py::fit`` does) on numpy batches made in set-up.

Set-up builds the one train state, with the benchmark's weights, and drives
it through its first steps (one batch of each bucket, at least
``first_steps``): these warm every shape, and the reference follows the
first three. The window continues the same state. Once it has closed, the
warmed program takes one more step through the same call on the next
batch, and the reference takes that step too, from a copy of the state it
started from (weights, Adam's moments and count, the dropout generator):
a step that changes only once warm is judged as well as the first ones.
Planted faults act from the window on.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchlib import flops, judge, program, tracing, traffic, weights
from reference import blocks
from reference import conformer as ref

LOADER_KEYS = ("wav", "input_length", "phones", "phone_length", "chars",
               "char_length")
CHECKED_STEPS = 3


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        c = ctx.config
        self.m = program.reference_sizes(c)
        self.n_phone, self.n_char = c["num_phone_classes"], \
            c["num_char_classes"]
        self.blank = self.n_phone - 1
        self.warm = False       # set as the window opens: faults act then

    def setup(self):
        from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer
        from tensorflowasr_tpu_torch.train.base import fetch_mean
        from tensorflowasr_tpu_torch.train.state import make_optimizer
        c, mix, dev = self.ctx.config, self.ctx.traffic, self.ctx.device
        self.phases = ph = tracing.Phases()
        sizes = program.batch_sizes(c, self.m)
        first = max(CHECKED_STEPS, int(mix.get("first_steps", 3)))
        self.batches = traffic.warm_order(
            traffic.batches(mix, sizes, self.ctx.seed, dev), first)
        for b in self.batches:
            cap = b["phones"].shape[1]
            b["flops"] = flops.train(b["wav"].shape[0], b["wav"].shape[1],
                                     cap, self.m, self.n_phone, self.n_char)
            b["log_mel"] = flops.log_mel(b["wav"].shape[0], b["wav"].shape[1])
        ph.mark("traffic")
        self.w0 = weights.conformer(c, self.m, self.ctx.seed, dev)
        ph.mark("weights")
        self.trainer = CTCTrainer(c, self.n_phone, self.n_char, self.blank,
                                  device=dev, compute_dtype=c["dtype"])
        model = program.conformer(c, self.w0, dev)
        optimizer = make_optimizer(model.parameters(), c["optimizer_config"],
                                   dmodel=self.m["dmodel"])
        self.trainer.state = self.trainer.new_state(model, optimizer,
                                                    self.ctx.seed)
        self.fetch_mean = fetch_mean
        self.log_interval = int(c["running_config"]["log_interval_steps"])
        self.accum, self.i = [], 0
        self.names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        losses = []
        ph.mark("model")
        for k in range(first):
            if k == 0:
                start = self._snapshot()
            metrics = self._step(self.ctx.spans)
            if k == 0:
                self.grad1 = self._applied(start)[0]
            if k < CHECKED_STEPS:
                losses.append(metrics["train_loss"])
            if k == CHECKED_STEPS - 1:
                self.delta = {n: float((p.detach() - self.w0[n]).norm())
                              for n, p in zip(self.names, params)}
        self.losses = [float(x) for x in losses]
        ph.mark("first_steps")

    def _step(self, spans):
        tr = self.trainer
        host = self.batches[self.i % len(self.batches)]
        self.i += 1
        fault = self.ctx.fault if self.warm else None
        with spans("prepare"):
            batch = tr._prepare_batch({k: host[k] for k in LOADER_KEYS})
        if fault == "half_batch":
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        with spans("step"):
            if fault == "no_update":
                metrics = self._frozen_step(batch)
            else:
                tr.state, metrics = tr.train_step(tr.state, batch)
        self.accum.append(metrics)
        if tr.state.step % self.log_interval == 0:
            with spans("fetch"):
                self.fetch_mean(self.accum)
            self.accum = []
        return metrics

    def _frozen_step(self, batch):
        """A planted fault: the step's work without the update."""
        tr = self.trainer
        state = tr.state
        saved = {n: p.detach().clone()
                 for n, p in state.model.named_parameters()}
        state, metrics = tr.train_step(state, batch)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(saved[n])
        tr.state = state
        return metrics

    @torch.no_grad()
    def _snapshot(self) -> dict:
        """A copy of what the next step starts from: every weight and
        statistic by name, Adam's moments and count, the dropout
        generator's state."""
        st = self.trainer.state
        adam = st.optimizer.adam
        params = dict(st.model.named_parameters())
        weights_now = {k: v.detach().float().clone()
                       for k, v in st.model.state_dict().items()}
        moments, count = {}, 0
        for n, p in params.items():
            a = adam.state.get(p, {})
            if a:
                moments[n] = (a["exp_avg"].clone(), a["exp_avg_sq"].clone())
                count = int(a["step"])
            else:
                moments[n] = (torch.zeros_like(p), torch.zeros_like(p))
        return {"weights": weights_now, "moments": moments, "count": count,
                "generator": st.generator.get_state()}

    @torch.no_grad()
    def _applied(self, snap: dict) -> tuple:
        """The gradient a leaf's Adam got in the step since ``snap``,
        worked out from its first moment ((m - b1 m_before) / (1 - b1)),
        and the leaf's change: dicts of norms."""
        st = self.trainer.state
        b1 = self.ctx.config["optimizer_config"]["beta1"]
        grad, delta = {}, {}
        for n, p in st.model.named_parameters():
            m = st.optimizer.adam.state[p]["exp_avg"]
            grad[n] = float(((m - b1 * snap["moments"][n][0]) / (1 - b1))
                            .norm())
            delta[n] = float((p.detach().float() - snap["weights"][n])
                             .norm())
        return grad, delta

    def last_step(self) -> None:
        """The warmed program's step after the window, through the same
        call, with what the reference needs to take it too."""
        snap = self._snapshot()
        host = self.batches[self.i % len(self.batches)]
        metrics = self._step(self.ctx.spans)
        grad, delta = self._applied(snap)
        self.last = {"snap": snap, "batch": host, "grad": grad,
                     "delta": delta, "loss": float(metrics["train_loss"])}

    def window(self, clock):
        spans, n = self.ctx.spans, 0
        self.warm = True
        t0 = clock.start()
        while clock.poll():
            at = time.perf_counter()
            host = self.batches[self.i % len(self.batches)]
            self._step(spans)
            n += 1
            spans.count("audio_s", float(host["seconds"].sum()), at)
            spans.count("flops", host["flops"], at)
            spans.count("log_mel_flop", host["log_mel"][0], at)
            spans.count("log_mel_bytes", host["log_mel"][1], at)
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        audio = sum(v for _, v in spans.counts["audio_s"])
        return {"attempted": n, "wall_s": wall, "audio_s": audio}

    def end_to_end(self, rec):
        """The training job's peak of allocated device memory, set-up and
        window (steady from run to run; the host-bound rate is not, and is
        read per layer as ``train.audio_s_per_s``)."""
        return {"train_memory_peak_gb": rec["memory_peak_bytes"] / 1e9}

    def judge(self, rec):
        """Take the step after the window, free the program, then follow
        the first three steps and that step with the plain reference in f32
        from the same weights, batches and dropout stream."""
        dev = self.ctx.device
        self.last_step()
        self.trainer = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out = self.reference(blocks.F32)
        numbers = compare(self.losses, self.grad1, self.delta, out["first"])
        numbers.update(compare_last(self.last, out["last"]))
        limits = self.ctx.limits
        print(f"train: losses {self.losses}, reference {out['first']['loss']}"
              f"; after the window, step "
              f"{self.last['snap']['count'] + 1}: loss {self.last['loss']}, "
              f"reference {out['last']['loss'][0]}, last_loss_gap "
              f"{numbers['last_loss_gap']}; not compared: "
              + ", ".join(f"{k} {v}" for k, v in numbers.items()
                          if k not in limits),
              file=sys.stderr)
        return numbers, 0

    def reference(self, prec, rows=None, generator_seed=None) -> dict:
        """The reference's first three steps from the seed's weights, and
        its step from the state the judged step started from. ``rows``
        keeps the first rows of each batch (a planted fault);
        ``generator_seed`` draws the dropout masks from another stream."""
        dev, snap = self.ctx.device, self.last["snap"]
        gen = torch.Generator(device=dev)
        if generator_seed is None:
            gen.manual_seed(int(self.ctx.seed) % (2 ** 63))
        else:
            gen.manual_seed(generator_seed)
        first = reference_readings(self.w0, self.m, self.ctx.config,
                                   self.batches[:CHECKED_STEPS], gen, dev,
                                   prec, rows)
        if generator_seed is None:
            gen.set_state(snap["generator"])
        moments = (snap["moments"], snap["count"])
        last = reference_readings(snap["weights"], self.m, self.ctx.config,
                                  [self.last["batch"]], gen, dev, prec,
                                  rows, moments)
        return {"first": first, "last": last}

    def control(self, prec, rows=None, generator_seed=None) -> dict:
        """The reference at ``prec`` (or on its first ``rows`` rows, a
        planted fault, or with other dropout masks) in the program's place,
        against the f32 reference."""
        base = self.reference(blocks.F32)
        low = self.reference(prec, rows, generator_seed)
        out = compare(low["first"]["loss"], low["first"]["grad1"],
                      low["first"]["delta"], base["first"])
        last = {"loss": low["last"]["loss"][0],
                "grad": low["last"]["grad1"], "delta": low["last"]["delta"]}
        out.update(compare_last(last, base["last"]))
        return out


def device_batches(host_batches, device):
    return [{k: torch.from_numpy(np.asarray(b[k])).to(device)
             for k in LOADER_KEYS} for b in host_batches]


def reference_readings(w, m, config, host_batches, generator, device, prec,
                       rows=None, moments=None) -> dict:
    """The reference's steps from weights ``w`` (and Adam's ``moments``,
    (by name, count)): losses, first gradient norms and change norms per
    leaf."""
    out = ref.train_steps(w, m, config["optimizer_config"],
                          device_batches(host_batches, device), generator,
                          prec, rows, moments)
    return {"loss": out["loss"],
            "grad1": {k: float(v.norm()) for k, v in out["grad1"].items()},
            "delta": {k: float(v.norm()) for k, v in out["delta"].items()}}


def compare(losses, grad1, delta, ref_out) -> dict:
    keep = judge.moving_leaves(ref_out["grad1"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                         ref_out["loss"]))
    grad_gap = judge.rel_norm_gap(grad1, ref_out["grad1"], keep)
    update_gap = judge.rel_norm_gap(delta, ref_out["delta"], keep)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap}


def compare_last(last, ref_out) -> dict:
    """The step after the window: its loss, gradient and change against the
    reference's step from the same state, and the leaf that sets each."""
    keep = judge.moving_leaves(ref_out["grad1"])
    ref_loss = ref_out["loss"][0]
    out = {"last_loss_gap": abs(last["loss"] - ref_loss) / abs(ref_loss)}
    for name, prog, ref_n in (("grad", last["grad"], ref_out["grad1"]),
                              ("update", last["delta"], ref_out["delta"])):
        out[f"last_{name}_gap"] = judge.rel_norm_gap(prog, ref_n, keep)
        out[f"last_{name}_worst_leaf"] = judge.worst_leaf(prog, ref_n, keep)
    return out
