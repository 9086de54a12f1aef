"""Run a trainer's steps in N ranks and report what each rank did: the
check that a data- (and tensor-) parallel step equals the one-process
step on the global batch.

    python -m tensorflowasr_tpu_torch.parallel.step_check SPEC RANK WORLD \\
        INIT OUT

``SPEC`` is a JSON file (see :func:`run`), ``INIT`` the process group's
init-method URL (``file:///dir/rdzv``), ``OUT`` a directory where rank r
writes ``rank{r}.pt``. :func:`launch` starts the ranks and gathers what
they wrote; :func:`run` with ``world`` 1 is the one-process reference in
the caller's process. The tests on the CPU (gloo) and ``chip_smoke.py``
on the card both drive it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from tensorflowasr_tpu_torch.models.layers import BatchNorm, Dropout
from tensorflowasr_tpu_torch.parallel import mesh as mesh_lib
from tensorflowasr_tpu_torch.parallel import multihost, tp


def _config(spec: dict):
    if "config_files" in spec:
        from tensorflowasr_tpu_torch.utils.config import UserConfig

        return UserConfig(*spec["config_files"], extra=spec.get("extra"))
    return spec["config"]


def _trainer(spec: dict, device: str, mesh):
    kind = spec.get("kind", "ctc")
    n_phone, n_char = spec["n_phone"], spec["n_char"]
    if kind == "ctc":
        from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer

        return CTCTrainer(_config(spec), n_phone, n_char, n_phone - 1,
                          device=device, compute_dtype="float32", mesh=mesh)
    from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer

    return ChunkTrainer(_config(spec), n_phone, n_char, device=device,
                        compute_dtype="float32", mesh=mesh)


def _batches(path: str, steps: int) -> List[dict]:
    with np.load(path) as f:
        return [{k.split("/", 1)[1]: f[k] for k in f.files
                 if k.startswith(f"{i}/")} for i in range(steps)]


def _launch_counts() -> tuple:
    from tensorflowasr_tpu_torch.ops import log_mel_spectrogram as k1b
    from tensorflowasr_tpu_torch.ops import power_spectrogram as k1

    return (k1.power_spectrogram_cuda.launches,
            k1b.log_mel_spectrogram_cuda.launches)


def _leaf(t: torch.Tensor) -> dict:
    """A parameter or buffer as this rank holds it: the local values, and
    for a sharded DTensor the dimension and this rank's slot on it."""
    if isinstance(t, DTensor):
        placement = t.placements[0]
        dim = placement.dim if placement.is_shard() else None
        return {"value": t.to_local().detach().cpu().clone(), "dim": dim,
                "slot": t.device_mesh.get_local_rank(),
                "slots": t.device_mesh.size()}
    return {"value": t.detach().cpu().clone(), "dim": None}


def run(spec: dict, rank: int = 0, world: int = 1,
        init: Optional[str] = None) -> dict:
    """The steps of ``spec`` as rank ``rank`` of ``world``.

    Keys of ``spec``: ``kind`` ("ctc" or "chunk"), ``config`` (a config
    dict) or ``config_files`` ([data YAML, model YAML]) with ``extra``
    (overrides), ``n_phone``, ``n_char``, ``weights`` (a model state_dict
    file the run starts from), ``batches`` (an .npz of global batches,
    keys "i/name"), ``steps``, ``device`` ("cpu" or "cuda:N"),
    ``backend`` ("gloo" or "nccl"), ``tp`` ([data, model] for a
    tensor-parallel mesh), ``sgd`` (a learning rate: plain SGD in place of
    Adam, so the parameters read the gradients), ``grad_clip_norm`` (the
    optimizer's global-norm clip), ``restore`` / ``save`` (the trainer's
    newest checkpoint before the steps / a checkpoint after them, under
    the config's outdir), ``init_world_one`` (a process group even for one
    rank), ``probe_dropout`` (record the first dropout mask), ``threads``
    (a rank's CPU threads, 1 by default); or ``jobs``, a list of such specs
    run one after another in one process group (one start-up for all).

    ``local_batchnorm`` plants a fault: BatchNorm moments over each rank's
    own rows.

    Returns per-step metrics, the gradients' global norm as the optimizer
    computes it after its all-reduce (before its clip), each parameter's
    largest gradient entry at the first update, step times, K1 / K1b
    launches in the steps, and the parameters and buffers after them (and
    under ``first``, after the first of several steps), as this rank holds
    them."""
    device = spec.get("device", "cpu")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if world > 1:
        multihost.initialize(init, world, rank, spec.get("backend"), device)
    elif spec.get("init_world_one"):
        dist.init_process_group(
            spec.get("backend") or multihost.default_backend(device),
            init_method=init, world_size=1, rank=0)
    try:
        if "jobs" in spec:
            return {"jobs": [_steps(job, job.get("device", device))
                             for job in spec["jobs"]]}
        return _steps(spec, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _steps(spec: dict, device: str) -> dict:
    mesh = None
    if spec.get("tp"):
        mesh = mesh_lib.make_mesh(("data", mesh_lib.MODEL_AXIS),
                                  tuple(spec["tp"]), device)
    trainer = _trainer(spec, device, mesh)
    trainer.init_state(seed=int(spec.get("seed", 0)))
    state = trainer.state
    state.model.load_state_dict(torch.load(spec["weights"],
                                           map_location=device,
                                           weights_only=True))
    if spec.get("restore") and not trainer.restore():
        raise RuntimeError(f"no checkpoint under {trainer.outdir}")
    if mesh is not None:
        tp.shard_state_tp(state, mesh)
    # the update's global norm is read where the optimizer computes it for
    # its clip, after its all-reduce: an infinite limit clips nothing
    state.optimizer.grad_clip_norm = float(
        spec.get("grad_clip_norm") or state.optimizer.grad_clip_norm
        or "inf")
    if spec.get("sgd"):
        # params - lr * grad: the comparison reads the gradients
        # (tests/test_tp.py's reason for SGD)
        state.optimizer.adam = torch.optim.SGD(state.optimizer.params,
                                               lr=float(spec["sgd"]),
                                               foreach=False)
    dropped = []
    if spec.get("probe_dropout"):
        first = next(m for m in state.model.modules()
                     if isinstance(m, Dropout) and m.rate > 0)

        def record(module, args, out):
            if not dropped:
                dropped.append(((out == 0) & (args[0] != 0)).cpu())

        first.register_forward_hook(record)
    if spec.get("local_batchnorm"):
        # a planted fault: BatchNorm moments over this rank's rows alone
        # (the comparison of the ranks with one process must reject it)
        for m in state.model.modules():
            if isinstance(m, BatchNorm):
                m.data_group = None
    norms, grad_max = [], {}
    names = {id(p): k for k, p in state.model.named_parameters()}

    def read_gradients(optimizer, args, kwargs):
        # the norm the optimizer computed for its clip, after its
        # all-reduce over the data group, and the gradients as its update
        # reads them
        opt = state.optimizer
        norms.append(float(opt.grad_norm))
        if not grad_max:
            grad_max.update({names[id(p)]: float(
                mesh_lib.local_shard(p.grad).abs().max())
                for p in opt.params if p.grad is not None})

    state.optimizer.adam.register_step_pre_hook(read_gradients)
    if spec.get("kind", "ctc") == "ctc":
        from tensorflowasr_tpu_torch.train.asr_trainer import make_train_step

        step_fn = make_train_step(trainer.blank_id, group=trainer.group)
    else:
        from tensorflowasr_tpu_torch.train.chunk_trainer import (
            make_chunk_train_step,
        )

        step_fn = make_chunk_train_step(
            trainer.max_pick, trainer.txt_ctc_length, trainer.loss_reduction,
            group=trainer.group)
    cuda = torch.device(device).type == "cuda"
    metrics, times = [], []
    batches = [trainer._prepare_batch(b)
               for b in _batches(spec["batches"], int(spec["steps"]))]
    if cuda:
        from tensorflowasr_tpu_torch.ops import log_mel_spectrogram as k1b
        from tensorflowasr_tpu_torch.ops import power_spectrogram as k1

        k1.power_spectrogram_cuda.launches = 0
        k1b.log_mel_spectrogram_cuda.launches = 0
    model = state.model
    first = None
    for i, batch in enumerate(batches):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = step_fn(state, batch)
        if cuda:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0 and len(batches) > 1:
            first = _leaves(model)
    if spec.get("save"):
        trainer.save()
    return {
        "rank": dist.get_rank() if dist.is_initialized() else 0,
        "data_rank": mesh_lib.data_rank(trainer.mesh),
        "rows": int(batches[0]["wav"].shape[0]),
        "metrics": metrics, "grad_norms": norms, "grad_max": grad_max,
        "step_s": times,
        "launches": _launch_counts() if cuda else (0, 0),
        **_leaves(model), "first": first,
        "dropped": dropped[0] if dropped else None,
    }


def _leaves(model) -> dict:
    return {"params": {k: _leaf(p) for k, p in model.named_parameters()},
            "buffers": {k: _leaf(b) for k, b in model.named_buffers()}}


def assemble(results: List[dict], key: str = "params") -> dict:
    """Whole tensors from the ranks' leaves: a sharded leaf's slices
    concatenated in slot order (from the ranks of data rank 0), any other
    leaf as rank 0 holds it."""
    first = results[0][key]
    out = {}
    for name, leaf in first.items():
        if leaf["dim"] is None:
            out[name] = leaf["value"]
            continue
        parts = {r[key][name]["slot"]: r[key][name]["value"]
                 for r in results if r["data_rank"] == 0}
        out[name] = torch.cat([parts[i] for i in range(leaf["slots"])],
                              dim=leaf["dim"])
    return out


def launch(spec: dict, world: int, workdir: str, timeout: float = 600.0,
           env: Optional[dict] = None) -> List[dict]:
    """Write ``spec`` to ``workdir``, start ``world`` ranks of this module
    (``python -m``, rendezvous through a file in ``workdir``), wait for
    each, and return their results in rank order. A rank that fails or
    outlives ``timeout`` fails the whole launch (the others are killed)."""
    os.makedirs(workdir, exist_ok=True)
    spec_path = os.path.join(workdir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    rdzv = os.path.join(workdir, "rdzv")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    # the ranks import this checkout's package wherever they start
    env = dict(os.environ if env is None else env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", __name__, spec_path, str(r), str(world),
         f"file://{rdzv}", workdir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env) for r in range(world)]
    deadline = time.monotonic() + timeout
    failures = []
    try:
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failures.append(f"rank {r} outlived {timeout} s")
                break
            if p.returncode != 0:
                failures.append(f"rank {r} exited {p.returncode}:\n"
                                f"{err[-3000:]}")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failures:
        raise RuntimeError("; ".join(failures))
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def main(argv=None) -> int:
    spec_path, rank, world, init, out = (argv or sys.argv[1:])[:5]
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(int(spec.get("threads", 1)))
    result = run(spec, int(rank), int(world), init)
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
