"""ASR training CLI for the offline Conformer-CTC family and the
chunk-streaming ChunkConformer.

    python -m tensorflowasr_tpu_torch.cli.train_asr --data_config D.yml \\
        --model_config M.yml [--total_steps N] [--data_workers N] \\
        [--data_procs N] \\
        [--device cuda|cuda:N|cpu] [--compute_dtype float32|bfloat16]

On N cards, data parallel, one process a card:

    torchrun --nproc_per_node N -m tensorflowasr_tpu_torch.cli.train_asr \\
        --data_config D.yml --model_config M.yml [--dist_backend nccl|gloo]

Counterpart of ``tensorflowasr_tpu/cli/train_asr.py``: dispatches on
``model_config.name`` (``ChunkConformer`` -> ``ChunkTrainer`` on the chunk
dataloader, anything else -> ``CTCTrainer``, which builds an
``EBranchformerCTC`` for ``EBranchformerCTC`` and a ConformerCTC for any
other name, and with
``speech_config.streaming: true`` trains the block-streaming ConformerCTC on
chunk-quantised lengths), resumes from the newest
checkpoint under ``running_config.outdir``/checkpoints when there is one,
trains ``--total_steps`` steps, logs to ``metrics.jsonl`` and saves at the
configured intervals. ``--data_procs N`` > 0 makes the batches in N worker
processes (``data/mp_prefetch.py``), each over its shard of the train list.

Under ``torchrun`` (``WORLD_SIZE`` > 1) each rank joins the process group
(``parallel/multihost.py``; torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT``), runs the same seeded
loader and trains on its rows of every batch of ``running_config.batch_size``:
each step equals the one-process step on the whole batch. ``--device cuda``
is card ``LOCAL_RANK`` (which must exist), ``--device cuda:N`` pins every
rank to card N (two gloo ranks may share one card; NCCL refuses that), and
``--dist_backend`` defaults to NCCL on cards and gloo on the CPU. Only rank
0 writes ``metrics.jsonl`` and the checkpoints, which restore in one
process (``eval_am``, ``test_asr``, ``serve_model``).
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

from tensorflowasr_tpu_torch.cli.common import (
    add_training_flags,
    am_batch_stream,
    chunk_batch_stream,
    chunk_setup,
    config_parser,
    load_config,
    make_train_iter,
    model_name,
    offline_ctc_setup,
)
from tensorflowasr_tpu_torch.parallel import multihost
from tensorflowasr_tpu_torch.utils.device import resolve_device


def join_process_group(args) -> None:
    """Under torchrun: pin this rank's device (``--device cuda`` becomes
    ``cuda:LOCAL_RANK``) and join the process group; one process
    otherwise."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return
    if args.device == "cuda":
        args.device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost.initialize("env://", world, int(os.environ["RANK"]),
                         args.dist_backend, device)


def main(argv=None) -> int:
    parser = config_parser(__doc__)
    add_training_flags(parser)
    parser.add_argument("--dist_backend", default=None,
                        choices=list(multihost.BACKENDS),
                        help="process-group backend under torchrun "
                             "(default: nccl on cards, gloo on the CPU)")
    args = parser.parse_args(argv)
    config = load_config(args)
    join_process_group(args)
    try:
        train(args, config)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def train(args, config) -> None:
    if model_name(config) == "ChunkConformer":
        dl, trainer = chunk_setup(args, config, args.compute_dtype)
        stream = chunk_batch_stream
    else:
        dl, trainer, _ = offline_ctc_setup(args, config, args.compute_dtype)
        stream = am_batch_stream
    trainer.restore()
    train_iter = make_train_iter(
        args, lambda: dl.generator(train=True, num_workers=args.data_workers,
                                   prefetch_depth=2 if args.data_workers
                                   else 0), stream)
    try:
        trainer.fit(train_iter, eval_iter=dl.generator(train=False),
                    total_steps=args.total_steps)
    finally:
        if hasattr(train_iter, "close"):
            train_iter.close()


if __name__ == "__main__":
    sys.exit(main())
