"""ASR training CLI for the offline Conformer-CTC family and the
chunk-streaming ChunkConformer.

    python -m tensorflowasr_tpu_torch.cli.train_asr --data_config D.yml \\
        --model_config M.yml [--total_steps N] [--data_workers N] \\
        [--data_procs N] \\
        [--device cuda|cpu] [--compute_dtype float32|bfloat16]

Counterpart of ``tensorflowasr_tpu/cli/train_asr.py``: dispatches on
``model_config.name`` (``ChunkConformer`` -> ``ChunkTrainer`` on the chunk
dataloader, anything else -> ``CTCTrainer``, which with
``speech_config.streaming: true`` trains the block-streaming ConformerCTC on
chunk-quantised lengths), resumes from the newest
checkpoint under ``running_config.outdir``/checkpoints when there is one,
trains ``--total_steps`` steps, logs to ``metrics.jsonl`` and saves at the
configured intervals. ``--data_procs N`` > 0 makes the batches in N worker
processes (``data/mp_prefetch.py``), each over its shard of the train list.
"""

from __future__ import annotations

import sys

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


def main(argv=None) -> int:
    parser = config_parser(__doc__)
    add_training_flags(parser)
    args = parser.parse_args(argv)
    config = load_config(args)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
