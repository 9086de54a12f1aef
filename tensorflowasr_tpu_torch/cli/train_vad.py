"""VAD training CLI.

    python -m tensorflowasr_tpu_torch.cli.train_vad --data_config D.yml \\
        --model_config M.yml [--total_steps N] [--device cuda|cpu]

Counterpart of ``tensorflowasr_tpu/cli/train_vad.py``: builds the VAD model
of ``model_config.name`` (``CNN_Online_VAD`` or the offline variant) and
``VADDataLoader`` from the configs, resumes from the newest checkpoint under
``running_config.outdir``/checkpoints when there is one, trains
``--total_steps`` steps (each batch folded by ``streaming_reshape`` when
``speech_config.streaming`` is set, with a generator seeded 0), logs to
``metrics.jsonl`` and saves at the configured interval and at the end. The
VAD trains in float32: ``--compute_dtype`` is parsed and not used, as in the
JAX CLI.
"""

from __future__ import annotations

import logging
import sys

import numpy as np

from tensorflowasr_tpu_torch.cli.common import (
    build_vad_model,
    config_parser,
    load_config,
)
from tensorflowasr_tpu_torch.data.vad_dataloader import VADDataLoader
from tensorflowasr_tpu_torch.train.base import GenericTrainer
from tensorflowasr_tpu_torch.train.vad_trainer import (
    make_vad_eval_step,
    make_vad_train_step,
    streaming_reshape,
)

logger = logging.getLogger(__name__)


def main(argv=None) -> int:
    parser = config_parser(__doc__)
    parser.add_argument("--total_steps", type=int, default=10000)
    args = parser.parse_args(argv)
    config = load_config(args)

    sc = config.section("speech_config")
    rc = config.section("running_config")
    dl = VADDataLoader(config)
    model, state = build_vad_model(config, args.device)
    trainer = GenericTrainer(
        state, make_vad_train_step(model,
                                   global_batch=int(rc["batch_size"] or 8)),
        make_vad_eval_step(model), outdir=rc["outdir"] or "./vad-logs",
        running_config=rc)
    if rc["outdir"] and trainer.restore():
        logger.info("resumed from step %d", trainer.state.step)

    streaming = bool(sc["streaming"])
    min_frames = int(sc["streaming_min_frame"] or 8)
    rng = np.random.default_rng(0)

    def train_iter():
        while True:
            b = dl.generate(train=True)
            if streaming:
                b = streaming_reshape(b, min_frames, rng)
            yield b

    trainer.fit(train_iter(), eval_iter=dl.generator(train=False),
                total_steps=args.total_steps)
    trainer.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
