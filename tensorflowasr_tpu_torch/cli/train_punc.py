"""Punctuation-model training CLI.

    python -m tensorflowasr_tpu_torch.cli.train_punc --data_config D.yml \\
        --model_config M.yml [--total_steps N] [--bert_feature_dir DIR] \\
        [--device cuda|cpu]

Counterpart of ``tensorflowasr_tpu/cli/train_punc.py``: builds the
``PuncTransformer`` and ``PuncDataLoader`` from the configs (Adam of
``optimizer_config``), resumes from the newest checkpoint under
``running_config.outdir``/checkpoints when there is one, trains
``--total_steps`` steps and saves. With ``--bert_feature_dir`` (teacher
features precomputed as ``.npy`` files, one a line) the loss adds the
distillation term. The loader's offset is saved after every batch, so a
resumed run continues where the list was. The model trains in float32:
``--compute_dtype`` is parsed and not used, as in the JAX CLI.
"""

from __future__ import annotations

import logging
import sys

from tensorflowasr_tpu_torch.cli.common import (
    build_punc_model,
    config_parser,
    load_config,
)
from tensorflowasr_tpu_torch.train.base import GenericTrainer
from tensorflowasr_tpu_torch.train.punc_trainer import (
    make_punc_eval_step,
    make_punc_train_step,
)

logger = logging.getLogger(__name__)


def main(argv=None) -> int:
    parser = config_parser(__doc__)
    parser.add_argument("--total_steps", type=int, default=10000)
    parser.add_argument("--bert_feature_dir", default=None,
                        help="dir of precomputed teacher features (.npy)")
    args = parser.parse_args(argv)
    config = load_config(args)

    _, dl, model, state = build_punc_model(config, args.device)
    dl.bert_feature_dir = args.bert_feature_dir
    rc = config.section("running_config")
    trainer = GenericTrainer(
        state, make_punc_train_step(model), make_punc_eval_step(model),
        outdir=rc["outdir"] or "./punc-logs", running_config=rc)
    if rc["outdir"] and trainer.restore():
        logger.info("resumed from step %d", trainer.state.step)

    def train_iter():
        while True:
            yield dl.generate(True)
            dl.save_state()     # the offset, for a resumed run

    trainer.fit(train_iter(), eval_iter=dl.generator(train=False),
                total_steps=args.total_steps)
    trainer.save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
