"""Punctuation-model evaluation CLI: masked punctuation accuracy and loss
over the eval list, printed as one JSON object.

    python -m tensorflowasr_tpu_torch.cli.eval_punc --data_config D.yml \\
        --model_config M.yml [--max_batches N] [--device cuda|cpu]

Counterpart of ``tensorflowasr_tpu/cli/eval_punc.py``: restores the newest
checkpoint under ``running_config.outdir``/checkpoints (random init with a
warning on stderr when there is none).
"""

from __future__ import annotations

import json
import sys

from tensorflowasr_tpu_torch.cli.common import (
    build_punc_model,
    config_parser,
    load_config,
    restore_or_warn,
)
from tensorflowasr_tpu_torch.eval.testers import PuncTester
from tensorflowasr_tpu_torch.train.punc_trainer import make_punc_eval_step


def main(argv=None) -> int:
    parser = config_parser(__doc__)
    parser.add_argument("--max_batches", type=int, default=50)
    args = parser.parse_args(argv)
    config = load_config(args)

    _, dl, model, state = build_punc_model(config, args.device)
    state = restore_or_warn(state, config.section("running_config")["outdir"],
                            "punctuation")
    tester = PuncTester(make_punc_eval_step(model), state)
    result = tester.run(dl.generator(train=False),
                        max_batches=args.max_batches)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
