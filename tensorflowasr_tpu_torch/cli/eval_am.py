"""AM evaluation CLI: runs the full pipeline over the eval list and prints
one JSON object with phone / char SER / CER and S/I/D counts.

    python -m tensorflowasr_tpu_torch.cli.eval_am --data_config D.yml \\
        --model_config M.yml [--max_batches N] [--device cuda|cpu]

Counterpart of ``tensorflowasr_tpu/cli/eval_am.py``: dispatches on
``model_config.name`` (``ChunkConformer`` -> ``ChunkTester``, anything else
-> ``AMTester``). The newest checkpoint under
``running_config.outdir``/checkpoints is evaluated (random init with a
warning when there is none). It scores in float32, as the JAX CLI does
(its trainers are built without ``compute_dtype``): ``--compute_dtype`` is
parsed and ignored. Decoding is greedy: ``--lm`` / ``--word_lm`` (beam
search with n-gram fusion) are not ported yet and raise.
"""

from __future__ import annotations

import json
import sys

from tensorflowasr_tpu_torch.cli.common import (
    add_training_flags,
    chunk_setup,
    config_parser,
    load_config,
    model_name,
    offline_ctc_setup,
)
from tensorflowasr_tpu_torch.eval.testers import AMTester, ChunkTester


def _one_pass(args, dl) -> int:
    """--max_batches default = ONE pass over the eval list (the generator
    cycles endlessly)."""
    if args.max_batches is not None:
        return args.max_batches
    n = len(dl.test_list)
    if not n:
        raise RuntimeError("speech_config.eval_list is empty")
    return max(1, -(-n // dl.batch))


def main(argv=None) -> int:
    parser = config_parser(__doc__)
    add_training_flags(parser)
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--lm", default=None,
                        help="n-gram LM for beam search with shallow "
                             "fusion; not ported yet, raises")
    parser.add_argument("--word_lm", default=None,
                        help="word-level .arpa LM; not ported yet, raises")
    args = parser.parse_args(argv)
    if args.lm or args.word_lm:
        raise NotImplementedError(
            "--lm / --word_lm (beam search with n-gram fusion) are not "
            "ported yet; eval_am decodes greedily")
    config = load_config(args)
    if model_name(config) == "ChunkConformer":
        dl, trainer = chunk_setup(args, config, "float32")
        tester = ChunkTester(trainer.predict_step, trainer.state)
    else:
        dl, trainer, char_f = offline_ctc_setup(args, config, "float32")
        tester = AMTester(trainer, char_end_id=char_f.endid())
    if not trainer.restore():
        print("warning: no checkpoint found; evaluating random init",
              file=sys.stderr)
    result = tester.run(dl.generator(train=False),
                        max_batches=_one_pass(args, dl))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
