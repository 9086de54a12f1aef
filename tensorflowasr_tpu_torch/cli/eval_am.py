"""AM evaluation CLI: runs the full pipeline over the eval list and prints
one JSON object with phone / char SER / CER and S/I/D counts.

    python -m tensorflowasr_tpu_torch.cli.eval_am --data_config D.yml \\
        --model_config M.yml [--max_batches N] [--device cuda|cpu]

Counterpart of ``tensorflowasr_tpu/cli/eval_am.py``: dispatches on
``model_config.name`` (``ChunkConformer`` -> ``ChunkTester``, anything else
-> ``AMTester`` over ``CTCTrainer``'s model: an ``EBranchformerCTC`` for
``EBranchformerCTC``, a ConformerCTC for any other name). The newest
checkpoint under ``running_config.outdir``/checkpoints is evaluated
(random init with a warning when there is none). It scores in float32, as
the JAX CLI does
(its trainers are built without ``compute_dtype``): ``--compute_dtype`` is
parsed and ignored.

    ... [--lm LM.npz|LM.arpa | --word_lm WORDS.arpa [--word_lm_order 3]] \
        [--lm_weight 0.3] [--beam_width 8]

With ``--lm`` (an ``.npz`` from ``cli.train_lm`` or an ARPA text file over
the phone vocabulary) or ``--word_lm`` (an ARPA file whose words are pinyin
syllables, turned into a phone LM through the pinyin map), the offline and
block-streaming ConformerCTC decode with the CTC prefix beam search and the
LM fused on the device (``train/asr_trainer.py::make_beam_predict_step``).
A ``ChunkConformer`` ignores these flags and decodes greedily, as the JAX
CLI does.
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
from tensorflowasr_tpu_torch.train.asr_trainer import make_beam_predict_step
from tensorflowasr_tpu_torch.utils.ngram_lm import (
    NGramLM,
    lm_pack,
    unit_lm_from_word_arpa,
)
from tensorflowasr_tpu_torch.utils.text import tokens_to_phones


def _one_pass(args, dl) -> int:
    """--max_batches default = ONE pass over the eval list (the generator
    cycles endlessly)."""
    if args.max_batches is not None:
        return args.max_batches
    n = len(dl.test_list)
    if not n:
        raise RuntimeError("speech_config.eval_list is empty")
    return max(1, -(-n // dl.batch))


def _host_lm(args, dl) -> NGramLM:
    """The phone LM of ``--word_lm`` (pinyin-syllable words -> phone-id
    units through the pinyin map) or ``--lm`` (.arpa or .npz)."""
    phone_f, p2p = dl.phone_featurizer, dl.pinyin2phone
    if args.word_lm:
        def to_units(word):
            if word not in p2p:
                return None
            try:
                return phone_f.extract(tokens_to_phones([word], p2p, phone_f))
            except KeyError:
                return None

        return unit_lm_from_word_arpa(args.word_lm, to_units,
                                      phone_f.num_classes,
                                      order=args.word_lm_order)
    if args.lm.endswith(".arpa"):
        return NGramLM.from_arpa(args.lm, phone_f.token_to_index,
                                 phone_f.num_classes)
    return NGramLM.load(args.lm)


def main(argv=None) -> int:
    parser = config_parser(__doc__)
    add_training_flags(parser)
    parser.add_argument("--max_batches", type=int, default=None)
    parser.add_argument("--lm", default=None,
                        help="n-gram LM: .npz (cli/train_lm) or .arpa "
                             "(KenLM text, tokens = phone vocab) -> decode "
                             "with the beam search and shallow fusion on "
                             "the device instead of greedy (offline model "
                             "only)")
    parser.add_argument("--word_lm", default=None,
                        help="WORD-level .arpa whose tokens are pinyin "
                             "syllables: turned into a phone-level LM "
                             "through the pinyin map and fused like --lm")
    parser.add_argument("--word_lm_order", type=int, default=3)
    parser.add_argument("--lm_weight", type=float, default=0.3)
    parser.add_argument("--beam_width", type=int, default=8)
    args = parser.parse_args(argv)
    config = load_config(args)
    if model_name(config) == "ChunkConformer":
        dl, trainer = chunk_setup(args, config, "float32")
        tester = ChunkTester(trainer.predict_step, trainer.state)
    else:
        dl, trainer, char_f = offline_ctc_setup(args, config, "float32")
        if args.lm or args.word_lm:
            trainer.predict_step = make_beam_predict_step(
                trainer.state.model, blank_id=trainer.blank_id,
                beam_width=args.beam_width,
                ngram_lm=lm_pack(_host_lm(args, dl), trainer.device),
                lm_weight=args.lm_weight)
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
