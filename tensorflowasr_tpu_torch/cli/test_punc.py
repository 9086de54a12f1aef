"""Punctuate text lines with the restored punctuation model.

    python -m tensorflowasr_tpu_torch.cli.test_punc \\
        --data_config configs/punc_settings.yml \\
        --model_config configs/punc_settings.yml [--text TEXT] \\
        [--threshold 0.8] [--device cuda|cpu]

Counterpart of ``tensorflowasr_tpu/cli/test_punc.py``: restores the newest
checkpoint under ``running_config.outdir``/checkpoints (a warning on stderr
and a seeded random init when there is none), then prints ``--text``, or
each non-empty line of stdin, with punctuation inserted.
"""

from __future__ import annotations

import sys

from tensorflowasr_tpu_torch.cli.common import (
    build_punc_model,
    config_parser,
    load_config,
    restore_or_warn,
)


def main(argv=None) -> int:
    parser = config_parser(__doc__)
    parser.add_argument("--text", default=None,
                        help="text to punctuate (default: read stdin lines)")
    parser.add_argument("--threshold", type=float, default=0.8,
                        help="insertion probability threshold "
                             "(the reference test_punc.py uses 0.8)")
    args = parser.parse_args(argv)
    config = load_config(args)

    from tensorflowasr_tpu_torch.serve.engines import PuncEngine

    char_f, dl, model, state = build_punc_model(config, args.device)
    restore_or_warn(state, config.section("running_config")["outdir"],
                    "punctuation")
    engine = PuncEngine(model, char_f, dl.punc_tokens,
                        threshold=args.threshold, device=args.device)

    def run(line: str):
        print("".join(engine.punc_recover(list(line.strip()))))

    if args.text is not None:
        run(args.text)
    else:
        for line in sys.stdin:
            if line.strip():
                run(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
