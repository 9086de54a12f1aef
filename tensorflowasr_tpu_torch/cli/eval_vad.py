"""VAD evaluation CLI: frame accuracy and F1 over the eval list, printed as
one JSON object.

    python -m tensorflowasr_tpu_torch.cli.eval_vad --data_config D.yml \\
        --model_config M.yml [--max_batches N] [--export_native DIR] \\
        [--device cuda|cpu]

Counterpart of ``tensorflowasr_tpu/cli/eval_vad.py``: restores the newest
checkpoint under ``running_config.outdir``/checkpoints (random init with a
warning on stderr when there is none). ``--export_native DIR`` also writes
the raw-tensor artifact of the standalone C++ VAD (``asr_vad``,
``asr_offline --vad``, ``asr_chunk --vad``; ``export/native_export.py``).
"""

from __future__ import annotations

import json
import sys

from tensorflowasr_tpu_torch.cli.common import (
    build_vad_model,
    config_parser,
    load_config,
    restore_or_warn,
)
from tensorflowasr_tpu_torch.data.vad_dataloader import VADDataLoader
from tensorflowasr_tpu_torch.eval.testers import VADTester
from tensorflowasr_tpu_torch.train.vad_trainer import make_vad_eval_step


def main(argv=None) -> int:
    parser = config_parser(__doc__)
    parser.add_argument("--max_batches", type=int, default=50)
    parser.add_argument("--export_native", default=None, metavar="DIR",
                        help="also write the raw-tensor artifact for the "
                             "standalone C++ VAD (asr_vad / asr_offline "
                             "--vad / asr_chunk --vad)")
    args = parser.parse_args(argv)
    config = load_config(args)

    dl = VADDataLoader(config)
    model, state = build_vad_model(config, args.device)
    state = restore_or_warn(state, config.section("running_config")["outdir"],
                            "VAD")
    if args.export_native:
        from tensorflowasr_tpu_torch.export.native_export import (
            export_native_vad,
        )

        export_native_vad(model, args.export_native)
        print(f"native VAD artifact written to {args.export_native}")
    tester = VADTester(make_vad_eval_step(model), state)
    result = tester.run(dl.generator(train=False),
                        max_batches=args.max_batches)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
