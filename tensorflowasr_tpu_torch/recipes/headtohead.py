"""Train + eval the port on the shared synthetic corpus: the port's side of
the head-to-head CER comparison.

Counterpart of ``examples/headtohead/run_ours.py``: the same data and model
configs (``write_configs``: offline, ``--streaming``, ``--chunk``,
``--augment``, ``--noise_list``) derived from the recipe's ``am_data.yml``,
then ``cli.train_asr`` and ``cli.eval_am`` run in this process on
``--device`` (``cuda`` by default, which raises without CUDA; ``cpu`` when
asked). Writes ``<out_dir>/result.json`` with the phone / char CER, SER and
S/D/I counts and prints it as one ``RESULT {...}`` line, with the JAX
script's keys:

  python -m tensorflowasr_tpu_torch.recipes.headtohead \\
      --work_dir /tmp/h2h_work --out_dir /tmp/h2h_ours \\
      --total_steps 3000 --batch 16 [--device cuda|cpu]

:func:`quick` runs the quick setting of ``bench.py::bench_headtohead_live``
from nothing: the seed-21 corpus (``recipes/synthetic_mandarin.py``) under
``root/corpus``, its lists and vocabularies (``recipes/aishell1_prepare.py``)
under ``root/work``, then 2000 steps of the offline model at B = 16 with the
noise and masking augmenters and an evaluation on the test list under
``root/ours``:

  python -c "from tensorflowasr_tpu_torch.recipes import headtohead; \
      headtohead.quick('/tmp/h2h', 'cuda')"
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time
from typing import List, Optional, Tuple

# bench.py::bench_headtohead_live's quick setting, argument for argument
QUICK_CORPUS = ("--n_chars", "120", "--n_train", "500", "--n_dev", "50",
                "--n_test", "100", "--seed", "21", "--min_len", "6",
                "--max_len", "12", "--speakers", "12",
                "--rate_var", "0.9,1.15", "--reverb", "0.3",
                "--noise", "0.04", "--noise_min", "0.01",
                "--emit_noise", "6")
QUICK_PREPARE = ("--bucket_seconds", "1.5,2,2.5,3,4")
# --data_workers 0: in-process loading, so the batch order is
# deterministic
QUICK_RUN = ("--total_steps", "2000", "--batch", "16", "--lr", "5e-4",
             "--wav_max_duration", "5", "--data_workers", "0", "--augment")


def write_configs(args) -> Tuple[str, str]:
    """``ours_data.yml`` and ``ours_model.yml`` in ``args.out_dir``: the
    recipe's ``am_data.yml`` (lists, vocabularies, lexicon) with the
    run-specific knobs rewritten, and a model config of the run's
    dimensions."""
    import yaml

    data_yml = os.path.join(args.out_dir, "ours_data.yml")
    model_yml = os.path.join(args.out_dir, "ours_model.yml")
    with open(os.path.join(args.work_dir, "am_data.yml")) as f:
        data = yaml.safe_load(f)
    data["speech_config"]["eval_list"] = os.path.join(args.work_dir,
                                                      args.eval_list)
    data["speech_config"]["wav_max_duration"] = args.wav_max_duration
    if args.streaming:
        # block-streaming family: chunks folded into the batch axis
        data["speech_config"]["streaming"] = True
        data["speech_config"]["streaming_bucket"] = args.streaming_bucket
    if args.augment:
        # the reference run's two augmenters and their parameters
        data["augments_config"] = {
            "noise": {"active": args.noise_list is not None,
                      "sample_rate": 16000, "SNR": [8, 30],
                      "noises": args.noise_list or ""},
            "masking": {"active": True, "zone": "(0.1,0.9)",
                        "mask_ratio": 0.3, "mask_with_noise": False},
        }
    else:
        data["augments_config"] = {"spec_aug": {"active": False}}
    data["optimizer_config"] = {
        "lr": args.lr, "beta1": 0.9, "beta2": 0.98, "epsilon": 1e-6,
    }
    data["running_config"] = {
        "batch_size": args.batch,
        "num_epochs": 10000,  # step-bounded via --total_steps
        "outdir": os.path.join(args.out_dir, "logs"),
        "log_interval_steps": 100,
        "eval_interval_steps": 100000,
        "save_interval_steps": min(500, args.total_steps),
    }
    with open(data_yml, "w") as f:
        yaml.safe_dump(data, f, allow_unicode=True)
    if args.chunk:
        stack = {"dmodel": args.dmodel, "head_size": args.head_size,
                 "num_heads": args.num_heads,
                 "kernel_size": args.kernel_size, "fc_factor": 0.5,
                 "dropout": args.dropout, "win_front": 36, "win_back": 0}
        model = {
            "model_config": {
                "name": "ChunkConformer",
                "ChunkConformerFront": {
                    "dmodel": args.dmodel, "reduction_factor": 4,
                    "dropout": args.dropout, "sample_rate": 16000,
                    "n_mels": 80, "mel_layer_trainable": False,
                    "stride_ms": 10, "chunk_num": 16,
                },
                "ChunkConformerEncoder": {
                    **stack, "num_blocks": args.num_blocks},
                "ChunkCTCPicker": {**stack, "num_blocks": 1},
                "ChunkCTCDecoder": {**stack, "num_blocks": 1,
                                    "win_back": 8},
                "ContextHelper": {**stack, "num_blocks": 2},
            }
        }
        with open(model_yml, "w") as f:
            yaml.safe_dump(model, f)
        return data_yml, model_yml
    model = {
        "model_config": {
            "name": "OfflineConformerCTC",
            "dmodel": args.dmodel, "num_blocks": args.num_blocks,
            "head_size": args.head_size, "num_heads": args.num_heads,
            "kernel_size": args.kernel_size, "fc_factor": 0.5,
            "dropout": args.dropout, "reduction_factor": 4,
            "ctcdecoder_num_blocks": 1,
            "ctcdecoder_kernel_size": args.kernel_size,
            "ctcdecoder_fc_factor": 0.5,
            "ctcdecoder_dropout": args.dropout,
            "translator_num_blocks": 1,
            "translator_kernel_size": args.kernel_size,
            "translator_fc_factor": 0.5,
            "translator_dropout": args.dropout,
        }
    }
    with open(model_yml, "w") as f:
        yaml.safe_dump(model, f)
    return data_yml, model_yml


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--work_dir", required=True,
                   help="the prepared recipe directory (am_data.yml)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--total_steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--eval_list", default="test.list")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dmodel", type=int, default=64)
    p.add_argument("--num_blocks", type=int, default=4)
    p.add_argument("--head_size", type=int, default=16)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--kernel_size", type=int, default=16)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--wav_max_duration", type=float, default=7.0)
    p.add_argument("--streaming", action="store_true",
                   help="train the block-streaming family instead of "
                        "offline")
    p.add_argument("--streaming_bucket", type=float, default=0.5)
    p.add_argument("--chunk", action="store_true",
                   help="train the ChunkConformer family (3-loss chunk "
                        "trainer) instead of offline")
    p.add_argument("--augment", action="store_true",
                   help="activate the noise and masking augmenters")
    p.add_argument("--noise_list", default=None,
                   help="noise wav list for the SignalNoise augmenter")
    p.add_argument("--data_workers", type=int, default=None,
                   help="override train_asr --data_workers (0 = loading "
                        "in the training loop: a deterministic batch "
                        "order)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA), cuda:N or "
                        "cpu, passed to train_asr and eval_am")
    return p


def evaluate(data_yml: str, model_yml: str, device: str) -> dict:
    """``cli.eval_am`` on the newest checkpoint under the data config's
    outdir: its JSON line (phone / char CER, SER, S/D/I counts)."""
    from tensorflowasr_tpu_torch.cli import eval_am

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = eval_am.main(["--data_config", data_yml,
                           "--model_config", model_yml,
                           "--device", device])
    if rc != 0:
        raise RuntimeError(f"cli.eval_am returned {rc}")
    lines = [l for l in out.getvalue().splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


def run(args) -> Tuple[dict, dict]:
    """Write the configs, train, evaluate; write ``result.json``. ->
    (result, {"train_s", "eval_s", "data_yml", "model_yml"})."""
    from tensorflowasr_tpu_torch.cli import train_asr

    os.makedirs(args.out_dir, exist_ok=True)
    data_yml, model_yml = write_configs(args)
    train_args = ["--data_config", data_yml, "--model_config", model_yml,
                  "--total_steps", str(args.total_steps),
                  "--device", args.device]
    if args.data_workers is not None:
        train_args += ["--data_workers", str(args.data_workers)]
    t0 = time.perf_counter()
    if train_asr.main(train_args) != 0:
        raise RuntimeError("cli.train_asr failed")
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = evaluate(data_yml, model_yml, args.device)
    t_eval = time.perf_counter() - t0
    result["framework"] = "ours"
    result["model_family"] = ("chunk" if args.chunk
                              else "streaming" if args.streaming
                              else "offline")
    result["total_steps"] = args.total_steps
    result["batch"] = args.batch
    with open(os.path.join(args.out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=2)
    print("RESULT " + json.dumps(result))
    return result, {"train_s": t_train, "eval_s": t_eval,
                    "data_yml": data_yml, "model_yml": model_yml}


def quick_commands(root: str, device: str) -> Tuple[List[str], List[str],
                                                    List[str]]:
    """The argument lists of the quick setting's three steps: the corpus
    (``synthetic_mandarin``), its preparation (``aishell1_prepare``) and
    the run (this module)."""
    corpus = os.path.join(root, "corpus")
    work = os.path.join(root, "work")
    return (["--out_dir", corpus, *QUICK_CORPUS],
            ["--data_dir", corpus, "--out_dir", work,
             "--train_time_lexicon", os.path.join(corpus, "lexicon.tsv"),
             *QUICK_PREPARE],
            ["--work_dir", work, "--out_dir", os.path.join(root, "ours"),
             *QUICK_RUN, "--noise_list", os.path.join(corpus, "noise.list"),
             "--device", device])


def quick(root: str, device: str = "cuda") -> dict:
    """The quick setting from nothing under ``root``. -> {"result": the
    result dict, "corpus_s", "train_s", "eval_s": wall seconds of the
    corpus and its preparation, of training and of eval, "data_yml",
    "model_yml"}."""
    from tensorflowasr_tpu_torch.recipes import (
        aishell1_prepare,
        synthetic_mandarin,
    )

    corpus_argv, prepare_argv, run_argv = quick_commands(root, device)
    t0 = time.perf_counter()
    if synthetic_mandarin.main(corpus_argv) != 0 \
            or aishell1_prepare.main(prepare_argv) != 0:
        raise RuntimeError("building the quick corpus failed")
    t_corpus = time.perf_counter() - t0
    result, times = run(build_parser().parse_args(run_argv))
    return {"result": result, "corpus_s": t_corpus, **times}


def main(argv: Optional[List[str]] = None) -> int:
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
