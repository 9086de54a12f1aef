"""Time the training loader alone: batches a second from the iterator
``cli.train_asr`` builds, over a seeded corpus, with no model behind it.

    python -m tensorflowasr_tpu_torch.data.bench_loader --out DIR \\
        [--settings 8:0,8:2] [--batches 30] [--utts 128]

Each setting ``W:P`` is ``--data_workers W --data_procs P``: P = 0 makes
the batches on a prefetch thread of the loader (W wav-loading threads), P
> 0 in P worker processes (``data/mp_prefetch.py``), exactly as
``train_asr`` does (``cli/common.py::make_train_iter``). The corpus is
``--utts`` seeded 6-8 s utterances under ``--out``, read with the shipped
``configs/am_data.yml`` and ``conformerS.yml`` at their batch size (32).
After 3 batches of warm-up (the worker processes' start-up), ``--batches``
are timed; one JSON line a setting.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import yaml

SR = 16000


def write_corpus(root: str, n_utts: int) -> str:
    """Seeded wavs with pinyin-like transcripts; returns the data YAML."""
    from tensorflowasr_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(0)
    syllables = [f"s{i}" for i in range(400)]
    lines = []
    for i in range(n_utts):
        t = np.arange(int(rng.uniform(6.0, 8.0) * SR)) / SR
        wav = 0.4 * np.sin(2 * np.pi * rng.uniform(120, 900) * t) \
            + 0.05 * rng.standard_normal(len(t))
        path = os.path.join(root, f"utt{i:04d}.wav")
        write_wav(path, wav.astype(np.float32), SR)
        words = rng.choice(len(syllables), size=int(rng.integers(10, 30)))
        lines.append(f"{path}\t{' '.join(syllables[w] for w in words)}")

    def put(name, text):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.write(text)
        return os.path.join(root, name)

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with open(os.path.join(repo, "configs", "am_data.yml")) as f:
        data = yaml.safe_load(f)
    data["speech_config"].update(
        train_list=put("train.list", "\n".join(lines)),
        eval_list=put("eval.list", "\n".join(lines[:8])),
        pinyin_map=put("p2p.map", "".join(
            f"{s}\tp{i % 200} p{(7 * i + 3) % 200}\n"
            for i, s in enumerate(syllables))),
        transcripts_are_pinyin=True)
    data["inp_config"]["vocabulary"] = put(
        "phones.txt", "\n".join(f"p{i}" for i in range(200)))
    data["tar_config"]["vocabulary"] = put(
        "chars.txt", "\n".join(["<S>", "</S>"] + syllables))
    return put("data.yml", yaml.safe_dump(data))


def time_setting(data_yml: str, model_yml: str, workers: int, procs: int,
                 batches: int) -> dict:
    from tensorflowasr_tpu_torch.cli.common import (
        am_batch_stream,
        build_featurizers,
        make_train_iter,
    )
    from tensorflowasr_tpu_torch.data.am_dataloader import AMDataLoader
    from tensorflowasr_tpu_torch.utils.config import UserConfig

    config = UserConfig(data_yml, model_yml)
    phone_f, char_f, p2p, pin, pinyin_txt = build_featurizers(config)
    dl = AMDataLoader(config, phone_f, char_f, pinyin2phone=p2p, pinyin=pin,
                      transcripts_are_pinyin=pinyin_txt)
    args = argparse.Namespace(data_config=data_yml, model_config=model_yml,
                              data_workers=workers, data_procs=procs)
    it = make_train_iter(
        args, lambda: dl.generator(train=True, num_workers=workers,
                                   prefetch_depth=2 if workers else 0),
        am_batch_stream)
    try:
        for _ in range(3):
            next(it)
        t0 = time.perf_counter()
        rows = sum(next(it)["wav"].shape[0] for _ in range(batches))
        took = time.perf_counter() - t0
    finally:
        if hasattr(it, "close"):
            it.close()
    return {"data_workers": workers, "data_procs": procs,
            "batches": batches, "rows": rows, "seconds": took,
            "batches_per_s": batches / took, "cpus": os.cpu_count()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--settings", default="8:0,8:2")
    p.add_argument("--batches", type=int, default=30)
    p.add_argument("--utts", type=int, default=128)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    data_yml = write_corpus(args.out, args.utts)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    model_yml = os.path.join(repo, "configs", "conformerS.yml")
    for setting in args.settings.split(","):
        workers, procs = (int(v) for v in setting.split(":"))
        print(json.dumps(time_setting(data_yml, model_yml, workers, procs,
                                      args.batches)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
