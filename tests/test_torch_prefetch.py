"""Batch production in worker processes (``data/mp_prefetch.py``) and
``cli.train_asr --data_procs``, after ``tests/test_prefetch.py``: spawned
workers build their own loader over their shard of the train list and
stream numpy batches equal to the serial loader's on the same shard (which
equal the JAX package's ``am_batch_stream``); a worker's error reaches the
consumer; a worker that puts the card to use or makes torch tensors is
refused; and ``train_asr --data_procs 2`` trains both families. Batches are
compared for equality."""

import functools
import json

import numpy as np
import pytest
import torch
import yaml

from tensorflowasr_tpu_torch.cli.common import (
    am_batch_stream,
    chunk_batch_stream,
)
from tensorflowasr_tpu_torch.data.mp_prefetch import MPBatchIterator
from tensorflowasr_tpu_torch.utils.audio import write_wav

SR = 16000
TEXTS = ["ni3 hao3", "shi4 jie4", "ni3 shi4", "hao3 jie4", "jie4 ni3",
         "hao3 shi4"]


def _sine(freq, seconds):
    t = np.arange(int(SR * seconds)) / SR
    return (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.fixture()
def corpus(tmp_path):
    lines = []
    for i, txt in enumerate(TEXTS):
        p = tmp_path / f"u{i}.wav"
        write_wav(str(p), _sine(200 + 40 * i, 0.8 + 0.1 * i), SR)
        lines.append(f"{p}\t{txt}")
    (tmp_path / "train.list").write_text("\n".join(lines), encoding="utf-8")
    (tmp_path / "phones.txt").write_text(
        "\n".join(["n", "i3", "h", "ao3", "sh", "i4", "j", "ie4"]),
        encoding="utf-8")
    (tmp_path / "chars.txt").write_text(
        "\n".join(["<S>", "</S>", "ni3", "hao3", "shi4", "jie4"]),
        encoding="utf-8")
    (tmp_path / "p2p.map").write_text(
        "ni3\tn i3\nhao3\th ao3\nshi4\tsh i4\njie4\tj ie4\n",
        encoding="utf-8")
    data_cfg = {
        "speech_config": {
            "sample_rate": SR, "stride_ms": 10, "reduction_factor": 4,
            "wav_max_duration": 2,
            "train_list": str(tmp_path / "train.list"),
            "eval_list": str(tmp_path / "train.list"),
            "pinyin_map": str(tmp_path / "p2p.map"),
            "transcripts_are_pinyin": True,
            "bucket_seconds": [1.5, 2.0],
        },
        "inp_config": {"vocabulary": str(tmp_path / "phones.txt"),
                       "blank_at_zero": False},
        "tar_config": {"vocabulary": str(tmp_path / "chars.txt"),
                       "blank_at_zero": False},
        "augments_config": None,
        "optimizer_config": {"lr": 0.003},
        "running_config": {"batch_size": 2, "log_interval_steps": 1,
                           "eval_interval_steps": 1000,
                           "save_interval_steps": 1000,
                           "outdir": str(tmp_path / "logs")},
    }
    model_cfg = {"model_config": {
        "name": "OfflineConformerCTC", "dmodel": 16, "num_blocks": 1,
        "head_size": 8, "num_heads": 2, "kernel_size": 4,
        "ctcdecoder_num_blocks": 1, "translator_num_blocks": 1,
        "dropout": 0.0}}
    dp, mp_ = tmp_path / "data.yml", tmp_path / "model.yml"
    dp.write_text(yaml.dump(data_cfg), encoding="utf-8")
    mp_.write_text(yaml.dump(model_cfg), encoding="utf-8")
    return tmp_path, str(dp), str(mp_)


def same_batch(a, b) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def test_mp_batch_iterator_matches_the_serial_shards(corpus):
    from tensorflowasr_tpu.cli.common import am_batch_stream as jax_stream

    _, dp, mp_ = corpus
    shards = []
    for worker in range(2):
        serial = am_batch_stream(dp, mp_, True, 1, worker, 2)
        shards.append([next(serial) for _ in range(4)])
    # the port's loader on a shard is the JAX package's
    jax_first = next(jax_stream(dp, mp_, True, 1, 1, 2))
    assert same_batch(shards[1][0], jax_first)

    it = MPBatchIterator(functools.partial(am_batch_stream, dp, mp_, True, 1),
                         num_workers=2, depth=2)
    try:
        got = [next(it) for _ in range(4)]
    finally:
        it.close()
    assert not any(p.is_alive() for p in it._procs)
    # each worker's batches arrive in its own order; the two interleave
    seen = [0, 0]
    for batch in got:
        assert all(isinstance(v, np.ndarray) for v in batch.values())
        match = [w for w in range(2) if seen[w] < 4
                 and same_batch(batch, shards[w][seen[w]])]
        assert match, "a batch that is neither shard's next"
        seen[match[0]] += 1
    assert got[0]["wav"].shape[0] == 2
    assert np.all(got[0]["phone_length"] == 4)   # 2 pinyin x (initial+final)


def test_mp_batch_iterator_forwards_worker_errors():
    it = MPBatchIterator(
        functools.partial(am_batch_stream, "/nonexistent/data.yml",
                          "/nonexistent/model.yml", True, 1),
        num_workers=1, depth=1)
    try:
        with pytest.raises(RuntimeError, match="nonexistent"):
            next(it)
    finally:
        it.close()


def tensor_batches(worker_id, num_workers):
    while True:
        yield {"wav": torch.zeros(2, 8)}


def cuda_batches(worker_id, num_workers):
    torch.zeros(1, device="cuda")
    while True:
        yield {"wav": np.zeros((2, 8), np.float32)}


@pytest.mark.parametrize("factory, message", [
    (tensor_batches, "torch tensors"),
    # the worker hides every card from itself: CUDA cannot start there
    (cuda_batches, "data worker failed")])
def test_workers_keep_off_the_card(factory, message):
    it = MPBatchIterator(factory, num_workers=1, depth=1)
    try:
        with pytest.raises(RuntimeError, match=message):
            next(it)
    finally:
        it.close()


@pytest.mark.parametrize("family", ["offline", "chunk"])
def test_train_asr_with_data_procs(corpus, family):
    from tensorflowasr_tpu_torch.cli.train_asr import main

    tmp_path, dp, mp_ = corpus
    if family == "chunk":
        stack = dict(dmodel=16, head_size=8, num_heads=2, kernel_size=4,
                     fc_factor=0.5, dropout=0.0, win_front=6)
        mp_ = str(tmp_path / "chunk.yml")
        with open(mp_, "w", encoding="utf-8") as f:
            yaml.dump({"model_config": {
                "name": "ChunkConformer",
                "ChunkConformerFront": {"dmodel": 16, "reduction_factor": 4,
                                        "sample_rate": SR, "n_mels": 20,
                                        "stride_ms": 10, "chunk_num": 16},
                **{k: {**stack, "num_blocks": 1, "win_back": w} for k, w in (
                    ("ChunkConformerEncoder", 0), ("ChunkCTCPicker", 0),
                    ("ChunkCTCDecoder", 2), ("ContextHelper", 0))},
            }}, f)
    assert main(["--data_config", dp, "--model_config", mp_, "--device",
                 "cpu", "--compute_dtype", "float32", "--total_steps", "2",
                 "--data_procs", "2", "--data_workers", "2"]) == 0
    logged = [json.loads(line) for line in
              (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in logged] == [1, 2]
    assert all(np.isfinite(m["train_loss"]) for m in logged)
