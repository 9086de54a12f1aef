"""Shared CLI plumbing: argument parser, config loading, featurizers, the
train-batch streams (threads or worker processes), and the VAD and
punctuation models with their checkpoint restore."""

from __future__ import annotations

import argparse
import functools
import logging
import os
import re
import sys
from typing import Callable, Iterator, Optional, Tuple, Union

import torch

from tensorflowasr_tpu_torch.utils.config import UserConfig
from tensorflowasr_tpu_torch.utils.text import (
    PinyinConverter,
    TextFeaturizer,
    load_pinyin2phone,
)


def config_parser(description: str, model_required: bool = True,
                  device: bool = True) -> argparse.ArgumentParser:
    """The flags every CLI takes. A host-only tool passes ``device=False``
    (no ``--device``); ``model_required=False`` lets ``--model_config``
    default to the data YAML."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--data_config", required=True,
                   help="data YAML (speech/augments/running config)")
    p.add_argument("--model_config", required=model_required,
                   help="model YAML (model_config section)" +
                        ("" if model_required
                         else "; optional, defaults to the data YAML"))
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    if device:
        p.add_argument("--device", default="cuda", type=device_flag,
                       help="cuda (default; raises without CUDA), cuda:N "
                            "(card N) or cpu")
    p.add_argument("--log_level", default="INFO")
    return p


def device_flag(value: str) -> str:
    """``--device``: "cuda", "cuda:N" or "cpu"."""
    if not re.fullmatch(r"cpu|cuda(:\d+)?", value):
        raise argparse.ArgumentTypeError(
            f"--device must be cuda, cuda:N or cpu, got {value!r}")
    return value


def add_training_flags(p: argparse.ArgumentParser) -> None:
    """The flags ``train_asr`` and ``eval_am`` share on top of
    :func:`config_parser`."""
    p.add_argument("--total_steps", type=int, default=10000)
    p.add_argument("--data_workers", type=int, default=4,
                   help="host threads for wav loading; batches are "
                        "prefetched in the background when > 0")
    p.add_argument("--data_procs", type=int, default=0,
                   help="batch-producer PROCESSES, each owning a train-list "
                        "shard (data/mp_prefetch.py); 0 = threads only. Use "
                        "when batch prep, not the device, limits steps/s")


def load_config(args) -> UserConfig:
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    return UserConfig(args.data_config, args.model_config)


def build_featurizers(config: UserConfig
                      ) -> Tuple[TextFeaturizer, TextFeaturizer, dict,
                                 Optional[PinyinConverter], bool]:
    """-> (phone featurizer, char featurizer, pinyin2phone map,
    pinyin converter, transcripts_are_pinyin)."""
    phone_f = TextFeaturizer(dict(config.section("inp_config").data))
    char_f = TextFeaturizer(dict(config.section("tar_config").data))
    sc = config.section("speech_config")
    p2p_path = sc["pinyin_map"]
    p2p = load_pinyin2phone(p2p_path) if p2p_path else {}
    transcripts_are_pinyin = bool(sc["transcripts_are_pinyin"])
    pin = None
    if not transcripts_are_pinyin:
        pin = PinyinConverter(lexicon_path=sc["pinyin_lexicon"])
        if not pin.available:
            logging.warning(
                "no hanzi->pinyin backend (install pypinyin or set "
                "speech_config.pinyin_lexicon); assuming transcripts are "
                "already space-separated pinyin")
            transcripts_are_pinyin = True
            pin = None
    return phone_f, char_f, p2p, pin, transcripts_are_pinyin


# -- module-level batch streams (picklable for data/mp_prefetch.py) ---------

def am_batch_stream(data_config: str, model_config: str, train: bool = True,
                    sample_workers: int = 4, worker_id: int = 0,
                    num_workers: int = 1) -> Iterator[dict]:
    """Build an ``AMDataLoader`` in THIS process over the worker's shard of
    the train list and yield its numpy batches forever. Top-level, so that
    ``functools.partial(am_batch_stream, data_yml, model_yml)`` pickles into
    ``MPBatchIterator``'s spawned workers."""
    from tensorflowasr_tpu_torch.data.am_dataloader import AMDataLoader

    config = UserConfig(data_config, model_config)
    phone_f, char_f, p2p, pin, pinyin_txt = build_featurizers(config)
    dl = AMDataLoader(config, phone_f, char_f, pinyin2phone=p2p, pinyin=pin,
                      transcripts_are_pinyin=pinyin_txt, seed=worker_id)
    if num_workers > 1 and train and len(dl.train_list) >= num_workers:
        dl.train_list = dl.train_list[worker_id::num_workers]
    while True:
        yield dl.generate(train=train, num_workers=sample_workers)


def chunk_batch_stream(data_config: str, model_config: str,
                       train: bool = True, sample_workers: int = 4,
                       worker_id: int = 0, num_workers: int = 1
                       ) -> Iterator[dict]:
    """``ChunkDataLoader`` counterpart of :func:`am_batch_stream`."""
    from tensorflowasr_tpu_torch.data.chunk_dataloader import (
        ChunkDataLoader,
    )

    config = UserConfig(data_config, model_config)
    phone_f, char_f, p2p, pin, pinyin_txt = build_featurizers(config)
    chunk_num = ((config["model_config"] or {})
                 .get("ChunkConformerFront") or {}).get("chunk_num", 16)
    dl = ChunkDataLoader(config, phone_f, char_f, chunk_num=chunk_num,
                         pinyin2phone=p2p, pinyin=pin,
                         transcripts_are_pinyin=pinyin_txt, seed=worker_id)
    if num_workers > 1 and train and len(dl.train_list) >= num_workers:
        dl.train_list = dl.train_list[worker_id::num_workers]
    while True:
        yield dl.generate(train=train, num_workers=sample_workers)


def make_train_iter(args, thread_iter_fn: Callable[[], Iterator],
                    stream_fn: Callable[..., Iterator]) -> Iterator:
    """The train-batch iterator: ``--data_procs`` > 0 spawns that many
    worker processes over ``stream_fn`` (:func:`am_batch_stream` or
    :func:`chunk_batch_stream`), each with ``--data_workers /
    --data_procs`` loading threads; else the loader's own thread-prefetch
    generator (``thread_iter_fn()``)."""
    if args.data_procs > 0:
        from tensorflowasr_tpu_torch.data.mp_prefetch import MPBatchIterator

        factory = functools.partial(
            stream_fn, args.data_config, args.model_config, True,
            max(1, args.data_workers // args.data_procs))
        return MPBatchIterator(factory, num_workers=args.data_procs,
                               depth=2 * args.data_procs)
    return thread_iter_fn()


def model_name(config: UserConfig) -> str:
    """``model_config.name``: ``ChunkConformer``, ``EBranchformerCTC``, or
    any other name (``OfflineConformerCTC`` when unset) for a
    ConformerCTC."""
    return config.section("model_config")["name"] or "OfflineConformerCTC"


def offline_ctc_setup(args, config: UserConfig, compute_dtype: str):
    """What ``train_asr`` and ``eval_am`` share for the offline family: the
    dataloader and the trainer (with fresh random weights, computing in
    ``compute_dtype``) built from the config. -> (dataloader, trainer,
    char featurizer)."""
    from tensorflowasr_tpu_torch.data.am_dataloader import AMDataLoader
    from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer

    phone_f, char_f, p2p, pin, pinyin_txt = build_featurizers(config)
    dl = AMDataLoader(config, phone_f, char_f, pinyin2phone=p2p, pinyin=pin,
                      transcripts_are_pinyin=pinyin_txt)
    trainer = CTCTrainer(config, phone_f.num_classes, char_f.num_classes,
                         blank_id=phone_f.blank, device=args.device,
                         compute_dtype=compute_dtype)
    trainer.init_state()
    return dl, trainer, char_f


def chunk_setup(args, config: UserConfig, compute_dtype: str):
    """:func:`offline_ctc_setup` for ``model_config.name: ChunkConformer``:
    the chunk dataloader and a ``ChunkTrainer`` with fresh random weights.
    -> (dataloader, trainer)."""
    from tensorflowasr_tpu_torch.data.chunk_dataloader import (
        ChunkDataLoader,
    )
    from tensorflowasr_tpu_torch.train.chunk_trainer import ChunkTrainer

    phone_f, char_f, p2p, pin, pinyin_txt = build_featurizers(config)
    trainer = ChunkTrainer(config, phone_f.num_classes, char_f.num_classes,
                           device=args.device, compute_dtype=compute_dtype)
    dl = ChunkDataLoader(config, phone_f, char_f,
                         chunk_num=trainer.model_cfg.chunk_num,
                         pinyin2phone=p2p, pinyin=pin,
                         transcripts_are_pinyin=pinyin_txt)
    trainer.init_state()
    return dl, trainer


def _train_state(model: torch.nn.Module, config: UserConfig,
                 device: torch.device):
    """``model`` with seeded Keras-style weights on ``device`` inside a
    fresh train state (Adam of ``optimizer_config``): the layout the
    checkpoints hold."""
    from tensorflowasr_tpu_torch.models.layers import (
        init_weights_,
        set_generator,
    )
    from tensorflowasr_tpu_torch.train.state import (
        ASRTrainState,
        make_optimizer,
    )

    init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(device)
    generator = torch.Generator(device=device).manual_seed(0)
    set_generator(model, generator)
    optimizer = make_optimizer(
        model.parameters(), dict(config["optimizer_config"] or {}))
    return ASRTrainState(model, optimizer, generator)


def restore_or_warn(state, outdir: Optional[str], what: str):
    """Restore the newest checkpoint under ``outdir``/checkpoints into
    ``state``; warn on stderr when there is none (random init). Looking
    creates no directory."""
    from tensorflowasr_tpu_torch.train.checkpoint import CheckpointManager

    if outdir:
        restored = CheckpointManager(
            os.path.join(outdir, "checkpoints")).restore_latest(state)
        if restored is not None:
            return restored
    print(f"warning: no {what} checkpoint found under "
          f"{outdir or '(no outdir)'}; using random init", file=sys.stderr)
    return state


def build_vad_model(config: UserConfig,
                    device: Union[str, torch.device] = "cuda"):
    """(model, train state) from the VAD configs: ``model_config.name``
    ``CNN_Online_VAD`` (the default) or any other name for the offline
    variant, ``dmodel`` and ``speech_config.frame_input``. Shared by
    ``serve_model`` and the VAD training CLIs."""
    from tensorflowasr_tpu_torch.models.vad import OfflineVAD, OnlineVAD
    from tensorflowasr_tpu_torch.utils.device import resolve_device

    sc = config.section("speech_config")
    mc = config.section("model_config")
    cls = OnlineVAD if (mc["name"] or "CNN_Online_VAD") == "CNN_Online_VAD" \
        else OfflineVAD
    model = cls(dmodel=mc["dmodel"] or 32,
                frame_input=sc["frame_input"] or 80)
    state = _train_state(model, config, resolve_device(device))
    return state.model, state


def build_punc_model(config: UserConfig,
                     device: Union[str, torch.device] = "cuda"):
    """(char featurizer, punc dataloader, model, train state) from the
    punctuation config: the ``punc_vocab`` chars, the ``punc_biaodian``
    tokens without ``<S>`` / ``</S>``, and ``max_len =
    min(running_config.max_len or 64, pe_input)``."""
    from tensorflowasr_tpu_torch.data.punc_dataloader import PuncDataLoader
    from tensorflowasr_tpu_torch.models.punc import (
        PuncConfig,
        PuncTransformer,
    )
    from tensorflowasr_tpu_torch.utils.device import resolve_device

    char_f = TextFeaturizer(dict(config.section("punc_vocab").data.items()))
    bd_vocab_path = config.section("punc_biaodian")["vocabulary"]
    punc_tokens = []
    if bd_vocab_path:
        bd_f = TextFeaturizer({"vocabulary": bd_vocab_path,
                               "blank_at_zero": True})
        punc_tokens = [t for t in bd_f.vocab_array
                       if t not in ("<S>", "</S>")]
    punc_cfg = PuncConfig.from_user_config(config)
    rc = config.section("running_config")
    max_len = min(int(rc["max_len"] or 64), punc_cfg.pe_input)
    dl = PuncDataLoader(config, char_f, punc_tokens, max_len=max_len)
    model = PuncTransformer(punc_cfg, char_f.num_classes,
                            dl.num_punc_classes)
    state = _train_state(model, config, resolve_device(device))
    return char_f, dl, state.model, state
