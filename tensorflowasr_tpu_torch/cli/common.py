"""Shared CLI plumbing: argument parser, config loading, featurizers."""

from __future__ import annotations

import argparse
import logging
from typing import Optional, Tuple

from tensorflowasr_tpu_torch.utils.config import UserConfig
from tensorflowasr_tpu_torch.utils.text import (
    PinyinConverter,
    TextFeaturizer,
    load_pinyin2phone,
)


def config_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--data_config", required=True,
                   help="data YAML (speech/augments/running config)")
    p.add_argument("--model_config", required=True,
                   help="model YAML (model_config section)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default; raises without CUDA) or "
                        "on the CPU")
    p.add_argument("--log_level", default="INFO")
    return p


def add_training_flags(p: argparse.ArgumentParser) -> None:
    """The flags ``train_asr`` and ``eval_am`` share on top of
    :func:`config_parser`."""
    p.add_argument("--total_steps", type=int, default=10000)
    p.add_argument("--data_workers", type=int, default=4,
                   help="host threads for wav loading; batches are "
                        "prefetched in the background when > 0")
    p.add_argument("--data_procs", type=int, default=0,
                   help="batch-producer PROCESSES, each owning a train-list "
                        "shard; 0 = threads only. Not ported yet: any other "
                        "value raises")


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


def _refuse_data_procs(args) -> None:
    if args.data_procs > 0:
        raise NotImplementedError(
            "--data_procs > 0 (process workers, data/mp_prefetch.py) is "
            "not ported yet; use --data_workers threads")


def model_name(config: UserConfig) -> str:
    return config.section("model_config")["name"] or "OfflineConformerCTC"


def offline_ctc_setup(args, config: UserConfig, compute_dtype: str):
    """What ``train_asr`` and ``eval_am`` share for the offline family:
    refuse what is not ported, then build the dataloader and the trainer
    (with fresh random weights, computing in ``compute_dtype``) from the
    config. -> (dataloader, trainer, char featurizer)."""
    from tensorflowasr_tpu_torch.data.am_dataloader import AMDataLoader
    from tensorflowasr_tpu_torch.train.asr_trainer import CTCTrainer

    _refuse_data_procs(args)
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

    _refuse_data_procs(args)
    phone_f, char_f, p2p, pin, pinyin_txt = build_featurizers(config)
    trainer = ChunkTrainer(config, phone_f.num_classes, char_f.num_classes,
                           device=args.device, compute_dtype=compute_dtype)
    dl = ChunkDataLoader(config, phone_f, char_f,
                         chunk_num=trainer.model_cfg.chunk_num,
                         pinyin2phone=p2p, pinyin=pin,
                         transcripts_are_pinyin=pinyin_txt)
    trainer.init_state()
    return dl, trainer
