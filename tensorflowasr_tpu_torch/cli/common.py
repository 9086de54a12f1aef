"""Shared CLI plumbing: argument parser, config loading, featurizers."""

from __future__ import annotations

import argparse
import logging
from typing import Tuple

from tensorflowasr_tpu_torch.utils.config import UserConfig
from tensorflowasr_tpu_torch.utils.text import TextFeaturizer


def config_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--data_config", required=True,
                   help="data YAML (speech/vocabulary config)")
    p.add_argument("--model_config", required=True,
                   help="model YAML (model_config section)")
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the GPU (default; raises without CUDA) or "
                        "on the CPU")
    p.add_argument("--log_level", default="INFO")
    return p


def load_config(args) -> UserConfig:
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    return UserConfig(args.data_config, args.model_config)


def build_featurizers(config: UserConfig
                      ) -> Tuple[TextFeaturizer, TextFeaturizer]:
    """-> (phone featurizer, char featurizer)."""
    phone_f = TextFeaturizer(dict(config.section("inp_config").data))
    char_f = TextFeaturizer(dict(config.section("tar_config").data))
    return phone_f, char_f
