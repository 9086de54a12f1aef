"""What the harness takes from the program (the port,
``tensorflowasr_tpu_torch``): its models built from a configuration file's
sections, with the benchmark's weights loaded; and the sizes the
references and generators read from the same file. Imports of the port
stay inside these functions."""

from __future__ import annotations

import torch


def _on(device: torch.device, build):
    with torch.device(device):
        return build()


def conformer(config: dict, weights: dict, device: torch.device):
    """A ConformerCTC in the configuration's compute dtype on ``device``
    holding ``weights`` (eval mode)."""
    from tensorflowasr_tpu_torch.models.conformer import (
        ConformerConfig,
        ConformerCTC,
    )
    cfg = ConformerConfig.from_user_config(
        {"model_config": config["model_config"],
         "speech_config": config["speech_config"]}, config["dtype"])
    model = _on(device, lambda: ConformerCTC(
        cfg, config["num_phone_classes"], config["num_char_classes"]))
    model.load_state_dict(weights, strict=True)
    return model.eval()


def chunk_conformer(config: dict, weights: dict, device: torch.device):
    from tensorflowasr_tpu_torch.models.chunk_conformer import (
        ChunkConformer,
        ChunkConformerConfig,
    )
    cfg = ChunkConformerConfig.from_user_config(
        {"model_config": config["model_config"]}, config["dtype"])
    model = _on(device, lambda: ChunkConformer(
        cfg, config["num_phone_classes"], config["num_char_classes"]))
    model.load_state_dict(weights, strict=True)
    return model.eval()


def batch_sizes(config: dict, m: dict) -> dict:
    """What the batch generator needs of a ConformerCTC configuration."""
    return dict(m, hop=m["sample_rate"] * m["stride_ms"] // 1000,
                num_phone_classes=config["num_phone_classes"],
                num_char_classes=config["num_char_classes"],
                char_end_id=config["char_end_id"])


def reference_sizes(config: dict) -> dict:
    """The sizes the plain references read, from the configuration's
    sections (``model_config`` and ``speech_config`` as the shipped YAML
    files have them)."""
    mc = config["model_config"]
    if "ChunkConformerFront" in mc:
        front = mc["ChunkConformerFront"]
        stacks = {key: mc[name] for key, name in (
            ("encoder", "ChunkConformerEncoder"),
            ("picker", "ChunkCTCPicker"), ("decoder", "ChunkCTCDecoder"),
            ("helper", "ContextHelper"))}
        return dict(front, encoder=stacks["encoder"],
                    picker=stacks["picker"], decoder=stacks["decoder"],
                    helper=stacks["helper"])
    sc = config["speech_config"]
    return dict(mc, num_feature_bins=sc["num_feature_bins"],
                sample_rate=sc["sample_rate"], stride_ms=sc["stride_ms"])
