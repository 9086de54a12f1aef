"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``. A CUDA
request on a host without CUDA, or for a card the host does not have,
raises: nothing falls back to the CPU or to another card.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            f"device='cpu' (or --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {dev} requested but this host has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return dev
