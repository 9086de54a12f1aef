"""Checkpoints of the full train state, one file per step.

Counterpart of ``tensorflowasr_tpu/train/checkpoint.py`` without orbax: the
state's ``state_dict()`` (model parameters and BatchNorm buffers, optimizer
moments, step, generator state) goes through ``torch.save`` to a temporary
name in the same directory and is renamed into place, so a reader never sees
half a file. The newest ``max_to_keep`` steps are kept. The directory is
made by the first save, so looking for a checkpoint creates nothing.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 10):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:09d}.pt")

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: Any) -> None:
        self.write(step, state.state_dict())

    def write(self, step: int, state_dict: dict) -> None:
        """Write a state's ``state_dict()`` as step ``step``'s checkpoint."""
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(step)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            torch.save(state_dict, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(self, state: Any) -> Optional[Any]:
        """Load the newest checkpoint into ``state`` (tensors land on the
        devices ``state`` already uses) and return it; None when the
        directory holds no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        state.load_state_dict(torch.load(self._path(step),
                                         map_location="cpu",
                                         weights_only=True))
        return state
