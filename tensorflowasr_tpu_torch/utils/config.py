"""Two-file YAML config with dict-merge semantics.

``UserConfig(data_yaml, model_yaml)`` merges two YAML files into one mapping
(model YAML keys override data YAML keys) and returns ``None`` for missing
keys instead of raising, so downstream code can probe optional settings.
Same behaviour as ``tensorflowasr_tpu.utils.config``.
"""

from __future__ import annotations

import os
from collections import UserDict
from typing import Any, Optional

import yaml


def load_yaml(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f) or {}


def _deep_merge(base: dict, override: dict) -> dict:
    """Recursively merge ``override`` into ``base`` (override wins)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class UserConfig(UserDict):
    """Merged view over a data YAML and a model YAML.

    Missing keys return ``None``. Nested section dicts are wrapped so that
    section["missing"] is also None.
    """

    def __init__(self, data_path: Optional[str] = None,
                 model_path: Optional[str] = None,
                 extra: Optional[dict] = None):
        data = load_yaml(data_path) if data_path else {}
        model = load_yaml(model_path) if model_path else {}
        merged = _deep_merge(data, model)
        if extra:
            merged = _deep_merge(merged, extra)
        super().__init__(merged)
        self.data_path = data_path
        self.model_path = model_path

    def __missing__(self, key: str) -> None:  # noqa: D105
        return None

    def __getitem__(self, key: str) -> Any:
        val = self.data.get(key, None)
        if isinstance(val, dict) and not isinstance(val, UserConfig):
            wrapped = UserConfig()
            wrapped.data = val
            return wrapped
        return val

    def section(self, key: str) -> "UserConfig":
        """Return a sub-config (empty if the section is absent)."""
        val = self.data.get(key) or {}
        wrapped = UserConfig()
        wrapped.data = dict(val)
        return wrapped


def cfg_get(section, key: str, default=None):
    """Read a config key from a UserConfig section OR a plain dict,
    falling back to ``default`` when the key is absent or None."""
    if section is None:
        return default
    v = section.get(key) if hasattr(section, "get") else None
    return default if v is None else v


def preprocess_paths(path: Optional[str]) -> Optional[str]:
    """Expand ~ and make absolute."""
    if path is None:
        return None
    return os.path.abspath(os.path.expanduser(path))
