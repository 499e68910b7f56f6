"""YAML config loading (counterpart of ``deeplio_tpu/config/loader.py``)."""

from __future__ import annotations

from typing import Any, Dict

import yaml

from deeplio_tpu_torch.config.schema import Config


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        d: Dict[str, Any] = yaml.safe_load(f) or {}
    return Config.from_dict(d)


def load_config_dict(d: Dict[str, Any]) -> Config:
    return Config.from_dict(d)
