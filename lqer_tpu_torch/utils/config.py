"""TOML configs with the reference's ``"NA"`` ⇌ None convention (port of
the loading half of ``lqer_tpu/utils/config.py``): TOML cannot hold None,
so ``"NA"`` reads back as None at every depth."""

from __future__ import annotations

import tomllib


def convert_str_na_to_none(d):
    if isinstance(d, dict):
        return {k: convert_str_na_to_none(v) for k, v in d.items()}
    if isinstance(d, list):
        return [convert_str_na_to_none(v) for v in d]
    if isinstance(d, tuple):
        return tuple(convert_str_na_to_none(v) for v in d)
    return None if d == "NA" else d


def load_config(config_path) -> dict:
    with open(config_path, "rb") as f:
        config = tomllib.load(f)
    return convert_str_na_to_none(config)
