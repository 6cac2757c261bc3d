"""TOML configs with the reference's conventions (port of
``lqer_tpu/utils/config.py``; pure Python, kept as its own copy):

* TOML cannot hold None, so ``"NA"`` reads back as None at every depth
  and None is written as ``"NA"``;
* ``--a:b:c=value`` overrides nested keys from the command line, a
  ``:ast:`` prefix taking a Python literal and a plain value cast to the
  existing entry's type;
* per-weight settings are chosen by regex fullmatch
  (:func:`find_matched_pattern`).
"""

from __future__ import annotations

import ast
import re
import tomllib
from copy import deepcopy
from pathlib import Path


def convert_str_na_to_none(d):
    if isinstance(d, dict):
        return {k: convert_str_na_to_none(v) for k, v in d.items()}
    if isinstance(d, list):
        return [convert_str_na_to_none(v) for v in d]
    if isinstance(d, tuple):
        return tuple(convert_str_na_to_none(v) for v in d)
    return None if d == "NA" else d


def convert_none_to_str_na(d):
    if isinstance(d, dict):
        return {k: convert_none_to_str_na(v) for k, v in d.items()}
    if isinstance(d, list):
        return [convert_none_to_str_na(v) for v in d]
    if isinstance(d, tuple):
        return tuple(convert_none_to_str_na(v) for v in d)
    return "NA" if d is None else d


def load_config(config_path) -> dict:
    with open(config_path, "rb") as f:
        config = tomllib.load(f)
    return convert_str_na_to_none(config)


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"Cannot serialize {type(v)} to TOML")


def _toml_key(k: str) -> str:
    return k if re.fullmatch(r"[A-Za-z0-9_-]+", k) else _toml_value(k)


def _dump_toml(d: dict, prefix: str = "") -> str:
    """A minimal TOML writer (the standard library reads TOML but does not
    write it): the scalar keys first, then the sub-tables."""
    lines, tables = [], []
    for k, v in d.items():
        if isinstance(v, dict):
            tables.append((k, v))
        else:
            lines.append(f"{_toml_key(k)} = {_toml_value(v)}")
    out = "\n".join(lines)
    for k, v in tables:
        full = f"{prefix}.{_toml_key(k)}" if prefix else _toml_key(k)
        out += f"\n\n[{full}]\n" + _dump_toml(v, full)
    return out


def save_config(config: dict, config_path) -> None:
    """Write ``config`` as TOML (None as ``"NA"``), checked to parse
    back."""
    config = convert_none_to_str_na(deepcopy(config))
    path = Path(config_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    text = _dump_toml(config).strip() + "\n"
    tomllib.loads(text)
    path.write_text(text)


def find_matched_pattern(query: str, patterns) -> str | None:
    """The one pattern of ``patterns`` that fullmatches ``query``, or
    None; more than one raises ``ValueError``."""
    matched = [p for p in map(re.compile, patterns) if p.fullmatch(query)]
    if len(matched) > 1:
        raise ValueError(f"Multiple patterns matched: {matched}")
    return matched[0].pattern if matched else None


def find_all_matched_patterns(query: str, patterns) -> list[str] | None:
    matched = [p.pattern for p in map(re.compile, patterns)
               if p.fullmatch(query)]
    return matched or None


def set_dict_value(config: dict, keys: list[str], value) -> None:
    if len(keys) == 1:
        config[keys[0]] = value
    else:
        config.setdefault(keys[0], {})
        set_dict_value(config[keys[0]], keys[1:], value)


def get_dict_value(config: dict, keys: list[str]):
    if len(keys) == 1:
        return config[keys[0]]
    if keys[0] not in config:
        raise KeyError(f"Unknown key {keys[0]}.")
    return get_dict_value(config[keys[0]], keys[1:])


def override_args(config: dict, unknown_args: list[str]
                  ) -> tuple[dict, dict]:
    """Apply ``--a:b:c=value`` overrides to ``config`` in place; returns
    ``(config, the overrides as a nested dict)``."""
    overridden: dict = {}
    for flag in unknown_args:
        if not flag.startswith("-") or "=" not in flag:
            raise ValueError(f"Unknown flag {flag}.")
        keys, value = flag.removeprefix("-").removeprefix("-").split("=", 1)
        key_list = keys.split(":")
        if value.startswith(":ast:"):
            value = ast.literal_eval(value.removeprefix(":ast:"))
        else:
            try:
                current = get_dict_value(config, key_list)
            except KeyError:
                current = None   # a new key (say --checkpoint_path=...)
            if isinstance(current, bool):
                value = value.lower() in ("1", "true", "yes")
            elif current is None:
                value = None if value == "NA" else value
            else:
                value = type(current)(value)
        set_dict_value(overridden, key_list, value)
        set_dict_value(config, key_list, value)
    return config, overridden


def flatten_dict(d: dict, new_d: dict, join: str = ":", name: str = "root"
                 ) -> None:
    for k, v in d.items():
        if isinstance(v, dict):
            flatten_dict(v, new_d, join, f"{name}{join}{k}")
        else:
            new_d[f"{name}{join}{k}"] = v
