"""CLI dot-path overrides: ``--a.b.c=value`` merged into a config dict
(port of human_pose_tpu/configs/cli.py).

Same UX as the reference (src/base/config.py:323-383): values are coerced to
None/bool/int/float/str, unknown top-level keys are dropped, nested keys are
created on demand.
"""

from __future__ import annotations

import sys
from typing import Any


def parse_cli_value(value: str) -> Any:
    if value.lower() in ("none", "null"):
        return None
    if value.lower() == "true":
        return True
    if value.lower() == "false":
        return False
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.startswith("[") and value.endswith("]"):
        inner = value[1:-1].strip()
        if not inner:
            return []
        return [parse_cli_value(v.strip()) for v in inner.split(",")]
    return value


def set_dot_path(cfg: dict, dot_key: str, value: Any) -> None:
    keys = dot_key.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def update_dict(base: dict, new: dict) -> dict:
    """Recursive merge of ``new`` into ``base`` (in place, returned)."""
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            update_dict(base[k], v)
        else:
            base[k] = v
    return base


def parse_args_for_config(argv: list[str] | None = None, allowed_top_keys: set[str] | None = None) -> dict:
    """Parse ``--a.b.c=v`` tokens from argv into a nested dict."""
    if argv is None:
        argv = sys.argv[1:]
    out: dict = {}
    for token in argv:
        if not token.startswith("--") or "=" not in token:
            continue
        key, _, raw = token[2:].partition("=")
        if allowed_top_keys is not None and key.split(".")[0] not in allowed_top_keys:
            continue
        set_dot_path(out, key, parse_cli_value(raw))
    return out


def update_config(cfg_dict: dict, argv: list[str] | None = None, allowed_top_keys: set[str] | None = None) -> dict:
    return update_dict(cfg_dict, parse_args_for_config(argv, allowed_top_keys))
