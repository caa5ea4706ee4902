"""Dataclass <-> dict structuring without external deps (port of
human_pose_tpu/configs/structured.py).

The reference uses ``dacite`` (src/base/config.py:59-62) to build nested config
dataclasses from YAML dicts. dacite is not available in this image, so this is
a small structural-typing replacement covering what the configs need:
nested dataclasses, Optional, list/tuple/dict of primitives, and numeric
coercion. Unknown keys at any level are ignored (the reference filters unknown
top-level keys the same way, src/base/config.py:353-374).
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Type, TypeVar, Union

T = TypeVar("T")


def _is_optional(tp) -> bool:
    return typing.get_origin(tp) is Union and type(None) in typing.get_args(tp)


def _strip_optional(tp):
    args = [a for a in typing.get_args(tp) if a is not type(None)]
    return args[0] if len(args) == 1 else Union[tuple(args)]


def structure(data: Any, tp: Type[T]) -> T:
    """Recursively build an instance of ``tp`` from plain python data."""
    if data is None:
        return None  # type: ignore[return-value]
    if tp is Any or tp is None or tp is type(None):
        return data
    if _is_optional(tp):
        return structure(data, _strip_optional(tp))

    origin = typing.get_origin(tp)
    if origin in (list, tuple):
        args = typing.get_args(tp)
        elem_tp = args[0] if args else Any
        seq = [structure(v, elem_tp) for v in data]
        return tuple(seq) if origin is tuple else seq  # type: ignore[return-value]
    if origin is dict:
        args = typing.get_args(tp)
        val_tp = args[1] if len(args) == 2 else Any
        return {k: structure(v, val_tp) for k, v in data.items()}  # type: ignore[return-value]
    if origin is Union:
        for cand in typing.get_args(tp):
            try:
                return structure(data, cand)
            except (TypeError, ValueError):
                continue
        raise TypeError(f"cannot structure {data!r} as {tp}")
    if origin is typing.Literal or str(origin).endswith("Literal"):
        return data

    if dataclasses.is_dataclass(tp):
        if isinstance(data, tp):
            return data  # already structured
        if not isinstance(data, dict):
            raise TypeError(f"expected dict for {tp.__name__}, got {type(data).__name__}")
        fields = {f.name: f for f in dataclasses.fields(tp)}
        hints = typing.get_type_hints(tp)
        kwargs = {}
        for name, value in data.items():
            if name in fields:
                kwargs[name] = structure(value, hints.get(name, Any))
        return tp(**kwargs)  # type: ignore[return-value]

    # primitives with mild coercion (yaml gives int where float expected etc.)
    if tp is float and isinstance(data, (int, float)):
        return float(data)  # type: ignore[return-value]
    if tp is int and isinstance(data, int):
        return int(data)  # type: ignore[return-value]
    if tp is bool:
        if isinstance(data, bool):
            return data  # type: ignore[return-value]
        raise TypeError(f"expected bool, got {data!r}")
    if tp is str:
        if isinstance(data, str):
            return data  # type: ignore[return-value]
        raise TypeError(f"expected str, got {data!r}")
    if isinstance(data, tp):
        return data
    raise TypeError(f"cannot structure {data!r} as {tp}")


def unstructure(obj: Any) -> Any:
    """Dataclass instance -> plain dict (yaml-serializable)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: unstructure(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: unstructure(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [unstructure(v) for v in obj]
    return obj
