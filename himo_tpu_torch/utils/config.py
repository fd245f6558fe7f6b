"""Frozen-dataclass configs with dotted overrides (port of ``himo_tpu/utils/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Type, TypeVar

T = TypeVar("T")


def _convert(value: Any, target_type) -> Any:
    """Best-effort coercion of parsed CLI literals to the field type."""
    if target_type in (int, float, str, bool):
        try:
            return target_type(value)
        except (TypeError, ValueError):
            return value
    if target_type is tuple and isinstance(value, list):
        return tuple(value)
    return value


def apply_overrides(config: T, overrides: Mapping[str, Any]) -> T:
    """Return a copy of a (possibly nested) frozen dataclass with overrides.

    Dotted keys descend into dataclass-typed fields
    (``{"pillar.voxel_size": (0.4, 0.4)}``); unknown keys raise with the
    list of valid fields."""
    if not dataclasses.is_dataclass(config):
        raise TypeError(f"not a dataclass: {type(config)}")
    fields = {f.name for f in dataclasses.fields(config)}
    changes: Dict[str, Any] = {}
    nested: Dict[str, Dict[str, Any]] = {}
    for key, value in overrides.items():
        head, _, rest = key.partition(".")
        if head not in fields:
            raise KeyError(f"unknown config key {head!r}; valid: {sorted(fields)}")
        if rest:
            nested.setdefault(head, {})[rest] = value
        else:
            current = getattr(config, head)
            if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
                changes[head] = apply_overrides(current, value)
            else:
                changes[head] = _convert(value, type(current))
    for head, sub in nested.items():
        base = changes.get(head, getattr(config, head))
        changes[head] = apply_overrides(base, sub)
    return dataclasses.replace(config, **changes)


def split_known_overrides(
    config_cls: Type, overrides: Mapping[str, Any]
) -> tuple[Dict[str, Any], Dict[str, Any]]:
    """Partition overrides into (matching config fields, the rest)."""
    names = {f.name for f in dataclasses.fields(config_cls)}
    known, rest = {}, {}
    for key, value in overrides.items():
        (known if key.split(".")[0] in names else rest)[key] = value
    return known, rest
