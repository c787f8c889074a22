"""Minimal TOML serializer (stdlib has ``tomllib`` for reading only).

Emits the subset birda's config uses: nested tables, strings, ints, floats,
bools, and flat arrays. Keys are emitted in insertion order; tables after
scalar keys, as TOML requires.
"""

from __future__ import annotations


def _format_key(key: str) -> str:
    if key and all(c.isalnum() or c in "-_" for c in key):
        return key
    return '"' + key.replace("\\", "\\\\").replace('"', '\\"') + '"'


def _format_value(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        return '"' + value.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_format_value(v) for v in value) + "]"
    raise TypeError(f"cannot serialize {type(value).__name__} to TOML")


def dumps(doc: dict, _prefix: str = "") -> str:
    scalars = []
    tables = []
    for key, value in doc.items():
        if value is None:
            continue
        if isinstance(value, dict):
            tables.append((key, value))
        else:
            scalars.append((key, value))

    out = []
    for key, value in scalars:
        out.append(f"{_format_key(key)} = {_format_value(value)}")
    for key, value in tables:
        name = f"{_prefix}{_format_key(key)}"
        body = dumps(value, name + ".")
        has_scalars = any(
            not isinstance(v, dict) for v in value.values() if v is not None
        )
        if has_scalars or not value:
            out.append("")
            out.append(f"[{name}]")
        out.append(body) if body else None
    return "\n".join(filter(None, out)).strip("\n") + ("\n" if out else "")
