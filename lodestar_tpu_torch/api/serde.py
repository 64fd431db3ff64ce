"""JSON <-> container conversion with eth2 API conventions.

Reference: packages/api's JSON types — uint64s are decimal STRINGS, byte
fields are 0x-hex, container keys snake_case (which our Fields already
use).  Conversion is shape-driven: ints/bools/bytes/lists/Fields recurse.
"""

from __future__ import annotations

from typing import Any

from ..ssz import Fields


def to_json(v: Any) -> Any:
    if isinstance(v, Fields):
        return {k: to_json(v[k]) for k in v.keys()}
    if isinstance(v, (bytes, bytearray, memoryview)):
        return "0x" + bytes(v).hex()
    if isinstance(v, bool):
        return v
    if isinstance(v, int):
        return str(v)
    if isinstance(v, (list, tuple)):
        return [to_json(x) for x in v]
    if isinstance(v, float):
        return v
    if v is None:
        return None
    # numpy scalars and ssz wrappers
    try:
        return str(int(v))
    except Exception:
        return str(v)


def from_json(j: Any) -> Any:
    """JSON -> Fields/py values (inverse by shape; uint strings -> int,
    0x -> bytes, dict -> Fields)."""
    if isinstance(j, dict):
        return Fields(**{k: from_json(v) for k, v in j.items()})
    if isinstance(j, list):
        return [from_json(x) for x in j]
    if isinstance(j, str):
        if j.startswith("0x"):
            try:
                return bytes.fromhex(j[2:])
            except ValueError:
                return j
        if j.isdigit():
            return int(j)
        return j
    return j
