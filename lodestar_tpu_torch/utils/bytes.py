"""Byte helpers (reference: packages/utils/src/bytes.ts).

Endianness note: the consensus spec is little-endian for integer
serialization (intToBytes/bytesToInt in the reference default to LE).
"""

from __future__ import annotations


def to_hex(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def from_hex(s: str) -> bytes:
    if s.startswith("0x") or s.startswith("0X"):
        s = s[2:]
    return bytes.fromhex(s)


def int_to_bytes(value: int, length: int, endianness: str = "little") -> bytes:
    return int(value).to_bytes(length, endianness)  # type: ignore[arg-type]


def bytes_to_int(data: bytes, endianness: str = "little") -> int:
    return int.from_bytes(data, endianness)  # type: ignore[arg-type]


def bytes32_equal(a: bytes, b: bytes) -> bool:
    return bytes(a) == bytes(b)
