"""Pure-Python snappy codec: block format + framed stream format.

Reference usage: gossip messages are snappy BLOCK compressed
(network/gossip/encoding.ts:70, via snappyjs — also a non-native
implementation), req/resp streams use the snappy FRAMED format
(@chainsafe/snappy-stream, SURVEY §2.9); spec-test vectors ship as
.ssz_snappy (frame format).

Decompressor is complete per the snappy format description.  The
compressor uses a greedy hash-table matcher (format-correct output,
moderate ratio) — interop needs correct *decoding* primarily.
"""

from __future__ import annotations

import struct
from typing import List, Optional

# ---------------------------------------------------------------------------
# varint
# ---------------------------------------------------------------------------


def _read_varint(data: bytes, pos: int):
    shift = 0
    result = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 35:
            raise ValueError("varint too long")


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


# ---------------------------------------------------------------------------
# block format
# ---------------------------------------------------------------------------


def uncompress(data: bytes, max_output: Optional[int] = None) -> bytes:
    """Snappy block-format decompression.

    ``max_output`` bounds the decoded size (checked against the declared
    length up front AND inside the decode loop): untrusted wire input could
    otherwise declare ~2^36 bytes and expand a small frame into hundreds of
    MB via the byte-wise copy loop (a decompression bomb)."""
    length, pos = _read_varint(data, 0)
    if max_output is not None and length > max_output:
        raise ValueError(f"declared length {length} exceeds bound {max_output}")
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            size = tag >> 2
            if size >= 60:
                extra = size - 59
                if pos + extra > n:
                    raise ValueError("truncated literal length")
                size = int.from_bytes(data[pos : pos + extra], "little")
                pos += extra
            size += 1
            if pos + size > n:
                raise ValueError("truncated literal")
            if len(out) + size > length:
                raise ValueError("output exceeds declared length")
            out += data[pos : pos + size]
            pos += size
            continue
        if kind == 1:  # copy, 1-byte offset
            size = ((tag >> 2) & 0x7) + 4
            if pos >= n:
                raise ValueError("truncated copy-1")
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            size = (tag >> 2) + 1
            if pos + 2 > n:
                raise ValueError("truncated copy-2")
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            size = (tag >> 2) + 1
            if pos + 4 > n:
                raise ValueError("truncated copy-4")
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("invalid copy offset")
        if len(out) + size > length:
            raise ValueError("output exceeds declared length")
        for _ in range(size):  # overlapping copies must go byte-wise
            out.append(out[-offset])
    if len(out) != length:
        raise ValueError(f"length mismatch: header {length}, got {len(out)}")
    return bytes(out)


def compress(data: bytes) -> bytes:
    """Greedy snappy block-format compressor (hash-table matcher)."""
    out = bytearray(_write_varint(len(data)))
    n = len(data)
    if n == 0:
        return bytes(out)

    def emit_literal(lit: bytes):
        size = len(lit) - 1
        if size < 60:
            out.append(size << 2)
        elif size < 0x100:
            out.append(60 << 2)
            out.append(size)
        elif size < 0x10000:
            out.append(61 << 2)
            out.extend(size.to_bytes(2, "little"))
        elif size < 0x1000000:
            out.append(62 << 2)
            out.extend(size.to_bytes(3, "little"))
        else:
            out.append(63 << 2)
            out.extend(size.to_bytes(4, "little"))
        out.extend(lit)

    def emit_copy(offset: int, length: int):
        while length >= 68:
            out.append((63 << 2) | 2)
            out.extend(offset.to_bytes(2, "little"))
            length -= 64
        if length > 64:
            out.append((59 << 2) | 2)  # 60-byte copy
            out.extend(offset.to_bytes(2, "little"))
            length -= 60
        if 4 <= length <= 11 and offset < 2048:
            out.append(((length - 4) << 2) | ((offset >> 8) << 5) | 1)
            out.append(offset & 0xFF)
        else:
            out.append(((length - 1) << 2) | 2)
            out.extend(offset.to_bytes(2, "little"))

    table: dict = {}
    i = 0
    lit_start = 0
    while i + 4 <= n:
        key = data[i : i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand < 0x8000 and data[cand : cand + 4] == key:
            # extend match
            length = 4
            while i + length < n and length < 64 and data[cand + length] == data[i + length]:
                length += 1
            if i > lit_start:
                emit_literal(data[lit_start:i])
            emit_copy(i - cand, length)
            i += length
            lit_start = i
        else:
            i += 1
    if lit_start < n:
        emit_literal(data[lit_start:n])
    return bytes(out)


# ---------------------------------------------------------------------------
# CRC32-C (Castagnoli) with the snappy frame masking
# ---------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    rot = ((crc >> 15) | (crc << 17)) & 0xFFFFFFFF
    return (rot + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# framed format (stream identifier + chunks)
# ---------------------------------------------------------------------------

_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_MAX_UNCOMPRESSED_CHUNK = 65536


def frame_compress(data: bytes) -> bytes:
    out = bytearray(_STREAM_ID)
    for i in range(0, max(len(data), 1), _MAX_UNCOMPRESSED_CHUNK):
        chunk = data[i : i + _MAX_UNCOMPRESSED_CHUNK]
        body = struct.pack("<I", _masked_crc(chunk)) + compress(chunk)
        if len(body) - 4 >= len(chunk):  # compression not worth it
            body = struct.pack("<I", _masked_crc(chunk)) + chunk
            out += b"\x01" + len(body).to_bytes(3, "little") + body
        else:
            out += b"\x00" + len(body).to_bytes(3, "little") + body
        if not data:
            break
    return bytes(out)


def frame_uncompress(data: bytes, max_output: Optional[int] = None) -> bytes:
    """Framed decompression with the spec's 65536-byte uncompressed-chunk
    limit enforced and an optional total-output bound (``max_output``) —
    both required on untrusted peer input."""
    pos = 0
    out = bytearray()
    n = len(data)
    while pos < n:
        if pos + 4 > n:
            raise ValueError("truncated chunk header")
        ctype = data[pos]
        clen = int.from_bytes(data[pos + 1 : pos + 4], "little")
        pos += 4
        if pos + clen > n:
            raise ValueError("truncated chunk body")
        body = data[pos : pos + clen]
        pos += clen
        if ctype == 0xFF:  # stream identifier
            if body != _STREAM_ID[4:]:
                raise ValueError("bad stream identifier")
            continue
        if ctype in (0x00, 0x01) and clen < 4:
            # chunk too short to carry its CRC — keep the module's
            # ValueError convention (struct.error would leak to decoders)
            raise ValueError("chunk body shorter than CRC")
        if ctype == 0x00:  # compressed
            crc = struct.unpack("<I", body[:4])[0]
            chunk = uncompress(body[4:], max_output=_MAX_UNCOMPRESSED_CHUNK)
            if _masked_crc(chunk) != crc:
                raise ValueError("crc mismatch")
            out += chunk
        elif ctype == 0x01:  # uncompressed
            crc = struct.unpack("<I", body[:4])[0]
            chunk = body[4:]
            if len(chunk) > _MAX_UNCOMPRESSED_CHUNK:
                raise ValueError("uncompressed chunk exceeds 65536")
            if _masked_crc(chunk) != crc:
                raise ValueError("crc mismatch")
            out += chunk
        elif ctype <= 0x7F:
            raise ValueError(f"unknown unskippable chunk type {ctype:#x}")
        # 0x80..0xfe: skippable, ignore
        if max_output is not None and len(out) > max_output:
            raise ValueError(f"frame output exceeds bound {max_output}")
    return bytes(out)
