"""Wire framing: multiplexed req/resp + gossip frames over one stream.

Frame layout (all integers unsigned LEB128 varints):
    [kind: 1 byte][payload_len: uvarint][payload]

kinds:
    0x01 REQUEST        payload = [method: uvarint][req_id: uvarint][ssz_snappy]
    0x02 RESPONSE_CHUNK payload = [req_id: uvarint][result: 1 byte][ssz_snappy]
    0x03 RESPONSE_END   payload = [req_id: uvarint]
    0x04 GOSSIP         payload = [topic_len: uvarint][topic utf8][ssz_snappy]
    0x05 GOSSIP_CTRL    payload = gossipsub control record (see
         encode_gossip_ctrl): SUB/UNSUB/GRAFT/PRUNE topic lists + IHAVE
         (topic, message-id list) + IWANT (message-id list)

ssz_snappy = snappy *frame* compression of the SSZ bytes, matching the
reference's req/resp encoding (network/reqresp/encodingStrategies) via the
pure-Python frame codec in utils/snappy.
"""

from __future__ import annotations

import asyncio
from typing import Optional, Tuple

from ..utils.snappy import frame_compress, frame_uncompress

KIND_REQUEST = 0x01
KIND_RESPONSE_CHUNK = 0x02
KIND_RESPONSE_END = 0x03
KIND_GOSSIP = 0x04
KIND_GOSSIP_CTRL = 0x05

MSG_ID_LEN = 20

RESULT_SUCCESS = 0
RESULT_INVALID_REQUEST = 1
RESULT_SERVER_ERROR = 2
RESULT_RATE_LIMITED = 3  # spec ResourceUnavailable class

MAX_PAYLOAD = 32 * 1024 * 1024
# decompressed-size bound for any single wire message: matches the spec's
# MAX_CHUNK_SIZE/GOSSIP_MAX_SIZE class of limits and stops a 32MB frame
# from expanding into hundreds of MB host-side (decompression bomb)
MAX_UNCOMPRESSED = 32 * 1024 * 1024


def write_uvarint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_uvarint(buf: bytes, offset: int = 0) -> Tuple[int, int]:
    """-> (value, next_offset); raises ValueError on truncation."""
    shift = 0
    val = 0
    while True:
        if offset >= len(buf):
            raise ValueError("truncated uvarint")
        b = buf[offset]
        offset += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, offset
        shift += 7
        if shift > 63:
            raise ValueError("uvarint too long")


async def read_uvarint_stream(reader: asyncio.StreamReader) -> int:
    shift = 0
    val = 0
    while True:
        b = (await reader.readexactly(1))[0]
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val
        shift += 7
        if shift > 63:
            raise ValueError("uvarint too long")


class Wire:
    """One framed duplex connection."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._wlock = asyncio.Lock()

    async def send_frame(self, kind: int, payload: bytes) -> None:
        if len(payload) > MAX_PAYLOAD:
            raise ValueError("payload too large")
        async with self._wlock:
            self.writer.write(bytes([kind]) + write_uvarint(len(payload)) + payload)
            await self.writer.drain()

    async def recv_frame(self) -> Tuple[int, bytes]:
        kind = (await self.reader.readexactly(1))[0]
        length = await read_uvarint_stream(self.reader)
        if length > MAX_PAYLOAD:
            raise ValueError("payload too large")
        payload = await self.reader.readexactly(length)
        return kind, payload

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass

    # -- payload builders ------------------------------------------------------

    @staticmethod
    def encode_request(method: int, req_id: int, ssz_bytes: bytes) -> bytes:
        return write_uvarint(method) + write_uvarint(req_id) + frame_compress(ssz_bytes)

    @staticmethod
    def decode_request(payload: bytes) -> Tuple[int, int, bytes]:
        method, off = read_uvarint(payload)
        req_id, off = read_uvarint(payload, off)
        return method, req_id, frame_uncompress(payload[off:], max_output=MAX_UNCOMPRESSED)

    @staticmethod
    def encode_response_chunk(req_id: int, result: int, ssz_bytes: bytes) -> bytes:
        return write_uvarint(req_id) + bytes([result]) + frame_compress(ssz_bytes)

    @staticmethod
    def decode_response_chunk(payload: bytes) -> Tuple[int, int, bytes]:
        req_id, off = read_uvarint(payload)
        if off >= len(payload):
            raise ValueError("truncated response chunk")
        result = payload[off]
        return req_id, result, frame_uncompress(payload[off + 1 :], max_output=MAX_UNCOMPRESSED)

    @staticmethod
    def encode_response_end(req_id: int) -> bytes:
        return write_uvarint(req_id)

    @staticmethod
    def decode_response_end(payload: bytes) -> int:
        req_id, _ = read_uvarint(payload)
        return req_id

    @staticmethod
    def encode_gossip(topic: str, ssz_bytes: bytes) -> bytes:
        t = topic.encode()
        return write_uvarint(len(t)) + t + frame_compress(ssz_bytes)

    @staticmethod
    def decode_gossip(payload: bytes) -> Tuple[str, bytes]:
        tlen, off = read_uvarint(payload)
        topic = payload[off : off + tlen].decode()
        return topic, frame_uncompress(payload[off + tlen :], max_output=MAX_UNCOMPRESSED)

    # -- gossipsub control records ---------------------------------------------

    @staticmethod
    def _enc_topics(topics) -> bytes:
        out = write_uvarint(len(topics))
        for t in topics:
            tb = t.encode()
            out += write_uvarint(len(tb)) + tb
        return out

    @staticmethod
    def _dec_topics(payload: bytes, off: int):
        n, off = read_uvarint(payload, off)
        if n > 4096:
            raise ValueError("too many topics")
        topics = []
        for _ in range(n):
            tlen, off = read_uvarint(payload, off)
            topics.append(payload[off : off + tlen].decode())
            off += tlen
        return topics, off

    @staticmethod
    def encode_gossip_ctrl(ctrl: dict) -> bytes:
        """ctrl keys: sub/unsub/graft/prune (topic lists), ihave (list of
        (topic, [20-byte ids])), iwant ([20-byte ids])."""
        out = b""
        for key in ("sub", "unsub", "graft", "prune"):
            out += Wire._enc_topics(ctrl.get(key, []))
        ihave = ctrl.get("ihave", [])
        out += write_uvarint(len(ihave))
        for topic, ids in ihave:
            tb = topic.encode()
            out += write_uvarint(len(tb)) + tb + write_uvarint(len(ids))
            for mid in ids:
                out += bytes(mid[:MSG_ID_LEN]).ljust(MSG_ID_LEN, b"\x00")
        iwant = ctrl.get("iwant", [])
        out += write_uvarint(len(iwant))
        for mid in iwant:
            out += bytes(mid[:MSG_ID_LEN]).ljust(MSG_ID_LEN, b"\x00")
        return out

    @staticmethod
    def decode_gossip_ctrl(payload: bytes) -> dict:
        ctrl: dict = {}
        off = 0
        for key in ("sub", "unsub", "graft", "prune"):
            topics, off = Wire._dec_topics(payload, off)
            if topics:
                ctrl[key] = topics
        n, off = read_uvarint(payload, off)
        if n > 4096:
            raise ValueError("too many ihave entries")
        ihave = []
        for _ in range(n):
            tlen, off = read_uvarint(payload, off)
            topic = payload[off : off + tlen].decode()
            off += tlen
            k, off = read_uvarint(payload, off)
            if k > 16384:
                raise ValueError("too many ihave ids")
            ids = []
            for _ in range(k):
                ids.append(payload[off : off + MSG_ID_LEN])
                off += MSG_ID_LEN
            ihave.append((topic, ids))
        if ihave:
            ctrl["ihave"] = ihave
        k, off = read_uvarint(payload, off)
        if k > 16384:
            raise ValueError("too many iwant ids")
        iwant = []
        for _ in range(k):
            iwant.append(payload[off : off + MSG_ID_LEN])
            off += MSG_ID_LEN
        if iwant:
            ctrl["iwant"] = iwant
        return ctrl
