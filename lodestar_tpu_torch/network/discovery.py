"""Peer discovery: signed node records + a UDP FINDNODE protocol.

Reference: packages/beacon-node/src/network/peers/discover.ts:78 +
@chainsafe/discv5 (UDP ENR DHT).  The reference's discovery is a
dependency stack (discv5 handshake crypto, secp256k1/keccak ENRs —
SURVEY §2.9); this framework implements the same capability natively:

- ``NodeRecord``: an ENR-equivalent signed record (seq number, identity
  pubkey, ip/tcp/udp, attnets/syncnets bitfields) — BLS-signed with
  sha256 digests instead of secp256k1/keccak, since the node identity
  key here IS a BLS key and the wire is framework-native either way.
- ``DiscoveryService``: PING/PONG/FINDNODE/NODES over UDP with a
  last-seen routing table, bootstrap list, periodic random lookups, and
  a found-peer callback the Network uses to dial new peers (subnet-aware
  preference like discover.ts's subnet queries).

Record encoding is SSZ-style length-prefixed fields; every record is
verified (signature over its content) before entering the table, so a
hostile peer cannot forge records for identities it does not hold.
"""

from __future__ import annotations

import asyncio
import hashlib
import secrets as _secrets
import struct
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..crypto.bls.api import PublicKey, SecretKey, Signature, verify
from ..utils.logger import get_logger

logger = get_logger("discovery")

MSG_PING = 1
MSG_PONG = 2
MSG_FINDNODE = 3
MSG_NODES = 4

MAX_RECORDS_PER_RESPONSE = 16
TABLE_SIZE = 256
RECORD_SIGN_DOMAIN = b"lodestar-tpu-node-record-v1"


def _pack_bytes(b: bytes) -> bytes:
    return struct.pack("<H", len(b)) + b


def _unpack_bytes(buf: bytes, off: int) -> Tuple[bytes, int]:
    (n,) = struct.unpack_from("<H", buf, off)
    off += 2
    return buf[off : off + n], off + n


@dataclass
class NodeRecord:
    """ENR-equivalent signed node record."""

    seq: int
    pubkey: bytes  # 48-byte BLS identity key
    ip: str
    tcp_port: int
    udp_port: int
    attnets: bytes = b"\x00" * 8  # 64-bit bitfield
    syncnets: bytes = b"\x00"
    signature: bytes = b""

    @property
    def node_id(self) -> bytes:
        return hashlib.sha256(self.pubkey).digest()

    def _signed_content(self) -> bytes:
        return (
            RECORD_SIGN_DOMAIN
            + struct.pack("<Q", self.seq)
            + self.pubkey
            + _pack_bytes(self.ip.encode())
            + struct.pack("<HH", self.tcp_port, self.udp_port)
            + self.attnets
            + self.syncnets
        )

    def sign(self, sk: SecretKey) -> "NodeRecord":
        self.signature = sk.sign(hashlib.sha256(self._signed_content()).digest()).to_bytes()
        return self

    def verify_signature(self) -> bool:
        try:
            return verify(
                PublicKey.from_bytes(self.pubkey),
                hashlib.sha256(self._signed_content()).digest(),
                Signature.from_bytes(self.signature),
            )
        except ValueError:
            return False

    def encode(self) -> bytes:
        return (
            struct.pack("<Q", self.seq)
            + self.pubkey
            + _pack_bytes(self.ip.encode())
            + struct.pack("<HH", self.tcp_port, self.udp_port)
            + self.attnets
            + self.syncnets
            + _pack_bytes(self.signature)
        )

    @classmethod
    def decode(cls, buf: bytes) -> "NodeRecord":
        off = 0
        (seq,) = struct.unpack_from("<Q", buf, off)
        off += 8
        pubkey = buf[off : off + 48]
        off += 48
        ip, off = _unpack_bytes(buf, off)
        tcp_port, udp_port = struct.unpack_from("<HH", buf, off)
        off += 4
        attnets = buf[off : off + 8]
        off += 8
        syncnets = buf[off : off + 1]
        off += 1
        sig, off = _unpack_bytes(buf, off)
        return cls(
            seq=seq, pubkey=pubkey, ip=ip.decode(), tcp_port=tcp_port,
            udp_port=udp_port, attnets=attnets, syncnets=syncnets, signature=sig,
        )


@dataclass
class _Entry:
    record: NodeRecord
    last_seen: float = field(default_factory=time.monotonic)


class DiscoveryService(asyncio.DatagramProtocol):
    """UDP discovery endpoint + routing table (peers/discover.ts role)."""

    def __init__(
        self,
        identity: SecretKey,
        *,
        tcp_port: int,
        host: str = "127.0.0.1",
        on_peer: Optional[Callable[[NodeRecord], None]] = None,
    ):
        self.identity = identity
        self.host = host
        self.tcp_port = tcp_port
        self.udp_port: Optional[int] = None
        self.on_peer = on_peer
        self.table: Dict[bytes, _Entry] = {}
        self.record = NodeRecord(
            seq=1, pubkey=identity.to_public_key().to_bytes(), ip=host,
            tcp_port=tcp_port, udp_port=0,
        ).sign(identity)
        self._transport: Optional[asyncio.DatagramTransport] = None
        self._task: Optional[asyncio.Task] = None
        self.lookups = 0

    # -- lifecycle ------------------------------------------------------------

    async def listen(self, udp_port: int = 0) -> int:
        loop = asyncio.get_event_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: self, local_addr=(self.host, udp_port)
        )
        self.udp_port = self._transport.get_extra_info("sockname")[1]
        self.record.udp_port = self.udp_port
        self.record.seq += 1
        self.record.sign(self.identity)
        logger.info("discovery on udp %s:%d", self.host, self.udp_port)
        return self.udp_port

    def start_lookups(self, interval: float = 5.0) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._lookup_loop(interval))

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None
        if self._transport is not None:
            self._transport.close()

    # -- bootstrap / lookups --------------------------------------------------

    def add_bootstrap(self, host: str, udp_port: int) -> None:
        self._send(MSG_PING, self.record.encode(), (host, udp_port))

    async def _lookup_loop(self, interval: float) -> None:
        while True:
            await asyncio.sleep(interval)
            self.lookups += 1
            for entry in list(self.table.values())[:8]:
                rec = entry.record
                self._send(MSG_FINDNODE, b"", (rec.ip, rec.udp_port))

    def find_nodes(self) -> None:
        """One immediate FINDNODE round to everyone we know."""
        self.lookups += 1
        for entry in list(self.table.values()):
            rec = entry.record
            self._send(MSG_FINDNODE, b"", (rec.ip, rec.udp_port))

    def update_subnets(self, attnets: List[bool], syncnets: List[bool]) -> None:
        """ENR attnets/syncnets refresh (attnetsService ENR updates)."""
        att = bytearray(8)
        for i, bit in enumerate(attnets[:64]):
            if bit:
                att[i // 8] |= 1 << (i % 8)
        syn = bytearray(1)
        for i, bit in enumerate(syncnets[:4]):
            if bit:
                syn[0] |= 1 << i
        self.record.attnets = bytes(att)
        self.record.syncnets = bytes(syn)
        self.record.seq += 1
        self.record.sign(self.identity)

    # -- datagram plumbing ----------------------------------------------------

    def _send(self, msg: int, payload: bytes, addr) -> None:
        if self._transport is None:
            return
        try:
            self._transport.sendto(bytes([msg]) + payload, addr)
        except Exception:  # pragma: no cover - fire and forget
            pass

    def datagram_received(self, data: bytes, addr) -> None:
        if not data:
            return
        msg, payload = data[0], data[1:]
        try:
            if msg == MSG_PING:
                self._accept_record(payload)
                self._send(MSG_PONG, self.record.encode(), addr)
            elif msg == MSG_PONG:
                self._accept_record(payload)
            elif msg == MSG_FINDNODE:
                records = [self.record.encode()]  # own record always first
                records += [e.record.encode() for e in list(self.table.values())]
                blob = b"".join(_pack_bytes(r) for r in records[:MAX_RECORDS_PER_RESPONSE])
                self._send(MSG_NODES, blob, addr)
            elif msg == MSG_NODES:
                off = 0
                while off < len(payload):
                    raw, off = _unpack_bytes(payload, off)
                    self._accept_record(raw)
        except Exception as e:  # noqa: BLE001 - hostile datagrams must not kill us
            logger.debug("bad discovery datagram from %s: %s", addr, e)

    def _accept_record(self, raw: bytes) -> None:
        rec = NodeRecord.decode(raw)
        if rec.pubkey == self.record.pubkey:
            return  # ourselves
        if not rec.verify_signature():
            logger.debug("discovery record with bad signature dropped")
            return
        existing = self.table.get(rec.node_id)
        if existing is not None and existing.record.seq >= rec.seq:
            existing.last_seen = time.monotonic()
            return
        is_new = existing is None
        if len(self.table) >= TABLE_SIZE and is_new:
            # evict the stalest entry
            oldest = min(self.table.values(), key=lambda e: e.last_seen)
            del self.table[oldest.record.node_id]
        self.table[rec.node_id] = _Entry(record=rec)
        if is_new and self.on_peer is not None:
            self.on_peer(rec)
