"""Eth1 JSON-RPC provider + merge-block (TTD) tracker.

Reference: packages/beacon-node/src/eth1/provider/ (JsonRpcHttpClient with
request batching, eth1Provider.ts getBlockByNumber/getDepositEvents) and
eth1/eth1MergeBlockTracker.ts:43 (the TTD search that finds the terminal
PoW block for the merge transition).

The HTTP client is stdlib-asyncio (same pattern as execution/engine.py);
the deposit-log decoding covers the deposit contract's DepositEvent ABI
(the only log the tracker consumes).
"""

from __future__ import annotations

import asyncio
import itertools
import json
from typing import Dict, List, Optional

from ..ssz import Fields
from ..utils.logger import get_logger

logger = get_logger("eth1")

# DepositEvent(bytes pubkey, bytes withdrawal_credentials, bytes amount,
#              bytes signature, bytes index) — keccak topic of the event
DEPOSIT_EVENT_TOPIC = "0x649bbc62d0e31342afea4e5cd82d4049e7e1ee912fc0889aa790803be39038c5"


class Eth1Error(Exception):
    pass


class Eth1JsonRpcProvider:
    """Batching JSON-RPC client over plain HTTP (provider/jsonRpcHttpClient.ts)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._ids = itertools.count(1)

    async def _post(self, payload) -> object:
        data = json.dumps(payload).encode()
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), self.timeout
        )

        async def talk():
            req = (
                f"POST / HTTP/1.1\r\nhost: {self.host}\r\n"
                "content-type: application/json\r\n"
                f"content-length: {len(data)}\r\nconnection: close\r\n\r\n"
            ).encode() + data
            writer.write(req)
            await writer.drain()
            status_line = await reader.readline()
            status = int(status_line.split()[1])
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
            body = await reader.read()
            if status >= 400:
                raise Eth1Error(f"eth1 rpc http {status}")
            return json.loads(body)

        try:
            # one deadline for the whole exchange: a peer that stalls
            # mid-headers must not hang the tracker
            return await asyncio.wait_for(talk(), self.timeout)
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def rpc(self, method: str, params: list) -> object:
        out = await self._post(
            {"jsonrpc": "2.0", "id": next(self._ids), "method": method, "params": params}
        )
        if "error" in out:
            raise Eth1Error(f"{method}: {out['error']}")
        return out["result"]

    async def rpc_batch(self, calls: List[tuple]) -> List[object]:
        """[(method, params), ...] in ONE http request (the reference's
        fetchBatch) — the deposit tracker's catch-up pattern."""
        if not calls:
            return []
        payload = [
            {"jsonrpc": "2.0", "id": next(self._ids), "method": m, "params": p}
            for m, p in calls
        ]
        out = await self._post(payload)
        if not isinstance(out, list):
            raise Eth1Error("batch response is not a list")
        by_id = {o["id"]: o for o in out}
        results = []
        for req in payload:
            o = by_id.get(req["id"])
            if o is None or "error" in (o or {}):
                raise Eth1Error(f"batch item failed: {o}")
            results.append(o["result"])
        return results

    # -- typed helpers (eth1Provider.ts surface) ----------------------------

    @staticmethod
    def _qty(v) -> str:
        return hex(v) if isinstance(v, int) else v

    async def get_block_number(self) -> int:
        return int(await self.rpc("eth_blockNumber", []), 16)

    async def get_block_by_number(self, number) -> Optional[Fields]:
        raw = await self.rpc("eth_getBlockByNumber", [self._qty(number), False])
        return self._decode_block(raw)

    async def get_block_by_hash(self, block_hash: bytes) -> Optional[Fields]:
        raw = await self.rpc("eth_getBlockByHash", ["0x" + block_hash.hex(), False])
        return self._decode_block(raw)

    async def get_blocks_by_number(self, numbers: List[int]) -> List[Optional[Fields]]:
        raws = await self.rpc_batch(
            [("eth_getBlockByNumber", [self._qty(n), False]) for n in numbers]
        )
        return [self._decode_block(r) for r in raws]

    @staticmethod
    def _decode_block(raw) -> Optional[Fields]:
        if raw is None:
            return None
        return Fields(
            number=int(raw["number"], 16),
            block_hash=bytes.fromhex(raw["hash"][2:]),
            parent_hash=bytes.fromhex(raw["parentHash"][2:]),
            timestamp=int(raw["timestamp"], 16),
            total_difficulty=int(raw.get("totalDifficulty", "0x0"), 16),
        )

    async def get_deposit_events(
        self, deposit_contract: bytes, from_block: int, to_block: int
    ) -> List[Fields]:
        logs = await self.rpc(
            "eth_getLogs",
            [
                {
                    "fromBlock": hex(from_block),
                    "toBlock": hex(to_block),
                    "address": "0x" + deposit_contract.hex(),
                    "topics": [DEPOSIT_EVENT_TOPIC],
                }
            ],
        )
        out = []
        for log in logs:
            data = bytes.fromhex(log["data"][2:])
            out.append(
                Fields(
                    block_number=int(log["blockNumber"], 16),
                    deposit_data=_decode_deposit_event_data(data),
                )
            )
        return out


def _decode_deposit_event_data(data: bytes) -> Fields:
    """ABI-decode DepositEvent's five dynamic bytes fields."""

    def dyn_bytes(offset_slot: int) -> bytes:
        off = int.from_bytes(data[offset_slot * 32 : offset_slot * 32 + 32], "big")
        ln = int.from_bytes(data[off : off + 32], "big")
        return data[off + 32 : off + 32 + ln]

    pubkey = dyn_bytes(0)
    wc = dyn_bytes(1)
    amount = int.from_bytes(dyn_bytes(2), "little")
    signature = dyn_bytes(3)
    index = int.from_bytes(dyn_bytes(4), "little")
    return Fields(
        pubkey=pubkey,
        withdrawal_credentials=wc,
        amount=amount,
        signature=signature,
        index=index,
    )


class Eth1MergeBlockTracker:
    """Find the terminal PoW block: the first block whose totalDifficulty
    reaches TERMINAL_TOTAL_DIFFICULTY while its parent's stays below
    (eth1MergeBlockTracker.ts:43).  Strategies: TERMINAL_BLOCK_HASH
    override, forward polling near the head, and a bisection fallback for
    catch-up."""

    def __init__(self, cfg, provider):
        self.cfg = cfg
        self.provider = provider
        self.merge_block: Optional[Fields] = None

    async def get_terminal_pow_block(self) -> Optional[Fields]:
        if self.merge_block is not None:
            return self.merge_block
        ttd = self.cfg.TERMINAL_TOTAL_DIFFICULTY
        tbh = getattr(self.cfg, "TERMINAL_BLOCK_HASH", b"\x00" * 32)
        if tbh != b"\x00" * 32:
            blk = await self.provider.get_block_by_hash(tbh)
            if blk is not None:
                self.merge_block = blk
            return blk
        head_number = await self.provider.get_block_number()
        head = await self.provider.get_block_by_number(head_number)
        if head is None or head.total_difficulty < ttd:
            return None  # TTD not reached yet
        # bisect the first block with td >= ttd
        lo, hi = 0, head_number  # invariant: td(hi) >= ttd
        while lo < hi:
            mid = (lo + hi) // 2
            blk = await self.provider.get_block_by_number(mid)
            if blk is None:
                lo = mid + 1
                continue
            if blk.total_difficulty >= ttd:
                hi = mid
            else:
                lo = mid + 1
        blk = await self.provider.get_block_by_number(hi)
        if blk is not None and blk.total_difficulty >= ttd:
            self.merge_block = blk
            logger.info(
                "terminal PoW block: number %d hash %s",
                blk.number, blk.block_hash.hex()[:12],
            )
            return blk
        return None
