"""Req/resp protocol: method registry + server dispatch + client calls.

Reference: packages/beacon-node/src/network/reqresp/reqResp.ts:45 (method
set + rate limits) and reqresp/handlers/index.ts (server side answering
from chain/db).  Methods carried over: status, goodbye, ping, metadata,
beaconBlocksByRange, beaconBlocksByRoot — the set range sync and peering
need (SURVEY §2.5).
"""

from __future__ import annotations

import asyncio
import itertools
from typing import Awaitable, Callable, Dict, List, Optional

from ..params import Preset
from ..types import get_types
from ..utils.logger import get_logger
from .wire import (
    KIND_RESPONSE_CHUNK,
    KIND_RESPONSE_END,
    RESULT_INVALID_REQUEST,
    RESULT_RATE_LIMITED,
    RESULT_SERVER_ERROR,
    RESULT_SUCCESS,
    Wire,
)

logger = get_logger("reqresp")

METHOD_STATUS = 0
METHOD_GOODBYE = 1
METHOD_PING = 2
METHOD_METADATA = 3
METHOD_BLOCKS_BY_RANGE = 4
METHOD_BLOCKS_BY_ROOT = 5

MAX_REQUEST_BLOCKS = 1024

# Per-method response-chunk ceilings (reference: maxResponseChunks wired
# into each protocol def, reqResp.ts:94-127).  Single-chunk methods get 1;
# block methods get MAX_REQUEST_BLOCKS.  A malicious server streaming more
# chunks than its method allows is cut off instead of OOM-ing the client.
MAX_RESPONSE_CHUNKS = {
    METHOD_STATUS: 1,
    METHOD_GOODBYE: 1,
    METHOD_PING: 1,
    METHOD_METADATA: 1,
    METHOD_BLOCKS_BY_RANGE: MAX_REQUEST_BLOCKS,
    METHOD_BLOCKS_BY_ROOT: MAX_REQUEST_BLOCKS,
}
# total decompressed bytes a single request may accumulate client-side
MAX_RESPONSE_TOTAL_BYTES = 128 * 1024 * 1024


class RateTracker:
    """Sliding-window quota (reqresp/rateTracker.ts:14): N units per
    60-second window.  requestCount and objectCount (blocks served) are
    tracked separately per peer connection."""

    def __init__(self, limit: int, window_s: float = 60.0):
        self.limit = limit
        self.window_s = window_s
        self._events: List[tuple] = []  # (monotonic_time, units)

    def request_units(self, units: int = 1) -> bool:
        """True if the quota admits `units` more; records them if so."""
        import time as _t

        now = _t.monotonic()
        cutoff = now - self.window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.pop(0)
        used = sum(u for _, u in self._events)
        if used + units > self.limit:
            return False
        self._events.append((now, units))
        return True


# per-peer-connection quotas (reference requestCountPeerLimit=50/min,
# blockCountPeerLimit=500/min)
REQUEST_COUNT_PER_MINUTE = 50
BLOCK_COUNT_PER_MINUTE = 500


class RequestError(Exception):
    def __init__(self, result: int, message: str = ""):
        super().__init__(f"reqresp error {result}: {message}")
        self.result = result


class ReqRespNode:
    """Per-connection req/resp endpoint: issues requests, answers peers'.

    The server side answers from the chain: status from fork choice/head,
    blocks from the hot db + archive (handlers/beaconBlocksByRange.ts).
    """

    def __init__(self, preset: Preset, chain, wire: Wire, metadata=None, metrics=None):
        self.p = preset
        self.chain = chain
        self.metrics = metrics
        self.t = get_types(preset).phase0
        self.wire = wire
        self.metadata_controller = metadata  # network/metadata.ts source
        self._req_ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Queue] = {}
        # server-side quotas for THIS peer (rateTracker.ts)
        self.request_rate = RateTracker(REQUEST_COUNT_PER_MINUTE)
        self.block_rate = RateTracker(BLOCK_COUNT_PER_MINUTE)
        self.rate_limited_count = 0

    # -- client side -----------------------------------------------------------

    async def _request(self, method: int, ssz_bytes: bytes, timeout: float = 10.0) -> List[bytes]:
        import time as _time

        _t0 = _time.monotonic()
        try:
            return await self._request_inner(method, ssz_bytes, timeout)
        except (RequestError, asyncio.TimeoutError) as e:
            if self.metrics:
                reason = "timeout" if isinstance(e, asyncio.TimeoutError) else "error"
                self.metrics.reqresp_errors_total.labels(
                    method=str(method), reason=reason
                ).inc()
            raise
        finally:
            if self.metrics:
                self.metrics.reqresp_request_seconds.labels(method=str(method)).observe(
                    _time.monotonic() - _t0
                )

    async def _request_inner(self, method: int, ssz_bytes: bytes, timeout: float = 10.0) -> List[bytes]:
        req_id = next(self._req_ids)
        q: asyncio.Queue = asyncio.Queue()
        self._pending[req_id] = q
        # overall deadline, not per-chunk: a malicious peer must not keep a
        # request alive forever by trickling chunks (a per-chunk
        # wait_for would reset the timeout on every chunk)
        deadline = asyncio.get_event_loop().time() + timeout
        max_chunks = MAX_RESPONSE_CHUNKS.get(method, 1)
        total = 0
        try:
            from .wire import KIND_REQUEST

            await self.wire.send_frame(KIND_REQUEST, Wire.encode_request(method, req_id, ssz_bytes))
            chunks: List[bytes] = []
            while True:
                remaining = deadline - asyncio.get_event_loop().time()
                if remaining <= 0:
                    raise asyncio.TimeoutError()
                kind, result, body = await asyncio.wait_for(q.get(), remaining)
                if kind == KIND_RESPONSE_END:
                    return chunks
                if result != RESULT_SUCCESS:
                    raise RequestError(result, body.decode(errors="replace"))
                total += len(body)
                if len(chunks) >= max_chunks:
                    raise RequestError(
                        RESULT_INVALID_REQUEST, f"method {method} sent >{max_chunks} chunks"
                    )
                if total > MAX_RESPONSE_TOTAL_BYTES:
                    raise RequestError(RESULT_INVALID_REQUEST, "response exceeds byte budget")
                chunks.append(body)
        finally:
            self._pending.pop(req_id, None)

    async def status(self, local_status) -> object:
        chunks = await self._request(METHOD_STATUS, self.t.Status.serialize(local_status))
        if not chunks:
            raise RequestError(RESULT_SERVER_ERROR, "empty status response")
        return self.t.Status.deserialize(chunks[0])

    async def goodbye(self, reason: int = 0) -> None:
        try:
            await self._request(METHOD_GOODBYE, self.t.Goodbye.serialize(reason), timeout=2.0)
        except Exception:
            pass

    async def ping(self, seq: int = 0) -> int:
        chunks = await self._request(METHOD_PING, self.t.Ping.serialize(seq))
        return self.t.Ping.deserialize(chunks[0]) if chunks else 0

    async def metadata(self) -> object:
        chunks = await self._request(METHOD_METADATA, b"")
        if not chunks:
            raise RequestError(RESULT_SERVER_ERROR, "empty metadata response")
        return self.t.Metadata.deserialize(chunks[0])

    async def blocks_by_range(self, start_slot: int, count: int, step: int = 1) -> List[object]:
        req = self.t.BeaconBlocksByRangeRequest.serialize(
            _fields(start_slot=start_slot, count=count, step=step)
        )
        chunks = await self._request(METHOD_BLOCKS_BY_RANGE, req, timeout=30.0)
        return [self._decode_block(c) for c in chunks]

    async def blocks_by_root(self, roots: List[bytes]) -> List[object]:
        req = self.t.BeaconBlocksByRootRequest.serialize(_fields(roots=list(roots)))
        chunks = await self._request(METHOD_BLOCKS_BY_ROOT, req, timeout=30.0)
        return [self._decode_block(c) for c in chunks]

    def _decode_block(self, b: bytes):
        # fork-tagged on the wire (mirrors the db codec): 1 tag byte + SSZ
        from ..db.beacon import _FORK_ORDER

        all_t = get_types(self.p)
        t = getattr(all_t, _FORK_ORDER[b[0]])
        return t.SignedBeaconBlock.deserialize(b[1:])

    def _encode_block(self, signed_block) -> bytes:
        from ..db.beacon import _FORK_ORDER
        from ..state_transition.upgrade import block_fork_name

        fork = block_fork_name(signed_block.message).value
        all_t = get_types(self.p)
        t = getattr(all_t, fork)
        return bytes([_FORK_ORDER.index(fork)]) + t.SignedBeaconBlock.serialize(signed_block)

    # -- dispatch --------------------------------------------------------------

    def on_response_frame(self, kind: int, payload: bytes) -> None:
        if kind == KIND_RESPONSE_CHUNK:
            req_id, result, body = Wire.decode_response_chunk(payload)
            q = self._pending.get(req_id)
            if q is not None:
                q.put_nowait((kind, result, body))
        elif kind == KIND_RESPONSE_END:
            req_id = Wire.decode_response_end(payload)
            q = self._pending.get(req_id)
            if q is not None:
                q.put_nowait((kind, RESULT_SUCCESS, b""))

    async def on_request_frame(self, payload: bytes) -> None:
        try:
            method, req_id, body = Wire.decode_request(payload)
        except Exception:
            return  # malformed; drop
        try:
            chunks = await self._serve(method, body)
            for c in chunks:
                await self.wire.send_frame(
                    KIND_RESPONSE_CHUNK, Wire.encode_response_chunk(req_id, RESULT_SUCCESS, c)
                )
        except RequestError as e:
            await self.wire.send_frame(
                KIND_RESPONSE_CHUNK,
                Wire.encode_response_chunk(req_id, e.result, str(e).encode()),
            )
        except Exception as e:  # noqa: BLE001
            logger.warning("reqresp server error: %s", e)
            await self.wire.send_frame(
                KIND_RESPONSE_CHUNK,
                Wire.encode_response_chunk(req_id, RESULT_SERVER_ERROR, str(e).encode()),
            )
        await self.wire.send_frame(KIND_RESPONSE_END, Wire.encode_response_end(req_id))

    async def _serve(self, method: int, body: bytes) -> List[bytes]:
        if not self.request_rate.request_units(1):
            self.rate_limited_count += 1
            raise RequestError(RESULT_RATE_LIMITED, "request quota exceeded")
        if method == METHOD_STATUS:
            return [self.t.Status.serialize(self.local_status())]
        if method == METHOD_GOODBYE:
            return [self.t.Goodbye.serialize(0)]
        if method == METHOD_PING:
            seq = self.t.Ping.deserialize(body)
            return [self.t.Ping.serialize(seq)]
        if method == METHOD_METADATA:
            mc = self.metadata_controller
            return [
                self.t.Metadata.serialize(
                    _fields(
                        seq_number=mc.seq_number if mc else 0,
                        attnets=list(mc.attnets) if mc else [False] * 64,
                    )
                )
            ]
        if method == METHOD_BLOCKS_BY_RANGE:
            req = self.t.BeaconBlocksByRangeRequest.deserialize(body)
            if req.count > MAX_REQUEST_BLOCKS or req.step < 1:
                raise RequestError(RESULT_INVALID_REQUEST, "bad range request")
            # block quota charges objects served, not requests (rateTracker.ts)
            if not self.block_rate.request_units(max(1, int(req.count))):
                self.rate_limited_count += 1
                raise RequestError(RESULT_RATE_LIMITED, "block quota exceeded")
            return [
                self._encode_block(b)
                for b in self._blocks_in_range(req.start_slot, req.count, req.step)
            ]
        if method == METHOD_BLOCKS_BY_ROOT:
            req = self.t.BeaconBlocksByRootRequest.deserialize(body)
            if not self.block_rate.request_units(max(1, len(req.roots))):
                self.rate_limited_count += 1
                raise RequestError(RESULT_RATE_LIMITED, "block quota exceeded")
            out = []
            for root in req.roots[:MAX_REQUEST_BLOCKS]:
                blk = self.chain.get_block_by_root(bytes(root))
                if blk is not None:
                    out.append(self._encode_block(blk))
            return out
        raise RequestError(RESULT_INVALID_REQUEST, f"unknown method {method}")

    def local_status(self):
        chain = self.chain
        head_state = chain.head_state()
        from ..state_transition import compute_fork_digest

        digest = compute_fork_digest(
            self.p,
            bytes(head_state.fork.current_version),
            bytes(head_state.genesis_validators_root),
        )
        fc = chain.fork_choice.store
        return _fields(
            fork_digest=digest,
            finalized_root=fc.finalized_checkpoint.root,
            finalized_epoch=fc.finalized_checkpoint.epoch,
            head_root=chain.head_root,
            head_slot=head_state.slot,
        )

    def _blocks_in_range(self, start_slot: int, count: int, step: int) -> List[object]:
        """Canonical blocks in [start_slot, start_slot + count*step): walk
        the canonical chain via fork choice ancestors + archive."""
        chain = self.chain
        wanted = range(start_slot, start_slot + count * step, step)
        out = []
        # archived (finalized) portion, slot-ordered
        for blk in chain.db.archived_blocks_by_slot_range(start_slot, wanted[-1] + 1):
            if blk.message.slot in wanted:
                out.append(blk)
        have = {b.message.slot for b in out}
        # hot portion: canonical ancestors of the head
        root = chain.head_root
        hot = []
        while root is not None:
            blk = chain.db.block.get(root)
            if blk is None:
                break
            if blk.message.slot < start_slot:
                break
            if blk.message.slot in wanted and blk.message.slot not in have:
                hot.append(blk)
            root = bytes(blk.message.parent_root)
        out.extend(reversed(hot))
        out.sort(key=lambda b: b.message.slot)
        return out


def _fields(**kw):
    from ..ssz import Fields

    return Fields(**kw)
