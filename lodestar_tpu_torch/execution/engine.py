"""Engine API clients: HTTP JSON-RPC, mock, and disabled doubles.

Reference: packages/beacon-node/src/execution/engine/http.ts:64
(engine_newPayloadV1 / engine_forkchoiceUpdatedV1 / engine_getPayloadV1
over JSON-RPC with jwt auth), mock.ts:23, disabled.ts.

The HTTP client is a dependency-free asyncio JSON-RPC caller; the mock
implements the same surface in-process and fabricates payloads whose
block hashes chain correctly — which is exactly what the dev chain and
the merge-transition tests need.
"""

from __future__ import annotations

import asyncio
import enum
import hashlib
import json
import time
from typing import Dict, List, Optional

from ..ssz import Fields
from ..utils.logger import get_logger

logger = get_logger("execution-engine")


class ExecutePayloadStatus(str, enum.Enum):
    VALID = "VALID"
    INVALID = "INVALID"
    SYNCING = "SYNCING"
    ACCEPTED = "ACCEPTED"


def jwt_supplier_from_secret(secret: bytes):
    """Engine-API jwt auth (reference eth1/provider/jwt.ts encodeJwtToken):
    HS256 over {"iat": now}, re-minted per request so the EL's 60s iat
    window never expires a cached token."""
    import base64
    import hmac

    def _b64url(data: bytes) -> bytes:
        return base64.urlsafe_b64encode(data).rstrip(b"=")

    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())

    def supply() -> str:
        payload = _b64url(json.dumps({"iat": int(time.time())}).encode())
        signing_input = header + b"." + payload
        sig = _b64url(hmac.new(secret, signing_input, "sha256").digest())
        return (signing_input + b"." + sig).decode()

    return supply


class ExecutionEngineMock:
    """In-process engine double (mock.ts:23): remembers payloads it built
    or validated; everything chains off `genesis_block_hash`."""

    def __init__(self, preset, genesis_block_hash: bytes = b"\x00" * 32):
        self.p = preset
        self.head_block_hash = genesis_block_hash
        self.safe_block_hash = genesis_block_hash
        self.finalized_block_hash = genesis_block_hash
        self.known_blocks: Dict[bytes, object] = {}
        self.payload_id_seq = 0
        self.preparing: Dict[int, Fields] = {}

    def notify_new_payload(self, payload) -> ExecutePayloadStatus:
        self.known_blocks[bytes(payload.block_hash)] = payload
        return ExecutePayloadStatus.VALID

    def notify_forkchoice_update(
        self,
        head_block_hash: bytes,
        safe_block_hash: bytes,
        finalized_block_hash: bytes,
        payload_attributes: Optional[Fields] = None,
    ) -> Optional[int]:
        self.head_block_hash = head_block_hash
        self.safe_block_hash = safe_block_hash
        self.finalized_block_hash = finalized_block_hash
        if payload_attributes is None:
            return None
        self.payload_id_seq += 1
        self.preparing[self.payload_id_seq] = payload_attributes
        return self.payload_id_seq

    def get_payload(self, payload_id: int) -> Fields:
        attrs = self.preparing.pop(payload_id)
        parent = self.head_block_hash
        number = 0
        parent_payload = self.known_blocks.get(parent)
        if parent_payload is not None:
            number = parent_payload.block_number + 1
        body = Fields(
            parent_hash=parent,
            fee_recipient=bytes(attrs.suggested_fee_recipient),
            state_root=hashlib.sha256(b"state" + parent).digest(),
            receipts_root=hashlib.sha256(b"rcpt" + parent).digest(),
            logs_bloom=b"\x00" * self.p.BYTES_PER_LOGS_BLOOM,
            prev_randao=bytes(attrs.prev_randao),
            block_number=number,
            gas_limit=30_000_000,
            gas_used=0,
            timestamp=attrs.timestamp,
            extra_data=b"",
            base_fee_per_gas=7,
            block_hash=b"",
            transactions=[],
        )
        body.block_hash = hashlib.sha256(
            b"block" + parent + bytes(attrs.prev_randao) + str(attrs.timestamp).encode()
        ).digest()
        self.known_blocks[bytes(body.block_hash)] = body
        return body


class DisabledExecutionEngine:
    """Pre-merge stand-in (disabled.ts): any call is a logic error."""

    def notify_new_payload(self, payload):
        raise RuntimeError("execution engine disabled (pre-merge)")

    def notify_forkchoice_update(self, *a, **kw):
        raise RuntimeError("execution engine disabled (pre-merge)")

    def get_payload(self, payload_id):
        raise RuntimeError("execution engine disabled (pre-merge)")


class ExecutionEngineHttp:
    """JSON-RPC Engine API client (http.ts:64).

    Dependency-free HTTP/1.1 over asyncio; jwt auth is accepted as a
    pre-computed token supplier so the crypto stays out of this module.
    NOTE: no execution client ships in this image — integration-tested
    against an in-process stub server in tests/test_execution_eth1.py.
    """

    def __init__(self, host: str, port: int, jwt_supplier=None, timeout: float = 5.0):
        self.host = host
        self.port = port
        self.jwt_supplier = jwt_supplier
        self.timeout = timeout
        self._id = 0

    async def _rpc(self, method: str, params: list):
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        headers = [
            f"POST / HTTP/1.1",
            f"host: {self.host}",
            "content-type: application/json",
            f"content-length: {len(body)}",
            "connection: close",
        ]
        if self.jwt_supplier is not None:
            headers.append(f"authorization: Bearer {self.jwt_supplier()}")
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), self.timeout
        )
        try:
            writer.write(("\r\n".join(headers) + "\r\n\r\n").encode() + body)
            await writer.drain()
            status_line = await reader.readline()
            hdrs = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode().partition(":")
                hdrs[k.strip().lower()] = v.strip()
            payload = await reader.read()
            resp = json.loads(payload[: int(hdrs.get("content-length", len(payload)))])
            if "error" in resp:
                raise RuntimeError(f"engine rpc error: {resp['error']}")
            return resp["result"]
        finally:
            writer.close()

    @staticmethod
    def _hex(b: bytes) -> str:
        return "0x" + bytes(b).hex()

    @staticmethod
    def _qty(n: int) -> str:
        return hex(int(n))

    async def notify_new_payload(self, payload) -> ExecutePayloadStatus:
        result = await self._rpc(
            "engine_newPayloadV1",
            [
                {
                    "parentHash": self._hex(payload.parent_hash),
                    "feeRecipient": self._hex(payload.fee_recipient),
                    "stateRoot": self._hex(payload.state_root),
                    "receiptsRoot": self._hex(payload.receipts_root),
                    "logsBloom": self._hex(payload.logs_bloom),
                    "prevRandao": self._hex(payload.prev_randao),
                    "blockNumber": self._qty(payload.block_number),
                    "gasLimit": self._qty(payload.gas_limit),
                    "gasUsed": self._qty(payload.gas_used),
                    "timestamp": self._qty(payload.timestamp),
                    "extraData": self._hex(payload.extra_data),
                    "baseFeePerGas": self._qty(payload.base_fee_per_gas),
                    "blockHash": self._hex(payload.block_hash),
                    "transactions": [self._hex(t) for t in payload.transactions],
                }
            ],
        )
        return ExecutePayloadStatus(result["status"])

    async def notify_forkchoice_update(
        self, head_block_hash, safe_block_hash, finalized_block_hash,
        payload_attributes=None,
    ):
        params = [
            {
                "headBlockHash": self._hex(head_block_hash),
                "safeBlockHash": self._hex(safe_block_hash),
                "finalizedBlockHash": self._hex(finalized_block_hash),
            }
        ]
        if payload_attributes is not None:
            params.append(
                {
                    "timestamp": self._qty(payload_attributes.timestamp),
                    "prevRandao": self._hex(payload_attributes.prev_randao),
                    "suggestedFeeRecipient": self._hex(
                        payload_attributes.suggested_fee_recipient
                    ),
                }
            )
        result = await self._rpc("engine_forkchoiceUpdatedV1", params)
        pid = result.get("payloadId")
        return int(pid, 16) if isinstance(pid, str) else pid
