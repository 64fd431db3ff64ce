"""MEV-boost builder API: mock + HTTP clients and the blind/unblind helpers.

Reference: packages/beacon-node/src/execution/builder/http.ts
(registerValidator -> POST /eth/v1/builder/validators, getHeader ->
GET /eth/v1/builder/header/{slot}/{parent_hash}/{pubkey},
submitBlindedBlock -> POST /eth/v1/builder/blinded_blocks, checkStatus)
and builder/interface.ts IExecutionBuilder.

The builder holds the full execution payload hostage: the proposer only
ever sees the header, signs a *blinded* block over it, and receives the
payload back after the signature is irrevocable.  `payload_to_header` /
`blind_body` / `unblind_block` implement that round-trip against our SSZ
types; the mock fabricates payloads the same way ExecutionEngineMock
does so dev chains exercise the full flow in-process.
"""

from __future__ import annotations

import asyncio
import json
from typing import Dict, List, Optional

from ..params import DOMAIN_APPLICATION_BUILDER, Preset
from ..ssz import Fields
from ..state_transition import compute_domain, compute_signing_root
from ..types import get_types
from ..utils.logger import get_logger

logger = get_logger("execution-builder")


def builder_domain(preset: Preset, fork_version: bytes) -> bytes:
    """DOMAIN_APPLICATION_BUILDER over a ZERO genesis_validators_root
    (builder-specs: registrations are chain-agnostic, so the domain binds
    only the fork version — reference signatureUtils.ts getDomain for
    ValidatorRegistration)."""
    return compute_domain(preset, DOMAIN_APPLICATION_BUILDER, fork_version, b"\x00" * 32)


def payload_to_header(preset: Preset, payload: Fields) -> Fields:
    """ExecutionPayload -> ExecutionPayloadHeader (spec
    get_execution_payload_header): copy the fixed fields, merkleize the
    transactions list into transactions_root."""
    t = get_types(preset).bellatrix
    txs_type = dict(t.ExecutionPayload.fields)["transactions"]
    fixed = {
        name: payload[name]
        for name, _ in t.ExecutionPayloadHeader.fields
        if name != "transactions_root"
    }
    return Fields(
        **fixed, transactions_root=txs_type.hash_tree_root(payload.transactions)
    )


def blind_body(preset: Preset, body: Fields) -> Fields:
    """BeaconBlockBody -> BlindedBeaconBlockBody with the payload replaced
    by its header (factory/block/body.ts blindedOrFull split)."""
    blinded = Fields(**{k: body[k] for k in body.keys() if k != "execution_payload"})
    blinded.execution_payload_header = payload_to_header(preset, body.execution_payload)
    return blinded


def unblind_block(preset: Preset, signed_blinded: Fields, payload: Fields) -> Fields:
    """SignedBlindedBeaconBlock + revealed payload -> SignedBeaconBlock,
    refusing a payload whose header doesn't match what was signed
    (api/impl/beacon/blocks publishBlindedBlock reconstruction)."""
    t = get_types(preset).bellatrix
    blinded_body = signed_blinded.message.body
    want = t.ExecutionPayloadHeader.hash_tree_root(blinded_body.execution_payload_header)
    got = t.ExecutionPayloadHeader.hash_tree_root(payload_to_header(preset, payload))
    if bytes(want) != bytes(got):
        raise ValueError("revealed payload does not match the signed blinded header")
    body = Fields(
        **{k: blinded_body[k] for k in blinded_body.keys() if k != "execution_payload_header"}
    )
    body.execution_payload = payload
    block = Fields(
        slot=signed_blinded.message.slot,
        proposer_index=signed_blinded.message.proposer_index,
        parent_root=signed_blinded.message.parent_root,
        state_root=signed_blinded.message.state_root,
        body=body,
    )
    return Fields(message=block, signature=signed_blinded.signature)


class ExecutionBuilderMock:
    """In-process builder double (reference builder/http.ts behavior with
    mock.ts-style payload fabrication): builds payloads exactly like
    ExecutionEngineMock so the resulting full block passes the STF."""

    def __init__(self, preset: Preset, engine, secret_key=None, fork_version: bytes = b"\x00" * 4):
        from ..crypto.bls.api import SecretKey

        self.p = preset
        self.engine = engine  # payload fabrication source (ExecutionEngineMock)
        self.sk = secret_key or SecretKey(0x42B1)
        self.pubkey = self.sk.to_public_key().to_bytes()
        self.fork_version = fork_version
        self.registrations: Dict[bytes, Fields] = {}
        self.payloads: Dict[bytes, Fields] = {}  # block_hash -> full payload
        self.enabled = True

    def check_status(self) -> bool:
        return self.enabled

    def register_validator(self, signed_registrations: List[Fields]) -> None:
        """POST /eth/v1/builder/validators: verify each registration
        signature before accepting (http.ts registerValidator)."""
        from ..crypto.bls.api import PublicKey, Signature, verify

        t = get_types(self.p).bellatrix
        domain = builder_domain(self.p, self.fork_version)
        for sr in signed_registrations:
            root = compute_signing_root(
                self.p, t.ValidatorRegistrationV1, sr.message, domain
            )
            pk = PublicKey.from_bytes(bytes(sr.message.pubkey))
            if not verify(pk, root, Signature.from_bytes(bytes(sr.signature))):
                raise ValueError("invalid validator registration signature")
            self.registrations[bytes(sr.message.pubkey)] = sr.message

    def get_header(
        self, slot: int, parent_hash: bytes, pubkey: bytes, attrs: Optional[Fields] = None
    ) -> Fields:
        """GET /eth/v1/builder/header: fabricate a payload on parent_hash,
        keep it, and return a SignedBuilderBid over its header.  `attrs`
        (timestamp/prev_randao/fee_recipient) is how the in-process mock
        learns what a real builder observes from the chain."""
        if bytes(pubkey) not in self.registrations:
            raise ValueError("unknown validator: not registered with builder")
        reg = self.registrations[bytes(pubkey)]
        if attrs is None:
            attrs = Fields(
                timestamp=0, prev_randao=b"\x00" * 32,
                suggested_fee_recipient=bytes(reg.fee_recipient),
            )
        prev_head = self.engine.head_block_hash
        self.engine.head_block_hash = bytes(parent_hash)
        try:
            pid = self.engine.notify_forkchoice_update(
                bytes(parent_hash), bytes(parent_hash), self.engine.finalized_block_hash, attrs
            )
            payload = self.engine.get_payload(pid)
        finally:
            self.engine.head_block_hash = prev_head
        self.payloads[bytes(payload.block_hash)] = payload
        t = get_types(self.p).bellatrix
        bid = Fields(
            header=payload_to_header(self.p, payload),
            value=1_000_000_000,  # wei; the mock always bids 1 gwei
            pubkey=self.pubkey,
        )
        domain = builder_domain(self.p, self.fork_version)
        root = compute_signing_root(self.p, t.BuilderBid, bid, domain)
        return Fields(message=bid, signature=self.sk.sign(root).to_bytes())

    def submit_blinded_block(self, signed_blinded: Fields) -> Fields:
        """POST /eth/v1/builder/blinded_blocks: reveal the payload matching
        the signed header (http.ts submitBlindedBlock)."""
        block_hash = bytes(
            signed_blinded.message.body.execution_payload_header.block_hash
        )
        payload = self.payloads.get(block_hash)
        if payload is None:
            raise ValueError("builder holds no payload for this blinded block")
        return payload


class ExecutionBuilderHttp:
    """builder-specs REST client (http.ts:40): dependency-free asyncio
    HTTP/1.1, JSON bodies in the eth2 API convention (decimal-string
    uints, 0x-hex bytes)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0,
                 pubkey: Optional[bytes] = None):
        self.host = host
        self.port = port
        self.timeout = timeout
        # operator-pinned builder identity: when set, the chain refuses
        # bids signed by any other key (a self-consistent signature from
        # an attacker's fresh keypair authenticates nothing)
        self.pubkey = pubkey

    async def _http(self, method: str, path: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else b""
        headers = [
            f"{method} {path} HTTP/1.1",
            f"host: {self.host}",
            "content-type: application/json",
            f"content-length: {len(data)}",
            "connection: close",
        ]
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), self.timeout
        )
        try:
            writer.write(("\r\n".join(headers) + "\r\n\r\n").encode() + data)
            await writer.drain()
            status_line = await reader.readline()
            status = int(status_line.split()[1])
            hdrs = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode().partition(":")
                hdrs[k.strip().lower()] = v.strip()
            payload = await asyncio.wait_for(reader.read(), self.timeout)
            payload = payload[: int(hdrs.get("content-length", len(payload)))]
            if status >= 400:
                raise RuntimeError(f"builder http {status}: {payload[:200]!r}")
            return json.loads(payload) if payload else None
        finally:
            writer.close()

    async def check_status(self) -> bool:
        try:
            await self._http("GET", "/eth/v1/builder/status")
            return True
        except Exception:
            return False

    async def register_validator(self, signed_registrations: List[Fields]) -> None:
        from ..api.serde import to_json

        await self._http(
            "POST", "/eth/v1/builder/validators", [to_json(r) for r in signed_registrations]
        )

    async def get_header(self, slot: int, parent_hash: bytes, pubkey: bytes) -> Fields:
        from ..api.serde import from_json

        resp = await self._http(
            "GET",
            f"/eth/v1/builder/header/{int(slot)}/0x{bytes(parent_hash).hex()}"
            f"/0x{bytes(pubkey).hex()}",
        )
        return from_json(resp["data"])

    async def submit_blinded_block(self, signed_blinded: Fields) -> Fields:
        from ..api.serde import from_json, to_json

        resp = await self._http(
            "POST", "/eth/v1/builder/blinded_blocks", to_json(signed_blinded)
        )
        return from_json(resp["data"])
