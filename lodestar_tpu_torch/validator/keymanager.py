"""Keymanager API server: the standard key-management namespace served by
the validator-client process.

Reference: packages/api/src/keymanager/routes.ts (the
eth/v1/keystores list/import/delete surface of the keymanager-APIs spec)
+ the reference VC's keymanager server.  Import/delete integrate the
EIP-2335 codec (validator/keystore.py) and the EIP-3076 slashing
interchange so a migrating operator carries protection history with the
keys.
"""

from __future__ import annotations

import asyncio
import json
import re
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import urlparse

from ..crypto.bls.api import SecretKey
from ..utils.logger import get_logger
from .keystore import KeystoreError, decrypt_keystore
from .slashing_protection import SlashingProtection

logger = get_logger("keymanager")


class KeymanagerApi:
    """Route logic, server-agnostic (testable without sockets)."""

    def __init__(self, store, protection: SlashingProtection, index_resolver=None,
                 client=None):
        self.store = store  # ValidatorStore
        self.protection = protection
        # pubkey -> validator index; None = unknown (not yet activated)
        self.index_resolver = index_resolver or (lambda pk: None)
        # ValidatorClient, for fee-recipient / gas-limit defaults
        self.client = client
        self._fee_recipients: Dict[bytes, bytes] = {}
        self._gas_limits: Dict[bytes, int] = {}

    def _placeholder_index(self) -> int:
        """Synthetic negative index for a not-yet-activated key: strictly
        below every existing index so deletes can never make two imports
        collide (len-based schemes reuse freed slots)."""
        indices = list(self.store.pubkeys) + list(self.store.keys)
        return min([0] + indices) - 1

    def list_keystores(self) -> dict:
        data = [
            {
                "validating_pubkey": "0x" + pk.hex(),
                "derivation_path": "",
                "readonly": False,
            }
            for pk in sorted(self.store.pubkeys.values())
        ]
        return {"data": data}

    def import_keystores(self, body: dict) -> dict:
        keystores = body.get("keystores", [])
        passwords = body.get("passwords", [])
        interchange = body.get("slashing_protection")
        if interchange:
            self.protection.import_interchange(
                json.loads(interchange) if isinstance(interchange, str) else interchange
            )
        # one status per submitted keystore, always: unmatched trailing
        # entries get explicit error statuses instead of being silently
        # dropped by zip (keymanager API contract)
        if len(passwords) < len(keystores):
            passwords = list(passwords) + [None] * (len(keystores) - len(passwords))
        statuses = []
        for raw, password in zip(keystores, passwords):
            if password is None:
                statuses.append({"status": "error", "message": "missing password"})
                continue
            try:
                ks = json.loads(raw) if isinstance(raw, str) else raw
                secret = decrypt_keystore(ks, password)
                sk = SecretKey.from_bytes(secret)
                pk = sk.to_public_key().to_bytes()
                if pk in self.store.pubkeys.values():
                    statuses.append({"status": "duplicate", "message": ""})
                    continue
                idx = self.index_resolver(pk)
                if idx is None:
                    # keep the key under a synthetic negative index until
                    # it activates; signing paths resolve by index so an
                    # unknown validator simply has no duties yet
                    idx = self._placeholder_index()
                self.store.keys[idx] = sk
                self.store.pubkeys[idx] = pk
                statuses.append({"status": "imported", "message": ""})
            except (KeystoreError, ValueError, KeyError) as e:
                statuses.append({"status": "error", "message": str(e)})
        return {"data": statuses}

    # -- remotekeys namespace (keymanager routes.ts remote-key CRUD) -------

    def list_remote_keys(self) -> dict:
        store = self.store
        local = set(store.keys)
        data = [
            {
                "pubkey": "0x" + pk.hex(),
                "url": getattr(store.remote_signer, "url", ""),
                "readonly": False,
            }
            for i, pk in sorted(store.pubkeys.items())
            if i not in local
        ]
        return {"data": data}

    def import_remote_keys(self, body: dict) -> dict:
        """POST /eth/v1/remotekeys: register pubkeys whose signatures come
        from the remote signer.  Indices resolve like keystore imports."""
        statuses = []
        for entry in body.get("remote_keys", []):
            try:
                pk = bytes.fromhex(entry["pubkey"][2:])
                if pk in self.store.pubkeys.values():
                    statuses.append({"status": "duplicate", "message": ""})
                    continue
                if self.store.remote_signer is None:
                    statuses.append(
                        {"status": "error", "message": "no remote signer configured"}
                    )
                    continue
                idx = self.index_resolver(pk)
                if idx is None:
                    idx = self._placeholder_index()
                self.store.pubkeys[idx] = pk
                statuses.append({"status": "imported", "message": ""})
            except (ValueError, KeyError) as e:
                statuses.append({"status": "error", "message": str(e)})
        return {"data": statuses}

    def delete_remote_keys(self, body: dict) -> dict:
        statuses = []
        for pk in body.get("pubkeys", []):
            raw = bytes.fromhex(pk[2:])
            idx = next(
                (
                    i
                    for i, p in self.store.pubkeys.items()
                    if p == raw and i not in self.store.keys
                ),
                None,
            )
            if idx is None:
                statuses.append({"status": "not_found", "message": ""})
                continue
            del self.store.pubkeys[idx]
            statuses.append({"status": "deleted", "message": ""})
        return {"data": statuses}

    # -- per-validator feerecipient / gas_limit (keymanager routes.ts) -----
    # Single source of truth: the ValidatorClient's override maps (which
    # the preparation/registration services read).  The private maps only
    # exist for the client-less (standalone API) configuration.

    def _fr_map(self):
        return (
            self.client.fee_recipient_overrides
            if self.client is not None
            else self._fee_recipients
        )

    def _gl_map(self):
        return (
            self.client.gas_limit_overrides
            if self.client is not None
            else self._gas_limits
        )

    def get_fee_recipient(self, pubkey_hex: str) -> dict:
        fr = self._fr_map().get(bytes.fromhex(pubkey_hex[2:]))
        if fr is None and self.client is not None:
            fr = self.client.fee_recipient
        return {
            "data": {
                "pubkey": pubkey_hex,
                "ethaddress": "0x" + (fr or b"\x00" * 20).hex(),
            }
        }

    def set_fee_recipient(self, pubkey_hex: str, body: dict) -> dict:
        self._fr_map()[bytes.fromhex(pubkey_hex[2:])] = bytes.fromhex(
            body["ethaddress"][2:]
        )
        return {}

    def delete_fee_recipient(self, pubkey_hex: str) -> dict:
        self._fr_map().pop(bytes.fromhex(pubkey_hex[2:]), None)
        return {}

    def get_gas_limit(self, pubkey_hex: str) -> dict:
        gl = self._gl_map().get(bytes.fromhex(pubkey_hex[2:]))
        if gl is None and self.client is not None:
            gl = self.client.gas_limit
        return {"data": {"pubkey": pubkey_hex, "gas_limit": str(gl or 30_000_000)}}

    def set_gas_limit(self, pubkey_hex: str, body: dict) -> dict:
        self._gl_map()[bytes.fromhex(pubkey_hex[2:])] = int(body["gas_limit"])
        return {}

    def delete_gas_limit(self, pubkey_hex: str) -> dict:
        self._gl_map().pop(bytes.fromhex(pubkey_hex[2:]), None)
        return {}

    def delete_keystores(self, body: dict) -> dict:
        statuses = []
        for pk in body.get("pubkeys", []):
            raw = bytes.fromhex(pk[2:])
            idx = next((i for i, p in self.store.pubkeys.items() if p == raw), None)
            if idx is None:
                statuses.append({"status": "not_found", "message": ""})
                continue
            if self.store.keys.pop(idx, None) is None:
                # remote-only pubkey: not a local keystore (keymanager spec
                # says report it, don't 500 the whole request)
                statuses.append({"status": "not_found", "message": "remote key"})
                continue
            del self.store.pubkeys[idx]
            statuses.append({"status": "deleted", "message": ""})
        # export the whole protection history for the deleted keys' owner
        # (keymanager spec: the response carries the interchange)
        return {
            "data": statuses,
            "slashing_protection": json.dumps(self.protection.export_interchange()),
        }


class KeymanagerServer:
    """Minimal asyncio HTTP host for the keymanager routes (the VC-side
    analog of BeaconRestApiServer; bearer-token auth like the reference's
    keymanager server).

    Auth is ON by default: like the reference (which always writes an
    api-token.txt and enforces it), a missing token is GENERATED, not
    skipped — key import/delete and fee-recipient routes must never be
    open by accident.  Pass ``require_auth=False`` to explicitly disable
    (tests/local tooling only).  ``token_path`` persists the generated
    token for operator tooling."""

    def __init__(
        self,
        api: KeymanagerApi,
        token: Optional[str] = None,
        host: str = "127.0.0.1",
        require_auth: bool = True,
        token_path: Optional[str] = None,
    ):
        self.api = api
        if token is None and require_auth:
            import secrets

            token = "api-token-0x" + secrets.token_hex(32)
            if token_path:
                import os

                with open(token_path, "w") as fh:
                    fh.write(token)
                os.chmod(token_path, 0o600)
        self.token = token
        self.host = host
        self.port: Optional[int] = None
        self._server: Optional[asyncio.AbstractServer] = None

    async def listen(self, port: int = 0) -> int:
        self._server = await asyncio.start_server(self._conn, self.host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("keymanager API on http://%s:%d", self.host, self.port)
        return self.port

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _conn(self, reader, writer):
        try:
            line = await reader.readline()
            if not line:
                return
            method, target, _ = line.decode().split()
            headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            if "content-length" in headers:
                body = await reader.readexactly(int(headers["content-length"]))
            status, payload = self._dispatch(method, urlparse(target).path, headers, body)
            data = json.dumps(payload).encode()
            writer.write(
                b"HTTP/1.1 %d %s\r\ncontent-type: application/json\r\n"
                % (status, b"OK" if status < 400 else b"Error")
                + b"content-length: %d\r\n\r\n" % len(data)
                + data
            )
            await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def _dispatch(self, method: str, path: str, headers: dict, body: bytes):
        if self.token:
            import hmac

            auth = headers.get("authorization", "")
            if not hmac.compare_digest(auth, f"Bearer {self.token}"):
                return 401, {"code": 401, "message": "missing or bad bearer token"}
        try:
            parsed = json.loads(body) if body else {}
        except ValueError:
            return 400, {"code": 400, "message": "bad json"}
        try:
            if path == "/eth/v1/keystores":
                if method == "GET":
                    return 200, self.api.list_keystores()
                if method == "POST":
                    return 200, self.api.import_keystores(parsed)
                if method == "DELETE":
                    return 200, self.api.delete_keystores(parsed)
            if path == "/eth/v1/remotekeys":
                if method == "GET":
                    return 200, self.api.list_remote_keys()
                if method == "POST":
                    return 200, self.api.import_remote_keys(parsed)
                if method == "DELETE":
                    return 200, self.api.delete_remote_keys(parsed)
            m = re.fullmatch(r"/eth/v1/validator/(0x[0-9a-fA-F]{96})/feerecipient", path)
            if m:
                if method == "GET":
                    return 200, self.api.get_fee_recipient(m.group(1))
                if method == "POST":
                    return 202, self.api.set_fee_recipient(m.group(1), parsed)
                if method == "DELETE":
                    return 204, self.api.delete_fee_recipient(m.group(1))
            m = re.fullmatch(r"/eth/v1/validator/(0x[0-9a-fA-F]{96})/gas_limit", path)
            if m:
                if method == "GET":
                    return 200, self.api.get_gas_limit(m.group(1))
                if method == "POST":
                    return 202, self.api.set_gas_limit(m.group(1), parsed)
                if method == "DELETE":
                    return 204, self.api.delete_gas_limit(m.group(1))
            return 404, {"code": 404, "message": f"no route {method} {path}"}
        except Exception as e:  # noqa: BLE001
            return 500, {"code": 500, "message": str(e)}
