"""Remote-signer client (web3signer-compatible HTTP API).

Reference: packages/validator/src/services/validatorStore.ts:80
(SignerType.Remote → requestSignature posting to an external signer) and
packages/validator/src/util/externalSignerClient.ts (POST
/api/v1/eth2/sign/{pubkey} with the signing root; GET
/api/v1/eth2/publicKeys).

The signing paths in ValidatorStore stay synchronous (they gate on
slashing protection before any bytes leave the process), so this client
is deliberately blocking http.client, not asyncio.
"""

from __future__ import annotations

import http.client
import json
import ssl
from typing import List
from urllib.parse import urlparse


class RemoteSignerError(Exception):
    pass


class RemoteSignerClient:
    def __init__(self, url: str, timeout: float = 5.0):
        self.url = url
        parsed = urlparse(url)
        self.host = parsed.hostname or "127.0.0.1"
        self.scheme = parsed.scheme or "http"
        self.port = parsed.port or (443 if self.scheme == "https" else 80)
        self.timeout = timeout

    def _connect(self):
        """https URLs negotiate TLS with certificate verification — signing
        requests must never leave the process in cleartext against a TLS
        signer."""
        if self.scheme == "https":
            return http.client.HTTPSConnection(
                self.host,
                self.port,
                timeout=self.timeout,
                context=ssl.create_default_context(),
            )
        return http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)

    def _request(self, method: str, path: str, body: dict | None = None):
        conn = self._connect()
        try:
            payload = json.dumps(body).encode() if body is not None else None
            conn.request(
                method, path, body=payload,
                headers={"content-type": "application/json"} if payload else {},
            )
            resp = conn.getresponse()
            data = resp.read()
            if resp.status >= 400:
                raise RemoteSignerError(f"remote signer {resp.status}: {data[:200]!r}")
            return json.loads(data) if data else None
        except (OSError, ValueError) as e:
            raise RemoteSignerError(f"remote signer unreachable: {e}") from e
        finally:
            conn.close()

    def public_keys(self) -> List[bytes]:
        """GET /api/v1/eth2/publicKeys -> the keys this signer holds."""
        keys = self._request("GET", "/api/v1/eth2/publicKeys") or []
        return [bytes.fromhex(k[2:] if k.startswith("0x") else k) for k in keys]

    def sign(self, pubkey: bytes, signing_root: bytes, sign_type: str = "BEACON") -> bytes:
        """POST /api/v1/eth2/sign/{pubkey}: the signer only ever sees the
        32-byte signing root — message construction and slashing
        protection stay on our side."""
        resp = self._request(
            "POST",
            f"/api/v1/eth2/sign/0x{bytes(pubkey).hex()}",
            {"type": sign_type, "signingRoot": "0x" + bytes(signing_root).hex()},
        )
        sig = resp["signature"] if isinstance(resp, dict) else resp
        return bytes.fromhex(sig[2:] if sig.startswith("0x") else sig)

    def up_check(self) -> bool:
        try:
            self._request("GET", "/upcheck")
            return True
        except RemoteSignerError:
            return False
