"""Minimal asyncio HTTP client for the beacon REST API.

Reference: packages/api/src/beacon/client (the typed fetch wrappers the
validator package builds on).
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Optional

from ..utils.logger import get_logger

logger = get_logger("api-client")


class ApiClient:
    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port

    async def _request(self, method: str, path: str, body: Any = None) -> Any:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            data = json.dumps(body).encode() if body is not None else b""
            req = (
                f"{method} {path} HTTP/1.1\r\n"
                f"host: {self.host}\r\n"
                "connection: close\r\n"
                "content-type: application/json\r\n"
                f"content-length: {len(data)}\r\n\r\n"
            ).encode() + data
            writer.write(req)
            await writer.drain()
            status_line = await reader.readline()
            status = int(status_line.split()[1])
            headers = {}
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            payload = await reader.read()
            if "content-length" in headers:
                payload = payload[: int(headers["content-length"])] if payload else payload
            out = json.loads(payload) if payload and headers.get("content-type", "").startswith("application/json") else payload
            if status >= 400:
                raise ApiClientError(status, out)
            return out
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def get(self, path: str) -> Any:
        return await self._request("GET", path)

    async def post(self, path: str, body: Any) -> Any:
        return await self._request("POST", path, body)

    async def events(self, topics: str = "head,block,finalized_checkpoint"):
        """Async generator over the /eth/v1/events SSE stream: yields
        (event_name, data_dict).  The connection stays open until the
        caller stops iterating (routes/events.ts client side)."""
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            req = (
                f"GET /eth/v1/events?topics={topics} HTTP/1.1\r\n"
                f"host: {self.host}\r\n\r\n"
            ).encode()
            writer.write(req)
            await writer.drain()
            status_line = await reader.readline()
            try:
                status = int(status_line.split()[1])
            except (IndexError, ValueError):
                raise ApiClientError(0, f"bad SSE status line: {status_line!r}")
            if status != 200:
                raise ApiClientError(status, "events stream rejected")
            while True:
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
            event_name = None
            while True:
                line = await reader.readline()
                if not line:
                    return
                line = line.strip()
                if line.startswith(b"event:"):
                    event_name = line[6:].strip().decode()
                elif line.startswith(b"data:") and event_name:
                    yield event_name, json.loads(line[5:].strip())
                    event_name = None
        finally:
            try:
                writer.close()
            except Exception:
                pass


class ApiClientError(Exception):
    def __init__(self, status: int, body: Any):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body
