"""Asyncio HTTP/1.1 REST server with the beacon/node/validator routes a
validator client needs.

Reference: beacon-node/src/api/rest/index.ts:36 (server),
api/impl/validator/index.ts:169-222 (duties + production),
api/impl/beacon/ (genesis/headers/blocks/pool).  Routes implemented:

  GET  /eth/v1/node/health
  GET  /eth/v1/node/version
  GET  /eth/v1/node/syncing
  GET  /eth/v1/beacon/genesis
  GET  /eth/v1/beacon/states/{state_id}/finality_checkpoints
  GET  /eth/v1/beacon/states/{state_id}/validators/{validator_id}
  GET  /eth/v1/beacon/headers/{block_id}
  GET  /eth/v1/validator/duties/proposer/{epoch}
  POST /eth/v1/validator/duties/attester/{epoch}
  GET  /eth/v2/validator/blocks/{slot}?randao_reveal=0x..
  POST /eth/v1/beacon/blocks
  GET  /eth/v1/validator/attestation_data?slot=&committee_index=
  POST /eth/v1/beacon/pool/attestations
  POST /eth/v1/beacon/pool/voluntary_exits
  GET  /eth/v1/validator/aggregate_attestation?slot=&attestation_data_root=
  POST /eth/v1/validator/aggregate_and_proofs
  POST /eth/v1/validator/liveness/{epoch}
  POST /eth/v1/validator/duties/sync/{epoch}
  POST /eth/v1/beacon/pool/sync_committees
  GET  /eth/v1/validator/sync_committee_contribution?slot=&subcommittee_index=&beacon_block_root=
  POST /eth/v1/validator/contribution_and_proofs
  GET  /eth/v1/beacon/light_client/bootstrap/{block_root}
  GET  /eth/v1/beacon/light_client/updates?start_period=&count=
  GET  /metrics  (prometheus text exposition when a registry is wired)
  GET  /eth/v1/lodestar/traces      (span-tracer dump; ?format=chrome)
  GET  /eth/v1/lodestar/bls_stages  (BLS pipeline counters)
  GET  /eth/v1/lodestar/health      (aggregated operational health)
  GET  /eth/v1/lodestar/forensics   (on-demand diagnostic bundle)
  GET  /eth/v1/lodestar/observatory (compile ledger + device telemetry)
"""

from __future__ import annotations

import asyncio
import json
import re
from typing import Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..params import Preset
from ..ssz import Fields
from ..state_transition import (
    clone_state,
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    process_slots,
)
from ..types import get_types
from ..utils.logger import get_logger
from .serde import from_json, to_json

logger = get_logger("rest-api")

VERSION = "lodestar-tpu/0.3.0"


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class RestApiServer:
    def __init__(self, preset: Preset, chain, network=None, metrics_registry=None,
                 metrics=None, host: str = "127.0.0.1"):
        self.p = preset
        self.chain = chain
        self.network = network
        self.metrics_registry = metrics_registry
        self.metrics = metrics
        self.host = host
        self.port: Optional[int] = None
        self.t = get_types(preset).phase0
        self._server: Optional[asyncio.AbstractServer] = None
        # the connections being served, ended by close()
        self._conns: set = set()
        self._routes: List[Tuple[str, re.Pattern, Callable]] = []
        self._register_routes()

    # -- lifecycle -------------------------------------------------------------

    async def listen(self, port: int = 0) -> int:
        self._server = await asyncio.start_server(self._handle_conn, self.host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("REST API on http://%s:%d", self.host, self.port)
        return self.port

    async def close(self) -> None:
        """Stop listening and end the open connections: an events stream
        whose client went away would otherwise hold ``wait_closed`` until
        its next keep-alive write fails."""
        if self._server is not None:
            self._server.close()
            for task in list(self._conns):
                task.cancel()
            await self._server.wait_closed()

    # -- http plumbing ---------------------------------------------------------

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    method, target, _version = line.decode().split()
                except ValueError:
                    break
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
                import time as _time

                _t0 = _time.monotonic()
                status, payload, ctype = await self._dispatch(method, target, body)
                if self.metrics:
                    self.metrics.api_requests_total.labels(status=str(status)).inc()
                    self.metrics.api_response_seconds.observe(_time.monotonic() - _t0)
                if ctype == "text/event-stream":
                    # SSE (routes/events.ts): stream chain events until the
                    # client goes away; the payload is an async generator
                    writer.write(
                        b"HTTP/1.1 200 OK\r\n"
                        b"content-type: text/event-stream\r\n"
                        b"cache-control: no-cache\r\n"
                        b"connection: close\r\n\r\n"
                    )
                    await writer.drain()
                    try:
                        async for chunk in payload:
                            writer.write(chunk)
                            await writer.drain()
                    except (ConnectionError, asyncio.CancelledError):
                        pass
                    finally:
                        # run the generator's finally NOW (emitter
                        # unsubscribe) instead of at GC time — stale
                        # subscriptions would outlive the client
                        await payload.aclose()
                    break
                data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
                writer.write(
                    b"HTTP/1.1 %d %s\r\n" % (status, b"OK" if status < 400 else b"Error")
                    + b"content-type: %s\r\n" % ctype.encode()
                    + b"content-length: %d\r\n\r\n" % len(data)
                    + data
                )
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    break
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._conns.discard(task)
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, method: str, target: str, body: bytes):
        parsed = urlparse(target)
        path = parsed.path
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        for m, pat, fn in self._routes:
            if m != method:
                continue
            match = pat.fullmatch(path)
            if match:
                try:
                    payload = fn(match.groupdict(), query, json.loads(body) if body else None)
                    if asyncio.iscoroutine(payload):
                        payload = await payload
                    if isinstance(payload, tuple):
                        if len(payload) == 3:  # (status, payload, content-type)
                            return payload
                        return 200, payload[0], payload[1]  # (bytes, content-type)
                    return 200, payload, "application/json"
                except ApiError as e:
                    return e.status, {"code": e.status, "message": e.message}, "application/json"
                except Exception as e:  # noqa: BLE001
                    logger.warning("api error on %s: %s", path, e)
                    return 500, {"code": 500, "message": str(e)}, "application/json"
        return 404, {"code": 404, "message": f"route not found: {method} {path}"}, "application/json"

    def _route(self, method: str, pattern: str, fn: Callable) -> None:
        # {name} -> named group
        regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
        self._routes.append((method, re.compile(regex), fn))

    # -- route implementations -------------------------------------------------

    def _register_routes(self) -> None:
        r = self._route
        r("GET", "/eth/v1/node/health", self._health)
        r("GET", "/eth/v1/node/version", lambda pp, q, b: {"data": {"version": VERSION}})
        r("GET", "/eth/v1/node/syncing", self._syncing)
        # node/peers + identity (routes/node.ts getPeers/getPeerCount)
        r("GET", "/eth/v1/node/peers", self._peers)
        r("GET", "/eth/v1/node/peers/{peer_id}", self._peer)
        r("GET", "/eth/v1/node/peer_count", self._peer_count)
        r("GET", "/eth/v1/node/identity", self._identity)
        # config namespace (routes/config.ts getSpec/getDepositContract/
        # getForkSchedule)
        r("GET", "/eth/v1/config/spec", self._config_spec)
        r("GET", "/eth/v1/config/fork_schedule", self._fork_schedule)
        r("GET", "/eth/v1/config/deposit_contract", self._deposit_contract)
        r("GET", "/eth/v1/beacon/genesis", self._genesis)
        r("GET", "/eth/v1/beacon/states/{state_id}/finality_checkpoints", self._finality)
        r("GET", "/eth/v1/beacon/states/{state_id}/validators/{validator_id}", self._validator)
        r("GET", "/eth/v1/beacon/headers/{block_id}", self._header)
        r("GET", "/eth/v1/validator/duties/proposer/{epoch}", self._proposer_duties)
        r("POST", "/eth/v1/validator/duties/attester/{epoch}", self._attester_duties)
        r("GET", "/eth/v2/validator/blocks/{slot}", self._produce_block)
        r("POST", "/eth/v1/beacon/blocks", self._publish_block)
        # builder flow (routes/validator.ts produceBlindedBlock,
        # registerValidator, prepareBeaconProposer; routes/beacon/block.ts
        # publishBlindedBlock)
        r("GET", "/eth/v1/validator/blinded_blocks/{slot}", self._produce_blinded_block)
        r("POST", "/eth/v1/beacon/blinded_blocks", self._publish_blinded_block)
        r("POST", "/eth/v1/validator/prepare_beacon_proposer", self._prepare_proposer)
        r("POST", "/eth/v1/validator/register_validator", self._register_validator)
        r("GET", "/eth/v1/validator/attestation_data", self._attestation_data)
        r("POST", "/eth/v1/beacon/pool/attestations", self._submit_attestations)
        r("POST", "/eth/v1/beacon/pool/voluntary_exits", self._submit_exit)
        r("POST", "/eth/v1/beacon/pool/proposer_slashings", self._submit_proposer_slashing)
        r("POST", "/eth/v1/beacon/pool/attester_slashings", self._submit_attester_slashing)
        r("GET", "/eth/v1/validator/aggregate_attestation", self._aggregate_attestation)
        r("POST", "/eth/v1/validator/aggregate_and_proofs", self._submit_aggregates)
        r("POST", "/eth/v1/validator/liveness/{epoch}", self._liveness)
        r("POST", "/eth/v1/validator/duties/sync/{epoch}", self._sync_duties)
        r("POST", "/eth/v1/beacon/pool/sync_committees", self._submit_sync_messages)
        r("GET", "/eth/v1/validator/sync_committee_contribution", self._sync_contribution)
        r("POST", "/eth/v1/validator/contribution_and_proofs", self._submit_contributions)
        r("GET", "/eth/v1/beacon/light_client/bootstrap/{block_root}", self._lc_bootstrap)
        r("GET", "/eth/v1/beacon/light_client/updates", self._lc_updates)
        r("GET", "/eth/v1/beacon/light_client/finality_update", self._lc_finality_update)
        r("GET", "/eth/v1/beacon/light_client/optimistic_update", self._lc_optimistic_update)
        # debug namespace (routes/debug.ts): SSZ state download — the
        # checkpoint-sync server side (initBeaconState.ts fetches this)
        r("GET", "/eth/v2/debug/beacon/states/{state_id}", self._debug_state)
        r("GET", "/eth/v2/beacon/blocks/{block_id}", self._block_ssz)
        # events SSE (routes/events.ts:20): head/block/finalized stream
        r("GET", "/eth/v1/events", self._events)
        # subnet subscriptions (routes/validator.ts prepareBeaconCommitteeSubnet)
        r("POST", "/eth/v1/validator/beacon_committee_subscriptions", self._committee_subs)
        r("POST", "/eth/v1/validator/sync_committee_subscriptions", self._sync_subs)
        r("GET", "/metrics", self._metrics)
        # lodestar-namespace debug endpoints (routes/lodestar.ts analog):
        # the hot-path span timeline and the BLS stage split
        r("GET", "/eth/v1/lodestar/traces", self._traces)
        r("GET", "/eth/v1/lodestar/bls_stages", self._bls_stages)
        # failure forensics: aggregated node health + on-demand bundle dump
        r("GET", "/eth/v1/lodestar/health", self._lodestar_health)
        r("GET", "/eth/v1/lodestar/forensics", self._forensics)
        r("GET", "/eth/v1/lodestar/observatory", self._observatory)
        # mesh observatory: on-demand profile windows (docs/observability.md
        # §Mesh observatory) — arm a capture of N pool flushes, optionally
        # wait, and fetch the merged host+device Chrome trace
        r("POST", "/eth/v1/lodestar/profile", self._profile)
        r("GET", "/eth/v1/lodestar/profile", self._profile_status)

    # -- node/peers + config namespaces ----------------------------------------

    def _peer_json(self, p) -> dict:
        # remote_key is "host:port" for dialed peers, a bare host for
        # inbound, or the synthetic peer id when peername was unavailable;
        # render whatever we have as a spec-shaped multiaddr
        host, _, port = str(p.remote_key).partition(":")
        addr = f"/ip4/{host}/tcp/{port or 0}" if host and "-" not in host else ""
        return {
            "peer_id": p.peer_id,
            "enr": "",
            "last_seen_p2p_address": addr,
            "state": "connected",
            "direction": "outbound",
        }

    def _peers(self, pp, q, b):
        peers = self.network.peer_manager.connected() if self.network else []
        data = [self._peer_json(p) for p in peers]
        # spec query filters (routes/node.ts getPeers): we only track
        # currently-connected peers, so any other state filter is empty
        states = q.get("state", "").split(",") if q.get("state") else None
        directions = q.get("direction", "").split(",") if q.get("direction") else None
        if states is not None:
            data = [d for d in data if d["state"] in states]
        if directions is not None:
            data = [d for d in data if d["direction"] in directions]
        return {"data": data, "meta": {"count": len(data)}}

    def _peer(self, pp, q, b):
        if self.network is not None:
            p = self.network.peer_manager.get(pp["peer_id"])
            if p is not None:
                return {"data": self._peer_json(p)}
        raise ApiError(404, "peer not found")

    def _peer_count(self, pp, q, b):
        n = len(self.network.peer_manager.connected()) if self.network else 0
        return {
            "data": {
                "disconnected": "0", "connecting": "0",
                "connected": str(n), "disconnecting": "0",
            }
        }

    def _identity(self, pp, q, b):
        net = self.network
        addr = (
            f"/ip4/{getattr(net, 'host', '127.0.0.1')}/tcp/{net.port}"
            if net is not None and getattr(net, "port", None)
            else ""
        )
        return {
            "data": {
                "peer_id": getattr(net, "local_peer_id", "") if net else "",
                "enr": "",
                "p2p_addresses": [addr] if addr else [],
                "discovery_addresses": [],
                "metadata": {"seq_number": "0", "attnets": "0x" + "00" * 8},
            }
        }

    @staticmethod
    def _spec_value(v):
        if isinstance(v, bytes):
            return "0x" + v.hex()
        if isinstance(v, bool):
            return "1" if v else "0"
        if isinstance(v, int):
            return str(v)
        return str(v)

    def _config_spec(self, pp, q, b):
        """Flattened preset + chain config, every value a string
        (routes/config.ts getSpec — clients feed this to their own
        domain/config machinery)."""
        import dataclasses as _dc

        out = {}
        for src in (self.p, self.chain.cfg):
            for f in _dc.fields(src):
                out[f.name] = self._spec_value(getattr(src, f.name))
        return {"data": out}

    def _fork_schedule(self, pp, q, b):
        forks = self.chain.fork_config.forks_ascending
        return {
            "data": [
                {
                    "previous_version": "0x" + f.prev_version.hex(),
                    "current_version": "0x" + f.version.hex(),
                    "epoch": str(f.epoch),
                }
                for f in forks
            ]
        }

    def _deposit_contract(self, pp, q, b):
        cfg = self.chain.cfg
        return {
            "data": {
                "chain_id": str(cfg.DEPOSIT_CHAIN_ID),
                "address": "0x" + cfg.DEPOSIT_CONTRACT_ADDRESS.hex(),
            }
        }

    def _state_for(self, state_id: str):
        chain = self.chain
        if state_id in ("head", "justified", "finalized"):
            if state_id == "head":
                return chain.head_state()
            cp = (
                chain.fork_choice.store.justified_checkpoint
                if state_id == "justified"
                else chain.fork_choice.store.finalized_checkpoint
            )
            st = chain.get_state_by_block_root(cp.root)
            if st is None:
                raise ApiError(404, f"state {state_id} not available")
            return st
        if state_id.startswith("0x"):
            st = chain.get_state_by_block_root(bytes.fromhex(state_id[2:]))
            if st is None:
                raise ApiError(404, "state not found")
            return st
        raise ApiError(400, f"unsupported state id {state_id}")

    def _committee_subs(self, pp, q, b):
        """AttnetsService feed (subnets/attnetsService.ts committee subs).
        subnet = (committees_since_epoch_start + committee_index) %
        ATTESTATION_SUBNET_COUNT (spec compute_subnet_for_attestation)."""
        if self.network is None:
            return {}
        from ..params.presets import ATTESTATION_SUBNET_COUNT

        for sub in b or []:
            slot = int(sub["slot"])
            committee_index = int(sub["committee_index"])
            committees_at_slot = int(sub.get("committees_at_slot", 1))
            slots_since_start = slot % self.p.SLOTS_PER_EPOCH
            subnet = (
                committees_at_slot * slots_since_start + committee_index
            ) % ATTESTATION_SUBNET_COUNT
            self.network.attnets.add_committee_subscription(subnet, until_slot=slot + 1)
            if "validator_index" in sub:
                self.network.attnets.add_validator(int(sub["validator_index"]))
        return {}

    def _sync_subs(self, pp, q, b):
        if self.network is None:
            return {}
        for sub in b or []:
            until = int(sub.get("until_epoch", 0)) * self.p.SLOTS_PER_EPOCH
            for idx in sub.get("sync_committee_indices", []):
                from ..chain.sync_committee_pools import SYNC_COMMITTEE_SUBNET_COUNT

                sub_size = self.p.SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
                self.network.syncnets.add_subscription(
                    int(idx) // sub_size, until_slot=until
                )
        return {}

    def _events(self, pp, q, b):
        """SSE stream of chain events (routes/events.ts:20).  ?topics=
        comma-list filters among head, block, finalized_checkpoint."""
        from ..chain.emitter import ChainEvent

        wanted = set((q.get("topics") or "head,block,finalized_checkpoint").split(","))
        queue: asyncio.Queue = asyncio.Queue(maxsize=256)
        chain = self.chain

        def _put(name: str, data: dict) -> None:
            try:
                queue.put_nowait((name, data))
            except asyncio.QueueFull:
                pass  # slow consumer: drop rather than grow unboundedly

        def on_head(root: bytes) -> None:
            node = chain.fork_choice.get_block(root)
            _put(
                "head",
                {
                    "slot": str(node.slot if node else 0),
                    "block": "0x" + root.hex(),
                    "state": "0x" + (node.state_root.hex() if node else "00" * 32),
                    "epoch_transition": False,
                },
            )

        def on_block(signed_block, root: bytes) -> None:
            _put(
                "block",
                {"slot": str(signed_block.message.slot), "block": "0x" + root.hex()},
            )

        def on_finalized(cp) -> None:
            _put(
                "finalized_checkpoint",
                {"epoch": str(cp.epoch), "block": "0x" + cp.root.hex()},
            )

        subs = []
        if "head" in wanted:
            chain.emitter.on(ChainEvent.HEAD, on_head)
            subs.append((ChainEvent.HEAD, on_head))
        if "block" in wanted:
            chain.emitter.on(ChainEvent.BLOCK, on_block)
            subs.append((ChainEvent.BLOCK, on_block))
        if "finalized_checkpoint" in wanted:
            chain.emitter.on(ChainEvent.FINALIZED, on_finalized)
            subs.append((ChainEvent.FINALIZED, on_finalized))

        # light-client SSE topics (routes/events.ts eventTypes
        # light_client_finality_update / light_client_optimistic_update)
        def on_lc_finality(update) -> None:
            _put("light_client_finality_update", to_json(update))

        def on_lc_optimistic(update) -> None:
            _put("light_client_optimistic_update", to_json(update))

        if "light_client_finality_update" in wanted:
            chain.emitter.on(ChainEvent.LIGHT_CLIENT_FINALITY_UPDATE, on_lc_finality)
            subs.append((ChainEvent.LIGHT_CLIENT_FINALITY_UPDATE, on_lc_finality))
        if "light_client_optimistic_update" in wanted:
            chain.emitter.on(ChainEvent.LIGHT_CLIENT_OPTIMISTIC_UPDATE, on_lc_optimistic)
            subs.append((ChainEvent.LIGHT_CLIENT_OPTIMISTIC_UPDATE, on_lc_optimistic))

        async def stream():
            try:
                while True:
                    try:
                        name, data = await asyncio.wait_for(queue.get(), 15.0)
                    except asyncio.TimeoutError:
                        yield b": keep-alive\n\n"
                        continue
                    yield (
                        f"event: {name}\ndata: {json.dumps(data)}\n\n".encode()
                    )
            finally:
                for ev, fn in subs:
                    chain.emitter.off(ev, fn)

        return stream(), "text/event-stream"

    def _debug_state(self, pp, q, b):
        """Fork-tagged SSZ state (1 tag byte + SSZ — the same codec the db
        uses; clients of this framework decode with it)."""
        from ..db.beacon import _fork_tagged_state_codec

        state = self._state_for(pp["state_id"])
        enc, _dec = _fork_tagged_state_codec(self.p)
        return enc(state), "application/octet-stream"

    def _block_for(self, block_id: str):
        chain = self.chain
        if block_id == "head":
            blk = chain.get_block_by_root(chain.head_root)
        elif block_id in ("justified", "finalized"):
            cp = (
                chain.fork_choice.store.justified_checkpoint
                if block_id == "justified"
                else chain.fork_choice.store.finalized_checkpoint
            )
            blk = chain.get_block_by_root(cp.root)
        elif block_id.startswith("0x"):
            blk = chain.get_block_by_root(bytes.fromhex(block_id[2:]))
        else:
            raise ApiError(400, f"unsupported block id {block_id}")
        if blk is None:
            raise ApiError(404, f"block {block_id} not found")
        return blk

    def _block_ssz(self, pp, q, b):
        from ..db.beacon import _fork_tagged_block_codec

        blk = self._block_for(pp["block_id"])
        enc, _dec = _fork_tagged_block_codec(self.p)
        return enc(blk), "application/octet-stream"

    def _health(self, pp, q, b):
        """Spec getHealth (routes/node.ts): 200 ready, 206 synced-but-
        syncing, 503 not ready.  Body is empty per spec — the status code
        IS the answer."""
        try:
            syncing = self._syncing(pp, q, b)["data"]["is_syncing"]
        except Exception:  # noqa: BLE001 — no head state yet: not ready
            return (503, {}, "application/json")
        if syncing:
            return (206, {}, "application/json")
        return {}

    def _syncing(self, pp, q, b):
        head_slot = self.chain.head_state().slot
        clock_slot = self.chain.clock.current_slot if self.chain.clock else head_slot
        distance = max(0, clock_slot - head_slot)
        return {
            "data": {
                "head_slot": str(head_slot),
                "sync_distance": str(distance),
                "is_syncing": distance > 1,
                "is_optimistic": False,
            }
        }

    def _genesis(self, pp, q, b):
        gs = self.chain.genesis_state
        return {
            "data": {
                "genesis_time": str(gs.genesis_time),
                "genesis_validators_root": "0x" + bytes(gs.genesis_validators_root).hex(),
                "genesis_fork_version": "0x" + bytes(gs.fork.current_version).hex(),
            }
        }

    def _finality(self, pp, q, b):
        st = self._state_for(pp["state_id"])
        return {
            "data": {
                "previous_justified": to_json(st.previous_justified_checkpoint),
                "current_justified": to_json(st.current_justified_checkpoint),
                "finalized": to_json(st.finalized_checkpoint),
            }
        }

    def _validator(self, pp, q, b):
        st = self._state_for(pp["state_id"])
        vid = pp["validator_id"]
        if vid.startswith("0x"):
            pk = bytes.fromhex(vid[2:])
            idx = next(
                (i for i, v in enumerate(st.validators) if bytes(v.pubkey) == pk), None
            )
            if idx is None:
                raise ApiError(404, "validator not found")
        else:
            idx = int(vid)
            if idx >= len(st.validators):
                raise ApiError(404, "validator not found")
        v = st.validators[idx]
        return {
            "data": {
                "index": str(idx),
                "balance": str(st.balances[idx]),
                "status": "active_ongoing",
                "validator": to_json(v),
            }
        }

    def _header(self, pp, q, b):
        block_id = pp["block_id"]
        chain = self.chain
        root = chain.head_root if block_id == "head" else (
            bytes.fromhex(block_id[2:]) if block_id.startswith("0x") else None
        )
        if root is None:
            raise ApiError(400, "unsupported block id")
        blk = chain.get_block_by_root(root)
        if blk is None:
            raise ApiError(404, "block not found")
        hdr = Fields(
            slot=blk.message.slot,
            proposer_index=blk.message.proposer_index,
            parent_root=bytes(blk.message.parent_root),
            state_root=bytes(blk.message.state_root),
            body_root=b"\x00" * 32,
        )
        return {
            "data": {
                "root": "0x" + root.hex(),
                "canonical": True,
                "header": {"message": to_json(hdr), "signature": "0x" + bytes(blk.signature).hex()},
            }
        }

    def _duty_state(self, epoch: int):
        st = clone_state(self.p, self.chain.head_state())
        start = compute_start_slot_at_epoch(self.p, epoch)
        ctx = process_slots(self.p, self.chain.cfg, st, max(st.slot, start))
        return st, ctx

    def _proposer_duties(self, pp, q, b):
        epoch = int(pp["epoch"])
        st, ctx = self._duty_state(epoch)
        start = compute_start_slot_at_epoch(self.p, epoch)
        duties = []
        for slot in range(start, start + self.p.SLOTS_PER_EPOCH):
            if slot == 0:
                continue  # genesis slot has no proposal
            proposer = ctx.get_beacon_proposer_at(slot, st) if hasattr(ctx, "get_beacon_proposer_at") else ctx.get_beacon_proposer(slot)
            duties.append(
                {
                    "pubkey": "0x" + bytes(st.validators[proposer].pubkey).hex(),
                    "validator_index": str(proposer),
                    "slot": str(slot),
                }
            )
        return {"data": duties, "dependent_root": "0x" + self.chain.head_root.hex()}

    def _attester_duties(self, pp, q, b):
        epoch = int(pp["epoch"])
        indices = {int(i) for i in (b or [])}
        st, ctx = self._duty_state(epoch)
        start = compute_start_slot_at_epoch(self.p, epoch)
        duties = []
        committees_per_slot = ctx.get_committee_count_per_slot(epoch)
        for slot in range(start, start + self.p.SLOTS_PER_EPOCH):
            for index in range(committees_per_slot):
                committee = ctx.get_beacon_committee(slot, index)
                for pos, vi in enumerate(committee):
                    if int(vi) in indices:
                        duties.append(
                            {
                                "pubkey": "0x" + bytes(st.validators[int(vi)].pubkey).hex(),
                                "validator_index": str(int(vi)),
                                "committee_index": str(index),
                                "committee_length": str(len(committee)),
                                "committees_at_slot": str(committees_per_slot),
                                "validator_committee_index": str(pos),
                                "slot": str(slot),
                            }
                        )
        return {"data": duties, "dependent_root": "0x" + self.chain.head_root.hex()}

    def _produce_block(self, pp, q, b):
        slot = int(pp["slot"])
        randao = bytes.fromhex(q.get("randao_reveal", "0x" + "00" * 96)[2:])
        block, _proposer = self.chain.produce_block(slot, randao)
        from ..state_transition.upgrade import block_fork_name

        return {
            "version": block_fork_name(block).value,
            "data": to_json(block),
        }

    async def _publish_block(self, pp, q, b):
        from ..state_transition.upgrade import block_types

        signed = from_json(b)
        # normalize list-typed body fields the JSON round-trip flattened
        root = await self.chain.process_block(signed)
        if self.network is not None:
            await self.network.publish_block(signed)
        return {"data": {"root": "0x" + root.hex()}}

    async def _produce_blinded_block(self, pp, q, b):
        slot = int(pp["slot"])
        randao = bytes.fromhex(q.get("randao_reveal", "0x" + "00" * 96)[2:])
        try:
            block, _proposer = await self.chain.produce_blinded_block(slot, randao)
        except Exception as e:  # builder down/missing -> 503 per spec
            raise ApiError(503, f"blinded production unavailable: {e}")
        from ..state_transition.upgrade import block_fork_name

        return {"version": block_fork_name(block).value, "data": to_json(block)}

    async def _publish_blinded_block(self, pp, q, b):
        signed_blinded = from_json(b)
        root = await self.chain.publish_blinded_block(signed_blinded)
        # broadcast the UNBLINDED block (the import path persisted it):
        # peers must receive the full payload, same as _publish_block
        if self.network is not None:
            signed = self.chain.db.block.get(root)
            if signed is not None:
                await self.network.publish_block(signed)
        return {"data": {"root": "0x" + root.hex()}}

    def _prepare_proposer(self, pp, q, b):
        """prepareBeaconProposer: remember each validator's fee recipient
        (chain/beaconProposerCache.ts)."""
        from ..state_transition import compute_epoch_at_slot as _epoch_at

        epoch = 0
        if self.chain.clock is not None:
            epoch = _epoch_at(self.p, self.chain.clock.current_slot)
        cache = self.chain.beacon_proposer_cache
        for entry in b or []:
            cache.add(
                epoch,
                int(entry["validator_index"]),
                bytes.fromhex(entry["fee_recipient"][2:]),
            )
        cache.prune(epoch)
        return {}

    async def _register_validator(self, pp, q, b):
        """registerValidator: forward signed registrations to the builder
        (api/impl/validator registerValidator)."""
        regs = [from_json(r) for r in b or []]
        builder = getattr(self.chain, "builder", None)
        if builder is None:
            return {}
        await self.chain._maybe_await(builder.register_validator(regs))
        return {}

    def _attestation_data(self, pp, q, b):
        slot = int(q["slot"])
        index = int(q.get("committee_index", 0))
        chain = self.chain
        head_root = chain.head_root
        st = clone_state(self.p, chain.head_state())
        process_slots(self.p, chain.cfg, st, max(st.slot, slot))
        epoch = compute_epoch_at_slot(self.p, slot)
        boundary = compute_start_slot_at_epoch(self.p, epoch)
        if boundary >= st.slot:
            target_root = head_root
        else:
            target_root = bytes(st.block_roots[boundary % self.p.SLOTS_PER_HISTORICAL_ROOT])
        data = Fields(
            slot=slot,
            index=index,
            beacon_block_root=head_root,
            source=st.current_justified_checkpoint,
            target=Fields(epoch=epoch, root=target_root),
        )
        return {"data": to_json(data)}

    async def _submit_attestations(self, pp, q, b):
        handlers = getattr(self, "gossip_handlers", None)
        errors = []
        for i, att_json in enumerate(b or []):
            att = from_json(att_json)
            try:
                if handlers is not None:
                    await handlers.on_attestation(att)
                else:
                    self.chain.att_pool.add(att)
                    self.chain.agg_pool.add(att)
                if self.network is not None:
                    await self.network.publish_attestation(att)
            except Exception as e:  # noqa: BLE001
                errors.append({"index": i, "message": str(e)})
        if errors:
            raise ApiError(400, json.dumps(errors))
        return {}

    async def _submit_exit(self, pp, q, b):
        signed_exit = from_json(b)
        self.chain.op_pool.add_voluntary_exit(signed_exit)
        if self.network is not None:
            await self.network.publish_voluntary_exit(signed_exit)
        return {}

    def _submit_proposer_slashing(self, pp, q, b):
        """routes/beacon/pool.ts submitPoolProposerSlashings (the flare
        self-slash target)."""
        self.chain.op_pool.add_proposer_slashing(from_json(b))
        return {}

    def _submit_attester_slashing(self, pp, q, b):
        self.chain.op_pool.add_attester_slashing(from_json(b))
        return {}

    def _aggregate_attestation(self, pp, q, b):
        slot = int(q["slot"])
        data_root = bytes.fromhex(q["attestation_data_root"][2:])
        agg = self.chain.att_pool.get_aggregate(slot, data_root)
        if agg is None:
            raise ApiError(404, "no matching attestations in the pool")
        return {"data": to_json(agg)}

    async def _submit_aggregates(self, pp, q, b):
        handlers = getattr(self, "gossip_handlers", None)
        errors = []
        for i, sa_json in enumerate(b or []):
            signed_aggregate = from_json(sa_json)
            try:
                if handlers is not None:
                    await handlers.on_aggregate_and_proof(signed_aggregate)
                else:
                    self.chain.agg_pool.add(signed_aggregate.message.aggregate)
            except Exception as e:  # noqa: BLE001
                errors.append({"index": i, "message": str(e)})
        if errors:
            raise ApiError(400, json.dumps(errors))
        return {}

    def _liveness(self, pp, q, b):
        """Validator liveness per epoch from the chain's seen-block-attester
        cache (api/impl/validator liveness; backs doppelganger checks)."""
        epoch = int(pp["epoch"])
        seen = self.chain.seen_block_attesters
        out = []
        for idx in b or []:
            i = int(idx)
            out.append({"index": str(i), "is_live": seen.is_known(epoch, i)})
        return {"data": out}

    def _sync_duties(self, pp, q, b):
        """Sync-committee duties: which requested validators sit in the
        CURRENT sync committee and on which subnets (validator duties/sync)."""
        from ..chain.sync_committee_pools import subcommittee_assignment
        from ..state_transition.upgrade import state_fork_name
        from ..config.fork_config import ForkName

        state = self.chain.head_state()
        if state_fork_name(state) == ForkName.phase0:
            return {"data": []}
        duties = []
        for idx in b or []:
            i = int(idx)
            subs = subcommittee_assignment(self.p, state, i)
            if subs:
                duties.append(
                    {
                        "pubkey": "0x" + bytes(state.validators[i].pubkey).hex(),
                        "validator_index": str(i),
                        "validator_sync_committee_indices": [str(s) for s in subs],
                    }
                )
        return {"data": duties}

    async def _submit_sync_messages(self, pp, q, b):
        """Validate + pool sync-committee messages (beacon/pool/sync_committees)."""
        from ..chain.seen_cache import SeenSyncCommitteeMessages
        from ..chain.sync_committee_pools import (
            subcommittee_assignment,
            validate_sync_committee_message,
        )
        from ..state_transition import EpochContext

        chain = self.chain
        if not hasattr(self, "_seen_sync_msgs"):
            self._seen_sync_msgs = SeenSyncCommitteeMessages()
        state = chain.head_state()
        ctx = EpochContext.create_from_state(self.p, state)
        errors = []
        for i, msg_json in enumerate(b or []):
            msg = from_json(msg_json)
            try:
                subs = subcommittee_assignment(self.p, state, msg.validator_index)
                if not subs:
                    raise ApiError(400, "validator not in sync committee")
                idx = await validate_sync_committee_message(
                    self.p, chain.cfg, message=msg, subnet=subs[0],
                    clock_slot=msg.slot, state=state, ctx=ctx,
                    seen_sync_msgs=self._seen_sync_msgs, pool=chain.bls,
                )
                # the committee samples with replacement: pool the message at
                # EVERY position the validator occupies, not just the first
                pk = bytes(state.validators[msg.validator_index].pubkey)
                width = self.p.SYNC_COMMITTEE_SUBNET_SIZE
                for pos, cpk in enumerate(state.current_sync_committee.pubkeys):
                    if bytes(cpk) == pk:
                        chain.sync_msg_pool.add(
                            msg.slot, bytes(msg.beacon_block_root),
                            pos // width, pos % width, bytes(msg.signature),
                        )
            except Exception as e:  # noqa: BLE001
                errors.append({"index": i, "message": str(e)})
        if errors:
            raise ApiError(400, json.dumps(errors))
        return {}

    def _sync_contribution(self, pp, q, b):
        slot = int(q["slot"])
        sub = int(q["subcommittee_index"])
        root = bytes.fromhex(q["beacon_block_root"][2:])
        c = self.chain.sync_msg_pool.get_contribution(slot, root, sub)
        if c is None:
            raise ApiError(404, "no contribution available")
        return {"data": to_json(c)}

    async def _submit_contributions(self, pp, q, b):
        """Validate (aggregator selection + all three signatures) before
        pooling — an unvalidated all-bits contribution would otherwise win
        every pool slot and poison produced blocks."""
        from ..chain.sync_committee_pools import validate_sync_committee_contribution
        from ..state_transition import EpochContext

        chain = self.chain
        if not hasattr(self, "_seen_contributions"):
            self._seen_contributions = set()
        state = chain.head_state()
        ctx = EpochContext.create_from_state(self.p, state)
        errors = []
        for i, sc_json in enumerate(b or []):
            sc = from_json(sc_json)
            try:
                await validate_sync_committee_contribution(
                    self.p, chain.cfg, signed_contribution=sc,
                    clock_slot=sc.message.contribution.slot, state=state,
                    ctx=ctx, seen_contributions=self._seen_contributions,
                    pool=chain.bls,
                )
                chain.contribution_pool.add(sc.message.contribution)
            except Exception as e:  # noqa: BLE001
                errors.append({"index": i, "message": str(e)})
        if errors:
            raise ApiError(400, json.dumps(errors))
        return {}

    def _lc_bootstrap(self, pp, q, b):
        """Light-client bootstrap for a trusted block root
        (beacon/light_client/bootstrap/{block_root}; served from the
        chain's LightClientServer when one is attached)."""
        lc = getattr(self, "light_client_server", None)
        if lc is None:
            raise ApiError(404, "light client server not enabled")
        root = bytes.fromhex(pp["block_root"][2:])
        boot = lc.get_bootstrap(root)
        if boot is None:
            raise ApiError(404, "bootstrap unavailable for that root")
        return {"data": to_json(boot)}

    def _lc_updates(self, pp, q, b):
        """Best updates by sync period range
        (beacon/light_client/updates?start_period=&count=)."""
        lc = getattr(self, "light_client_server", None)
        if lc is None:
            raise ApiError(404, "light client server not enabled")
        start = int(q.get("start_period", 0))
        count = min(int(q.get("count", 1)), 128)
        out = []
        for period in range(start, start + count):
            u = lc.get_update(period)
            if u is not None:
                out.append(to_json(u))
        return {"data": out}

    def _lc_finality_update(self, pp, q, b):
        """Latest finality update (routes/lightclient.ts:60
        getLightClientFinalityUpdate)."""
        lc = getattr(self, "light_client_server", None)
        if lc is None:
            raise ApiError(404, "light client server not enabled")
        u = lc.get_finality_update()
        if u is None:
            raise ApiError(404, "no finality update available")
        return {"data": to_json(u)}

    def _lc_optimistic_update(self, pp, q, b):
        """Latest optimistic (head) update (routes/lightclient.ts:60
        getLightClientOptimisticUpdate)."""
        lc = getattr(self, "light_client_server", None)
        if lc is None:
            raise ApiError(404, "light client server not enabled")
        u = lc.get_optimistic_update()
        if u is None:
            raise ApiError(404, "no optimistic update available")
        return {"data": to_json(u)}

    def _metrics(self, pp, q, b):
        if self.metrics_registry is None:
            raise ApiError(404, "metrics not enabled")
        return (self.metrics_registry.expose(), "text/plain; version=0.0.4")

    def _traces(self, pp, q, b):
        """Span-tracer dump (docs/observability.md).  Default: the raw
        span list with correlation ids.  ``?format=chrome`` returns the
        Chrome trace-event JSON that chrome://tracing / Perfetto load
        directly — `curl .../traces?format=chrome > t.json` is the whole
        capture workflow on a live node."""
        from ..tracing import TRACER, to_chrome_trace

        if q.get("format") == "chrome":
            return (json.dumps(to_chrome_trace(TRACER)).encode(), "application/json")
        spans = TRACER.spans()
        return {
            "data": {
                "enabled": TRACER.enabled,
                "capacity": TRACER.capacity,
                "dropped": TRACER.dropped,
                "count": len(spans),
                "spans": [s.to_dict() for s in spans],
            }
        }

    def _bls_stages(self, pp, q, b):
        """The previously-unexported BLS pipeline counters: the verifier's
        cumulative per-stage seconds and the pool's pipelining stats."""
        pool = getattr(self.chain, "bls", None) if self.chain is not None else None
        if pool is None:
            raise ApiError(404, "bls pool not available")
        verifier = getattr(pool, "verifier", None)
        data = {
            "stage_seconds": dict(getattr(verifier, "stage_seconds", None) or {}),
            "inflight_peak": getattr(pool, "inflight_peak", 0),
            "pipeline_depth": getattr(pool, "pipeline_depth", 1),
            "batch_retries": getattr(pool, "batch_retries", 0),
            "batch_sets_success": getattr(pool, "batch_sets_success", 0),
            "pending_sets": pool.pending_sets() if hasattr(pool, "pending_sets") else 0,
            "verifier": type(verifier).__name__ if verifier is not None else None,
            "dispatches": getattr(verifier, "dispatches", 0),
            "sets_verified": getattr(verifier, "sets_verified", 0),
            "padding_wasted": getattr(verifier, "padding_wasted", 0),
            "host_final_exps": getattr(verifier, "host_final_exps", 0),
            # the port has no degrade ladder: nothing falls back
            "fused_fallbacks": 0,
            # the executor pool and the pack caches
            "n_devices": getattr(verifier, "n_devices", 1),
            "device_inflight": (
                verifier.device_inflight()
                if hasattr(verifier, "device_inflight") else {}
            ),
            "pack_cache_hits": getattr(verifier, "pack_cache_hits", 0),
            "pack_cache_misses": getattr(verifier, "pack_cache_misses", 0),
            "pack_rejected": getattr(verifier, "pack_rejected", 0),
        }
        return {"data": data}

    def _lodestar_health(self, pp, q, b):
        """Aggregated operational health, built on the spec health status:
        pool depth, per-device in-flight, watchdog state, and the last
        journal error — one curl answers 'is this node okay and if not,
        what broke last'."""
        from ..forensics import INFLIGHT, JOURNAL, RECORDER

        health = self._health(pp, q, b)
        status = health[0] if isinstance(health, tuple) else 200
        pool = getattr(self.chain, "bls", None) if self.chain is not None else None
        verifier = getattr(pool, "verifier", None)
        wd = RECORDER.watchdog
        data = {
            "status": status,
            "pending_sets": (
                pool.pending_sets()
                if pool is not None and hasattr(pool, "pending_sets") else 0
            ),
            "inflight": INFLIGHT.snapshot(),
            "device_inflight": (
                verifier.device_inflight()
                if hasattr(verifier, "device_inflight") else {}
            ),
            "watchdog": wd.state() if wd is not None else None,
            "journal": {
                "events": len(JOURNAL),
                "dropped": JOURNAL.dropped,
                "last_error": JOURNAL.last_error(),
            },
            "bundles_written": RECORDER.bundles_written,
        }
        if hasattr(verifier, "executor_health"):
            # the card verifier's executors (healthy / suspect /
            # quarantined / probing); a host verifier has none
            data["executors"] = verifier.executor_health()
        return (status, {"data": data}, "application/json")

    def _observatory(self, pp, q, b):
        """Performance-observatory snapshot (docs/observability.md
        §Performance observatory): the compile ledger's per-entry
        cold/warm_load/hit totals and the device sampler's HBM/busy view
        — `curl .../observatory | jq .data.compile_ledger` answers "what
        did startup pay" on a live node."""
        from ..observatory import COMPILE_LEDGER, get_sampler
        from ..observatory.latency import SLO_LATENCY_BUCKETS_S

        sampler = get_sampler()
        return {
            "data": {
                "compile_ledger": COMPILE_LEDGER.summary(),
                "device_telemetry": sampler.snapshot() if sampler else None,
                "latency_buckets_s": list(SLO_LATENCY_BUCKETS_S),
            }
        }

    async def _profile(self, pp, q, b):
        """Arm a device-profile window bracketing the next ``?flushes=N``
        BLS pool flushes (docs/observability.md §Mesh observatory).
        Waits up to ``?wait_s`` (default 10) for the window to close;
        ``?format=chrome`` then returns the merged host+device Chrome
        trace itself (Perfetto-loadable, ``check_trace.py
        --require-device`` clean), anything else the capture snapshot.
        A capture is created on demand (a ``torch.profiler`` window on the
        capture's own thread, ``observatory/xprof``) unless the
        CLI/tests already configured one — e.g. a stub-pool test injects
        fake profiler hooks."""
        from ..observatory import xprof

        cap = xprof.get_capture()
        if cap is None:
            cap = xprof.configure_capture(metrics=self.metrics)
        try:
            flushes = int(q.get("flushes", 2))
            wait_s = float(q.get("wait_s", 10.0))
        except ValueError as e:
            raise ApiError(400, f"bad profile query: {e}")
        windows_before = cap.windows
        cap.request_window(flushes)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + max(0.0, wait_s)
        while cap.windows == windows_before and loop.time() < deadline:
            await asyncio.sleep(0.05)
        if q.get("format") == "chrome":
            last = cap.last_window()
            if cap.windows == windows_before or last is None:
                raise ApiError(
                    504,
                    "profile window still open (not enough pool flushes "
                    "inside wait_s) and no prior window to return — "
                    "retry with a longer ?wait_s or drive more traffic",
                )
            return (json.dumps(last["trace"]).encode(), "application/json")
        return {"data": cap.snapshot()}

    def _profile_status(self, pp, q, b):
        """Capture state + last-window summary without arming anything
        (``?format=chrome`` fetches the last merged trace)."""
        from ..observatory import xprof

        cap = xprof.get_capture()
        if cap is None:
            raise ApiError(404, "no profile capture configured")
        if q.get("format") == "chrome":
            last = cap.last_window()
            if last is None:
                raise ApiError(404, "no completed profile window yet")
            return (json.dumps(last["trace"]).encode(), "application/json")
        return {"data": cap.snapshot()}

    def _forensics(self, pp, q, b):
        """On-demand diagnostic bundle ('what are you doing right now'
        without sending SIGUSR2).  Writes a bundle and returns its path
        plus the manifest, so `curl .../forensics | jq .data.manifest`
        is a remote triage in one call."""
        import os

        from ..forensics import RECORDER
        from ..forensics.bundle import MANIFEST_NAME

        pool = getattr(self.chain, "bls", None) if self.chain is not None else None
        RECORDER.configure(metrics=self.metrics, pool=pool)
        # caller text is slugged + bounded (directory name) and NEVER the
        # metric label (unbounded cardinality from a query string); the
        # recorder also prunes its dir, so polling cannot fill the disk
        raw = q.get("reason", "")
        slug = "".join(c for c in raw if c.isalnum() or c in "-_")[:32]
        path = RECORDER.dump(f"api-{slug}" if slug else "api",
                             metric_reason="api")
        with open(os.path.join(path, MANIFEST_NAME)) as f:
            manifest = json.load(f)
        return {"data": {"bundle": path, "manifest": manifest}}
