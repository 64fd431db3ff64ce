"""Network: TCP listener/dialer tying wire frames to req/resp + gossip.

Reference: packages/beacon-node/src/network/network.ts:41 — the object a
node owns: transport lifecycle, peer manager, req/resp endpoint per peer,
gossip router bound to the chain's gossip handlers.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

from ..params import Preset
from ..types import get_types
from ..utils.logger import get_logger
from .gossip import (
    ATTESTATION_SUBNET_COUNT,
    SYNC_COMMITTEE_SUBNET_COUNT,
    TOPIC_AGGREGATE,
    TOPIC_ATTESTATION,
    TOPIC_ATTESTER_SLASHING,
    TOPIC_BLOCK,
    TOPIC_EXIT,
    TOPIC_PROPOSER_SLASHING,
    TOPIC_SYNC_COMMITTEE,
    TOPIC_SYNC_CONTRIBUTION,
    GossipRouter,
    parse_topic,
    topic_string,
)
from .peer import (
    Peer,
    PeerAction,
    PeerManager,
    PeerRpcScoreStore,
    ScoreState,
)
from .reqresp import ReqRespNode
from .wire import (
    KIND_GOSSIP,
    KIND_GOSSIP_CTRL,
    KIND_REQUEST,
    KIND_RESPONSE_CHUNK,
    KIND_RESPONSE_END,
    Wire,
)

logger = get_logger("network")


class Network:
    def __init__(self, preset: Preset, chain, gossip_handlers=None, host: str = "127.0.0.1", metrics=None):
        self.p = preset
        self.chain = chain
        self.handlers = gossip_handlers
        self.metrics = metrics
        self.host = host
        self.port: Optional[int] = None
        self.peer_manager = PeerManager()
        self.score_store = PeerRpcScoreStore()
        self.router = GossipRouter(
            on_reject=self._on_gossip_reject, on_evict=self._on_gossip_evict,
            metrics=metrics,
            # storm-topic intake slows while the BLS pool sits above its
            # high-water mark (docs/overload.md §Backpressure)
            backpressure=lambda: getattr(
                getattr(chain, "bls", None), "overloaded", False
            ),
        )
        # subnet services + seq-numbered metadata (SURVEY §2.5 attnets/
        # syncnets; served to peers over reqresp METADATA)
        from .subnets import AttnetsService, MetadataController, SyncnetsService

        self.metadata = MetadataController()
        self.attnets = AttnetsService(preset, self.metadata)
        self.syncnets = SyncnetsService(preset, self.metadata)
        # chain progress ticks the subnet services (rotation + expiry);
        # committee/sync subscriptions arrive via the REST routes
        from ..chain.emitter import ChainEvent

        chain.emitter.on(
            ChainEvent.BLOCK,
            lambda sb, _root: (
                self.attnets.on_slot(sb.message.slot),
                self.syncnets.on_slot(sb.message.slot),
            ),
        )
        self._server: Optional[asyncio.AbstractServer] = None
        self._peer_seq = 0
        self.discovery = None
        self.t = get_types(preset).phase0
        if gossip_handlers is not None:
            self._subscribe_core_topics()

    # -- discovery (peers/discover.ts role) ------------------------------------

    async def enable_discovery(
        self, identity, udp_port: int = 0, bootstrap=()
    ) -> int:
        """Start the UDP discovery service; newly discovered records are
        dialed while the peer count is below max_peers."""
        from .discovery import DiscoveryService

        def on_peer(rec) -> None:
            if len(self.peer_manager.peers) >= self.peer_manager.max_peers:
                return
            if self.score_store.state(str(rec.ip)) == ScoreState.BANNED:
                return
            logger.info("discovered peer %s:%d; dialing", rec.ip, rec.tcp_port)
            asyncio.ensure_future(self._dial_discovered(rec))

        self.discovery = DiscoveryService(
            identity, tcp_port=self.port or 0, host=self.host, on_peer=on_peer
        )
        port = await self.discovery.listen(udp_port)
        for host, bport in bootstrap:
            self.discovery.add_bootstrap(host, bport)
        self.discovery.start_lookups()
        return port

    async def _dial_discovered(self, rec) -> None:
        try:
            await self.connect(rec.ip, rec.tcp_port)
        except Exception as e:  # noqa: BLE001
            logger.debug("dial of discovered peer failed: %s", e)

    # -- lifecycle -------------------------------------------------------------

    async def listen(self, port: int = 0) -> int:
        self._server = await asyncio.start_server(self._on_inbound, self.host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        self.router.start()
        logger.info("listening on %s:%d", self.host, self.port)
        return self.port

    async def connect(self, host: str, port: int) -> Peer:
        reader, writer = await asyncio.open_connection(host, port)
        return await self._setup_peer(reader, writer, initiator=True)

    async def close(self) -> None:
        self.router.stop()
        if self.discovery is not None:
            await self.discovery.close()
        for peer in self.peer_manager.connected():
            await self._drop_peer(peer, goodbye=True)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- connection plumbing ---------------------------------------------------

    async def _on_inbound(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            await self._setup_peer(reader, writer, initiator=False)
        except ConnectionRefusedError as e:
            logger.debug("inbound connection refused: %s", e)

    async def _setup_peer(self, reader, writer, *, initiator: bool) -> Peer:
        self._peer_seq += 1
        peer_id = f"peer-{id(self) & 0xFFFF:x}-{self._peer_seq}"
        try:
            # score identity = remote HOST for both directions: inbound
            # source ports are ephemeral, and a split host:port/host keying
            # would let a banned outbound peer re-enter inbound.
            # IP-granular banning (with its NAT collateral) matches the
            # reference's IP ban list.
            remote_key = str(writer.get_extra_info("peername")[0])
        except Exception:
            remote_key = peer_id
        # banned identities are refused at the door (peers/score.ts ban)
        if self.score_store.state(remote_key) == ScoreState.BANNED:
            writer.close()
            raise ConnectionRefusedError(f"peer {remote_key} is banned")
        wire = Wire(reader, writer)
        reqresp = ReqRespNode(self.p, self.chain, wire, metadata=self.metadata, metrics=self.metrics)
        peer = Peer(peer_id=peer_id, reqresp=reqresp, wire=wire, remote_key=remote_key)

        async def gossip_send(topic: str, ssz_bytes: bytes) -> None:
            await wire.send_frame(KIND_GOSSIP, Wire.encode_gossip(topic, ssz_bytes))

        async def gossip_ctrl(ctrl: dict) -> None:
            await wire.send_frame(KIND_GOSSIP_CTRL, Wire.encode_gossip_ctrl(ctrl))

        # mesh identity is the CONNECTION (peer_id): score identity stays
        # the remote host, but distinct peers on one host must hold
        # distinct mesh slots
        self.router.add_peer(peer.peer_id, gossip_send, gossip_ctrl)
        self.peer_manager.add(peer)
        if self.metrics:
            self.metrics.peers.set(len(self.peer_manager.peers))
        task = asyncio.create_task(self._read_loop(peer))
        peer.tasks.append(task)
        await self.router.announce_subscriptions(peer.peer_id)
        if initiator:
            await self.peer_manager.handshake(peer, reqresp.local_status())
        return peer

    async def _read_loop(self, peer: Peer) -> None:
        try:
            while True:
                kind, payload = await peer.wire.recv_frame()
                if kind == KIND_REQUEST:
                    asyncio.ensure_future(peer.reqresp.on_request_frame(payload))
                elif kind in (KIND_RESPONSE_CHUNK, KIND_RESPONSE_END):
                    peer.reqresp.on_response_frame(kind, payload)
                elif kind == KIND_GOSSIP:
                    topic, data = Wire.decode_gossip(payload)
                    if self.metrics:
                        self.metrics.gossip_messages_total.labels(dir="rx").inc()
                    await self.router.on_message(topic, data, from_peer=peer.peer_id)
                    await self._enforce_score(peer)
                elif kind == KIND_GOSSIP_CTRL:
                    ctrl = Wire.decode_gossip_ctrl(payload)
                    await self.router.on_control(peer.peer_id, ctrl)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception as e:  # noqa: BLE001
            logger.warning("peer %s read loop error: %s", peer.peer_id, e)
        finally:
            await self._drop_peer(peer, goodbye=False)

    async def _drop_peer(self, peer: Peer, *, goodbye: bool) -> None:
        if self.peer_manager.get(peer.peer_id) is None:
            return
        if goodbye:
            await peer.reqresp.goodbye()
        self.peer_manager.remove(peer.peer_id)
        if self.metrics:
            self.metrics.peers.set(len(self.peer_manager.peers))
        self.router.remove_peer(peer.peer_id)
        peer.wire.close()
        for t in peer.tasks:
            if t is not asyncio.current_task():
                t.cancel()

    # -- peer scoring (peers/score.ts enforcement) -----------------------------

    def _on_gossip_reject(self, peer_key: str, code: str) -> None:
        """Router callback: an invalid (REJECT) gossip message is provable
        misbehavior — downscore the sender (router keys are connection ids;
        the score store keys on the remote host)."""
        peer = self.peer_manager.get(peer_key)
        key = peer.remote_key if peer is not None else peer_key
        self.score_store.apply_action(key, PeerAction.LOW_TOLERANCE, f"gossip:{code}")

    def _on_gossip_evict(self, peer_key: str, score: float) -> None:
        """Router callback: gossip score fell below the graylist
        threshold (scoringParameters.ts gossipScoreThresholds) — drop the
        peer."""
        peer = self.peer_manager.get(peer_key)
        if peer is not None:
            logger.info("evicting peer %s (gossip score %.0f)", peer_key, score)
            asyncio.ensure_future(self._drop_peer(peer, goodbye=True))

    async def report_peer(self, peer: Peer, action: PeerAction, reason: str = "") -> None:
        """Apply a score action and enforce the resulting state (the
        reqresp/sync entry point: bad blocks, garbage responses...)."""
        self.score_store.apply_action(peer.remote_key, action, reason)
        await self._enforce_score(peer)

    async def _enforce_score(self, peer: Peer) -> None:
        state = self.score_store.state(peer.remote_key)
        if state != ScoreState.HEALTHY and self.peer_manager.get(peer.peer_id) is not None:
            logger.info("dropping peer %s (%s)", peer.peer_id, state.value)
            await self._drop_peer(peer, goodbye=True)

    # -- gossip binding --------------------------------------------------------

    def _fork_digest(self) -> bytes:
        from ..state_transition import compute_fork_digest

        state = self.chain.head_state()
        return compute_fork_digest(
            self.p, bytes(state.fork.current_version), bytes(state.genesis_validators_root)
        )

    def _subscribe_core_topics(self) -> None:
        """Bind the spec topics to the chain's gossip handlers with SSZ
        decode at the boundary (gossipsub.ts topic handler table).  Topics
        are registered under EVERY fork digest in the schedule — the
        in-process analog of forks.ts's subscribe-2-epochs-ahead: messages
        for a past or future fork's digest resolve to the same handlers."""
        for digest in self._all_fork_digests():
            self._subscribe_topics_for_digest(digest)

    def _all_fork_digests(self):
        from ..state_transition import compute_fork_digest

        state = self.chain.head_state()
        gvr = bytes(state.genesis_validators_root)
        digests = []
        for info in self.chain.fork_config.forks_ascending:
            d = compute_fork_digest(self.p, info.version, gvr)
            if d not in digests:
                digests.append(d)
        return digests

    def _subscribe_topics_for_digest(self, digest: bytes) -> None:
        h = self.handlers
        t = self.t

        async def on_block(data: bytes) -> None:
            from ..db.beacon import _FORK_ORDER

            all_t = get_types(self.p)
            ft = getattr(all_t, _FORK_ORDER[data[0]])
            await h.on_block(ft.SignedBeaconBlock.deserialize(data[1:]))

        async def on_aggregate(data: bytes) -> None:
            await h.on_aggregate_and_proof(t.SignedAggregateAndProof.deserialize(data))

        async def on_exit(data: bytes) -> None:
            await h.on_voluntary_exit(t.SignedVoluntaryExit.deserialize(data))

        async def on_prop_slashing(data: bytes) -> None:
            await h.on_proposer_slashing(t.ProposerSlashing.deserialize(data))

        async def on_att_slashing(data: bytes) -> None:
            await h.on_attester_slashing(t.AttesterSlashing.deserialize(data))

        self.router.subscribe(topic_string(digest, TOPIC_BLOCK), on_block)
        self.router.subscribe(topic_string(digest, TOPIC_AGGREGATE), on_aggregate)
        self.router.subscribe(topic_string(digest, TOPIC_EXIT), on_exit)
        self.router.subscribe(topic_string(digest, TOPIC_PROPOSER_SLASHING), on_prop_slashing)
        self.router.subscribe(topic_string(digest, TOPIC_ATTESTER_SLASHING), on_att_slashing)
        for subnet in range(ATTESTATION_SUBNET_COUNT):  # all 64 (topic.ts)
            topic = topic_string(digest, TOPIC_ATTESTATION.format(subnet=subnet))

            async def on_att(data: bytes, _subnet=subnet) -> None:
                await h.on_attestation(t.Attestation.deserialize(data), subnet=_subnet)

            self.router.subscribe(topic, on_att)

        # altair sync-committee topics (gossip/interface.ts): the
        # contribution topic plus the 4 per-subnet message topics
        alt = get_types(self.p).altair

        async def on_contribution(data: bytes) -> None:
            await h.on_sync_contribution(alt.SignedContributionAndProof.deserialize(data))

        self.router.subscribe(topic_string(digest, TOPIC_SYNC_CONTRIBUTION), on_contribution)
        for subnet in range(SYNC_COMMITTEE_SUBNET_COUNT):
            topic = topic_string(digest, TOPIC_SYNC_COMMITTEE.format(subnet=subnet))

            async def on_sync_msg(data: bytes, _subnet=subnet) -> None:
                await h.on_sync_committee_message(
                    alt.SyncCommitteeMessage.deserialize(data), subnet=_subnet
                )

            self.router.subscribe(topic, on_sync_msg)

    # -- publish helpers (network.ts publishBeaconBlock etc.) ------------------

    async def publish_block(self, signed_block) -> int:
        from ..db.beacon import _FORK_ORDER
        from ..state_transition.upgrade import block_fork_name

        fork = block_fork_name(signed_block.message).value
        all_t = get_types(self.p)
        data = bytes([_FORK_ORDER.index(fork)]) + getattr(all_t, fork).SignedBeaconBlock.serialize(
            signed_block
        )
        return await self.router.publish(topic_string(self._fork_digest(), TOPIC_BLOCK), data)

    async def publish_attestation(self, attestation, subnet: int = 0) -> int:
        data = self.t.Attestation.serialize(attestation)
        return await self.router.publish(
            topic_string(self._fork_digest(), TOPIC_ATTESTATION.format(subnet=subnet)), data
        )

    async def publish_voluntary_exit(self, signed_exit) -> int:
        data = self.t.SignedVoluntaryExit.serialize(signed_exit)
        return await self.router.publish(topic_string(self._fork_digest(), TOPIC_EXIT), data)

    async def publish_sync_committee_message(self, message, subnet: int) -> int:
        data = get_types(self.p).altair.SyncCommitteeMessage.serialize(message)
        return await self.router.publish(
            topic_string(self._fork_digest(), TOPIC_SYNC_COMMITTEE.format(subnet=subnet)),
            data,
        )

    async def publish_sync_contribution(self, signed_contribution) -> int:
        data = get_types(self.p).altair.SignedContributionAndProof.serialize(signed_contribution)
        return await self.router.publish(
            topic_string(self._fork_digest(), TOPIC_SYNC_CONTRIBUTION), data
        )
