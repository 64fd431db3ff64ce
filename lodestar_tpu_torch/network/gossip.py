"""Gossipsub-semantics router: scored mesh overlay with lazy IHAVE/IWANT.

Reference: packages/beacon-node/src/network/gossip/gossipsub.ts:84 (the
scored mesh), scoringParameters.ts:18-120 (D parameters, topic weights,
thresholds, behaviour penalty), and the gossipsub v1.1 spec semantics —
re-expressed on this stack's custom wire (network/wire.py KIND_GOSSIP /
KIND_GOSSIP_CTRL frames) rather than libp2p:

- MESH: per-topic overlay of degree D (D_LO..D_HI), maintained by a
  heartbeat: GRAFT under-filled meshes from known subscribers with
  non-negative score, PRUNE over-filled ones keeping the highest-scored.
  Publishes and forwards go to mesh members only — O(D) fanout per
  message instead of O(peers).
- LAZY GOSSIP: each heartbeat advertises the last few windows of message
  ids (IHAVE) to D_LAZY random non-mesh subscribers; peers request what
  they miss (IWANT) from the message cache.
- SCORING: per-peer, per-topic counters (time in mesh, first deliveries,
  invalid deliveries) with the reference's topic weights, plus a global
  behaviour penalty; decayed every heartbeat.  Scores gate GRAFT
  acceptance, order PRUNE victims, and drive eviction below the graylist
  threshold.

Subscriptions are exchanged on connect and on change (SUB/UNSUB control
entries), so meshes only ever contain peers that declared the topic.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Dict, List, Optional, Set, Tuple

from ..utils.logger import get_logger

logger = get_logger("gossip")

TOPIC_BLOCK = "beacon_block"
TOPIC_AGGREGATE = "beacon_aggregate_and_proof"
TOPIC_ATTESTATION = "beacon_attestation_{subnet}"
TOPIC_EXIT = "voluntary_exit"
TOPIC_PROPOSER_SLASHING = "proposer_slashing"
TOPIC_ATTESTER_SLASHING = "attester_slashing"
TOPIC_SYNC_CONTRIBUTION = "sync_committee_contribution_and_proof"
TOPIC_SYNC_COMMITTEE = "sync_committee_{subnet}"

from ..params.presets import (  # noqa: E402 - single source of truth
    ATTESTATION_SUBNET_COUNT,
    SYNC_COMMITTEE_SUBNET_COUNT,
)

# mesh degree parameters (scoringParameters.ts:18-20)
GOSSIP_D = 8
GOSSIP_D_LOW = 6
GOSSIP_D_HIGH = 12
GOSSIP_D_LAZY = 6
GOSSIP_FACTOR = 0.25
MCACHE_LEN = 5        # heartbeats of full messages kept
MCACHE_GOSSIP = 3     # windows advertised in IHAVE
HEARTBEAT_INTERVAL = 0.7
MAX_IHAVE_LEN = 5000

# peer score thresholds (scoringParameters.ts gossipScoreThresholds)
GOSSIP_THRESHOLD = -4000.0      # below: no gossip exchange (IHAVE/IWANT)
PUBLISH_THRESHOLD = -8000.0     # below: not eligible for publish fanout
GRAYLIST_THRESHOLD = -16000.0   # below: evict

MAX_IN_MESH_SCORE = 10.0
MAX_FIRST_MESSAGE_DELIVERIES_SCORE = 40.0


@dataclass
class TopicScoreParams:
    """Per-topic score weights (scoringParameters.ts TopicScoreParams,
    reduced to the counters this router tracks)."""

    topic_weight: float
    time_in_mesh_weight: float = 0.033
    time_in_mesh_cap: float = 300.0
    first_message_deliveries_weight: float = 1.0
    first_message_deliveries_cap: float = 40.0
    first_message_deliveries_decay: float = 0.95
    invalid_message_deliveries_weight: float = -140.0
    invalid_message_deliveries_decay: float = 0.99


# topic weights (scoringParameters.ts:24-31)
_TOPIC_WEIGHTS = {
    TOPIC_BLOCK: 0.5,
    TOPIC_AGGREGATE: 0.5,
    TOPIC_EXIT: 0.05,
    TOPIC_PROPOSER_SLASHING: 0.05,
    TOPIC_ATTESTER_SLASHING: 0.05,
    TOPIC_SYNC_CONTRIBUTION: 0.2,
}


def topic_score_params(topic: str) -> TopicScoreParams:
    name = parse_topic(topic) or topic
    if name.startswith("beacon_attestation"):
        return TopicScoreParams(topic_weight=1.0 / ATTESTATION_SUBNET_COUNT)
    if name.startswith("sync_committee_") and name != TOPIC_SYNC_CONTRIBUTION:
        return TopicScoreParams(topic_weight=1.0 / SYNC_COMMITTEE_SUBNET_COUNT)
    return TopicScoreParams(topic_weight=_TOPIC_WEIGHTS.get(name, 0.05))


def topic_string(fork_digest: bytes, name: str) -> str:
    return f"/eth2/{fork_digest.hex()}/{name}/ssz_snappy"


def parse_topic(topic: str) -> Optional[str]:
    parts = topic.split("/")
    if len(parts) == 5 and parts[1] == "eth2" and parts[4] == "ssz_snappy":
        return parts[3]
    return None


class SeenMessages:
    """Message-id LRU (gossipsub seenCache)."""

    def __init__(self, max_size: int = 8192):
        self.max_size = max_size
        self._seen: "OrderedDict[bytes, None]" = OrderedDict()

    def check_and_add(self, msg_id: bytes) -> bool:
        """True if newly seen."""
        if msg_id in self._seen:
            return False
        self._seen[msg_id] = None
        while len(self._seen) > self.max_size:
            self._seen.popitem(last=False)
        return True

    def __contains__(self, msg_id: bytes) -> bool:
        return msg_id in self._seen


def message_id(topic: str, data: bytes) -> bytes:
    return hashlib.sha256(topic.encode() + b"\x00" + data).digest()[:20]


@dataclass
class _TopicCounters:
    time_in_mesh: float = 0.0            # heartbeats while in our mesh
    first_message_deliveries: float = 0.0
    invalid_message_deliveries: float = 0.0


@dataclass
class _PeerState:
    send_msg: Callable[[str, bytes], Awaitable[None]]
    send_ctrl: Callable[[dict], Awaitable[None]]
    topics: Set[str] = field(default_factory=set)
    counters: Dict[str, _TopicCounters] = field(default_factory=dict)
    behaviour_penalty: float = 0.0
    explicit_subs: bool = False  # has the peer sent any subscription info?

    def topic_counters(self, topic: str) -> _TopicCounters:
        if topic not in self.counters:
            self.counters[topic] = _TopicCounters()
        return self.counters[topic]

    def score(self) -> float:
        s = 0.0
        for topic, c in self.counters.items():
            p = topic_score_params(topic)
            s += p.topic_weight * (
                min(c.time_in_mesh * p.time_in_mesh_weight, MAX_IN_MESH_SCORE)
                + min(c.first_message_deliveries, p.first_message_deliveries_cap)
                * p.first_message_deliveries_weight
                + c.invalid_message_deliveries**2 * p.invalid_message_deliveries_weight
            )
        # behaviour penalty (P7): quadratic above the threshold
        excess = self.behaviour_penalty - 6.0
        if excess > 0:
            s -= excess * excess * 10.0
        return s


def sheddable_topic(name: str) -> bool:
    """Topics whose intake may slow under BLS-pool backpressure: the
    per-subnet storm traffic (unaggregated attestations, sync-committee
    messages).  Blocks, aggregates, contributions, and the rare op-pool
    topics always flow — under overload they are exactly what the node
    must keep validating."""
    return name.startswith("beacon_attestation_") or (
        name.startswith("sync_committee_") and name != TOPIC_SYNC_CONTRIBUTION
    )


class GossipRouter:
    """Scored-mesh pubsub over per-peer send callables.

    ``on_reject``: (peer_key, code) when a peer relays a REJECTed message
    (feeds the RPC score store).  ``on_evict``: (peer_key, score) when a
    peer's gossip score crosses the graylist threshold.

    ``backpressure``: zero-arg callable read per inbound message; while it
    returns True (the BLS pool is above its high-water mark) sheddable
    topics are dropped AT INTAKE — before validation, before the pool —
    so the verification queue stops growing instead of OOMing
    (docs/overload.md §Backpressure).  Dropped intake is counted in
    ``gossip_queue_dropped_total{topic}``; the message is not forwarded
    (it was never validated) and the sender is not penalized."""

    def __init__(
        self,
        on_reject: Optional[Callable[[str, str], None]] = None,
        on_evict: Optional[Callable[[str, float], None]] = None,
        heartbeat_interval: float = HEARTBEAT_INTERVAL,
        metrics=None,
        backpressure: Optional[Callable[[], bool]] = None,
    ):
        self.metrics = metrics
        self.subscriptions: Dict[str, Callable[[bytes], Awaitable[None]]] = {}
        self.seen = SeenMessages()
        self.peers: Dict[str, _PeerState] = {}
        self.mesh: Dict[str, Set[str]] = {}
        self.on_reject = on_reject
        self.on_evict = on_evict
        self.backpressure = backpressure
        self.backpressure_dropped = 0
        self.heartbeat_interval = heartbeat_interval
        self._mcache: Dict[bytes, Tuple[str, bytes]] = {}
        self._mcache_windows: deque = deque(maxlen=MCACHE_LEN)
        self._mcache_windows.append([])
        self._iwant_budget: Dict[str, int] = {}
        self._hb_task: Optional[asyncio.Task] = None
        self._rng = random.Random()
        # observability
        self.messages_sent = 0
        self.messages_received = 0
        self.ihave_sent = 0
        self.iwant_received = 0

    # -- peer lifecycle -----------------------------------------------------

    def add_peer(self, key: str, send_msg, send_ctrl) -> None:
        self.peers[key] = _PeerState(send_msg=send_msg, send_ctrl=send_ctrl)

    def remove_peer(self, key: str) -> None:
        self.peers.pop(key, None)
        for members in self.mesh.values():
            members.discard(key)

    async def announce_subscriptions(self, key: str) -> None:
        """Send our full subscription list to a (new) peer."""
        st = self.peers.get(key)
        if st is None:
            return
        try:
            await st.send_ctrl({"sub": sorted(self.subscriptions)})
        except Exception as e:  # noqa: BLE001
            logger.debug("subscription announce to %s failed: %s", key, e)

    # -- pubsub API ----------------------------------------------------------

    def subscribe(self, topic: str, handler: Callable[[bytes], Awaitable[None]]) -> None:
        self.subscriptions[topic] = handler
        self.mesh.setdefault(topic, set())

    def score(self, key: str) -> float:
        st = self.peers.get(key)
        return st.score() if st else 0.0

    def _eligible(self, topic: str, key: str, floor: float) -> bool:
        st = self.peers.get(key)
        if st is None:
            return False
        if st.explicit_subs and topic not in st.topics:
            return False
        return st.score() >= floor

    def _publish_targets(self, topic: str) -> List[str]:
        members = [
            k for k in self.mesh.get(topic, ()) if self._eligible(topic, k, PUBLISH_THRESHOLD)
        ]
        if members:
            return members
        # mesh not yet built (before the first heartbeat): fan out to up to
        # D subscribed-or-unknown peers so young networks still propagate
        cands = [
            k for k in self.peers if self._eligible(topic, k, PUBLISH_THRESHOLD)
        ]
        self._rng.shuffle(cands)
        return cands[:GOSSIP_D]

    async def publish(self, topic: str, ssz_bytes: bytes) -> int:
        mid = message_id(topic, ssz_bytes)
        self.seen.check_and_add(mid)
        self._mcache_put(mid, topic, ssz_bytes)
        n = 0
        for key in self._publish_targets(topic):
            try:
                await self.peers[key].send_msg(topic, ssz_bytes)
                n += 1
            except Exception as e:  # noqa: BLE001
                logger.warning("gossip publish to %s failed: %s", key, e)
        self.messages_sent += n
        return n

    async def on_message(
        self, topic: str, ssz_bytes: bytes, *, forward: bool = True,
        from_peer: Optional[str] = None,
    ) -> None:
        """Inbound message: dedup -> local handler -> forward to mesh.
        IGNORE drops silently; REJECT drops, counts an invalid delivery
        against the sender's topic score AND reports to the RPC store."""
        mid = message_id(topic, ssz_bytes)
        if not self.seen.check_and_add(mid):
            return
        self.messages_received += 1
        self._mcache_put(mid, topic, ssz_bytes)
        if from_peer is not None and from_peer in self.peers:
            self.peers[from_peer].topic_counters(topic).first_message_deliveries += 1
        handler = self.subscriptions.get(topic)
        if handler is None:
            return
        name = parse_topic(topic) or topic
        if (
            self.backpressure is not None
            and sheddable_topic(name)
            and self.backpressure()
        ):
            # overload: shed storm-lane intake before it reaches the
            # validation queue (the pool's high-water mark is the signal)
            self.backpressure_dropped += 1
            if self.metrics:
                self.metrics.gossip_queue_dropped_total.labels(topic=name).inc()
            return
        from ..chain.validation import GossipAction, GossipValidationError

        try:
            await handler(ssz_bytes)
        except GossipValidationError as e:
            logger.debug("gossip %s: %s", topic, e)
            if self.metrics:
                verdict = "reject" if e.action == GossipAction.REJECT else "ignore"
                self.metrics.gossip_validation_total.labels(
                    topic=parse_topic(topic) or topic, verdict=verdict
                ).inc()
            if e.action == GossipAction.REJECT and from_peer:
                if from_peer in self.peers:
                    self.peers[from_peer].topic_counters(topic).invalid_message_deliveries += 1
                    self._maybe_evict(from_peer)
                if self.on_reject:
                    self.on_reject(from_peer, e.code)
            return
        except Exception as e:  # noqa: BLE001
            # a local handler bug or transient state miss is OUR problem —
            # penalizing the relaying peer would let a local fault ban the
            # whole peer set; only REJECT downscores
            logger.warning("gossip handler error on %s: %s", topic, e)
            return
        if self.metrics:
            self.metrics.gossip_validation_total.labels(
                topic=parse_topic(topic) or topic, verdict="accept"
            ).inc()
        if forward:
            for key in self._publish_targets(topic):
                if key == from_peer:
                    continue
                try:
                    await self.peers[key].send_msg(topic, ssz_bytes)
                    self.messages_sent += 1
                except Exception:
                    pass

    # -- control plane -------------------------------------------------------

    async def on_control(self, from_peer: str, ctrl: dict) -> None:
        st = self.peers.get(from_peer)
        if st is None:
            return
        for topic in ctrl.get("sub", []):
            st.topics.add(topic)
            st.explicit_subs = True
        for topic in ctrl.get("unsub", []):
            st.topics.discard(topic)
            st.explicit_subs = True
            self.mesh.get(topic, set()).discard(from_peer)
        prunes = []
        for topic in ctrl.get("graft", []):
            if topic not in self.subscriptions or st.score() < 0:
                prunes.append(topic)
                # grafting while unsubscribed/negative is misbehavior
                st.behaviour_penalty += 0.1
                continue
            self.mesh.setdefault(topic, set()).add(from_peer)
        for topic in ctrl.get("prune", []):
            self.mesh.get(topic, set()).discard(from_peer)
        # IHAVE: ask for unseen ids (bounded per heartbeat), unless the
        # peer is below the gossip threshold
        if st.score() >= GOSSIP_THRESHOLD:
            want = []
            budget = self._iwant_budget.get(from_peer, MAX_IHAVE_LEN)
            for topic, ids in ctrl.get("ihave", []):
                if topic not in self.subscriptions:
                    continue
                for mid in ids:
                    if budget <= 0:
                        break
                    if mid not in self.seen:
                        want.append(mid)
                        budget -= 1
            self._iwant_budget[from_peer] = budget
            if want:
                try:
                    await st.send_ctrl({"iwant": want})
                except Exception:
                    pass
        # IWANT: serve from the message cache
        iwant = ctrl.get("iwant", [])
        if iwant:
            self.iwant_received += len(iwant)
            for mid in iwant[:MAX_IHAVE_LEN]:
                entry = self._mcache.get(bytes(mid))
                if entry is not None:
                    try:
                        await st.send_msg(entry[0], entry[1])
                    except Exception:
                        break
        if prunes:
            try:
                await st.send_ctrl({"prune": prunes})
            except Exception:
                pass

    # -- heartbeat -----------------------------------------------------------

    def start(self) -> None:
        if self._hb_task is None:
            self._hb_task = asyncio.create_task(self._hb_loop())

    def stop(self) -> None:
        if self._hb_task is not None:
            self._hb_task.cancel()
            self._hb_task = None

    async def _hb_loop(self) -> None:
        try:
            while True:
                await asyncio.sleep(self.heartbeat_interval)
                await self.heartbeat()
        except asyncio.CancelledError:
            pass

    async def heartbeat(self) -> None:
        """Mesh maintenance + lazy gossip + score decay (gossipsub v1.1
        heartbeat, gossipsub.ts mesh maintenance)."""
        grafts: Dict[str, List[str]] = {}
        prunes: Dict[str, List[str]] = {}
        for topic in self.subscriptions:
            members = self.mesh.setdefault(topic, set())
            # drop members that went away or turned negative
            for key in list(members):
                if key not in self.peers or self.peers[key].score() < 0:
                    members.discard(key)
                    prunes.setdefault(key, []).append(topic)
            if len(members) < GOSSIP_D_LOW:
                cands = [
                    k
                    for k, st in self.peers.items()
                    if k not in members
                    and topic in st.topics
                    and st.score() >= 0
                ]
                self._rng.shuffle(cands)
                for k in cands[: GOSSIP_D - len(members)]:
                    members.add(k)
                    grafts.setdefault(k, []).append(topic)
            elif len(members) > GOSSIP_D_HIGH:
                ranked = sorted(members, key=lambda k: self.peers[k].score(), reverse=True)
                for k in ranked[GOSSIP_D:]:
                    members.discard(k)
                    prunes.setdefault(k, []).append(topic)
            # time-in-mesh accrual
            for k in members:
                if k in self.peers:
                    self.peers[k].topic_counters(topic).time_in_mesh += 1
        for key, topics in grafts.items():
            try:
                await self.peers[key].send_ctrl({"graft": topics})
            except Exception:
                pass
        for key, topics in prunes.items():
            if key in self.peers:
                try:
                    await self.peers[key].send_ctrl({"prune": topics})
                except Exception:
                    pass
        if self.metrics:
            for topic, members in self.mesh.items():
                self.metrics.gossip_mesh_peers.labels(
                    topic=parse_topic(topic) or topic
                ).set(len(members))
            for st in self.peers.values():
                self.metrics.gossip_peer_score.observe(st.score())
            for key, topics in grafts.items():
                self.metrics.gossip_control_total.labels(kind="graft", dir="out").inc(
                    len(topics)
                )
            for key, topics in prunes.items():
                self.metrics.gossip_control_total.labels(kind="prune", dir="out").inc(
                    len(topics)
                )
        await self._emit_gossip()
        self._decay_scores()
        self._iwant_budget.clear()
        self._mcache_shift()

    async def _emit_gossip(self) -> None:
        """IHAVE advertisements to D_LAZY random non-mesh subscribers."""
        window_ids: Dict[str, List[bytes]] = {}
        for window in list(self._mcache_windows)[-MCACHE_GOSSIP:]:
            for mid in window:
                entry = self._mcache.get(mid)
                if entry is not None:
                    window_ids.setdefault(entry[0], []).append(mid)
        for topic, ids in window_ids.items():
            cands = [
                k
                for k, st in self.peers.items()
                if k not in self.mesh.get(topic, set())
                and topic in st.topics
                and st.score() >= GOSSIP_THRESHOLD
            ]
            self._rng.shuffle(cands)
            n = max(GOSSIP_D_LAZY, int(len(cands) * GOSSIP_FACTOR))
            for k in cands[:n]:
                try:
                    await self.peers[k].send_ctrl({"ihave": [(topic, ids)]})
                    self.ihave_sent += 1
                except Exception:
                    pass

    def _decay_scores(self) -> None:
        for key, st in list(self.peers.items()):
            for topic, c in st.counters.items():
                p = topic_score_params(topic)
                c.first_message_deliveries *= p.first_message_deliveries_decay
                c.invalid_message_deliveries *= p.invalid_message_deliveries_decay
            st.behaviour_penalty *= 0.99
            self._maybe_evict(key)

    def _maybe_evict(self, key: str) -> None:
        st = self.peers.get(key)
        if st is not None and self.on_evict is not None:
            s = st.score()
            if s < GRAYLIST_THRESHOLD:
                self.on_evict(key, s)

    # -- message cache ---------------------------------------------------------

    def _mcache_put(self, mid: bytes, topic: str, data: bytes) -> None:
        if mid not in self._mcache:
            self._mcache[mid] = (topic, data)
            self._mcache_windows[-1].append(mid)

    def _mcache_shift(self) -> None:
        if len(self._mcache_windows) == self._mcache_windows.maxlen:
            for mid in self._mcache_windows[0]:
                self._mcache.pop(mid, None)
        self._mcache_windows.append([])
