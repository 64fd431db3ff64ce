"""Peer bookkeeping: connection state, status handshake, RPC score store.

Reference: packages/beacon-node/src/network/peers/peerManager.ts:105
(status handshake on connect, ping/metadata upkeep, goodbye on prune) and
peers/score.ts (PeerRpcScoreStore: decaying score, action weights, the
Healthy/Disconnect/Ban thresholds that let the node shed byzantine peers).
"""

from __future__ import annotations

import asyncio
import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..utils.logger import get_logger

logger = get_logger("peers")


class PeerAction(str, enum.Enum):
    """Score penalties (peers/score.ts PeerAction weights)."""

    FATAL = "fatal"                  # instant ban
    LOW_TOLERANCE = "low"            # -10: ~5 strikes to ban
    MID_TOLERANCE = "mid"            # -5: ~10 strikes to ban
    HIGH_TOLERANCE = "high"          # -1: ~50 strikes to ban


_ACTION_WEIGHT = {
    PeerAction.FATAL: -(10**6),
    PeerAction.LOW_TOLERANCE: -10.0,
    PeerAction.MID_TOLERANCE: -5.0,
    PeerAction.HIGH_TOLERANCE: -1.0,
}

MIN_SCORE = -100.0
MIN_SCORE_BEFORE_DISCONNECT = -20.0
MIN_SCORE_BEFORE_BAN = -50.0
SCORE_HALFLIFE_S = 600.0  # ten-minute half-life (score.ts halfLifeDecay)


class ScoreState(str, enum.Enum):
    HEALTHY = "healthy"
    DISCONNECT = "disconnect"
    BANNED = "banned"


class PeerRpcScoreStore:
    """Decaying per-peer score keyed by a stable peer identity (the remote
    address here — connection-scoped ids would reset the score on
    reconnect, defeating bans).  peers/score.ts reduced to its contract:
    apply_action accumulates weighted penalties, scores decay toward zero
    with a half-life, and the state thresholds gate disconnect/ban."""

    def __init__(self):
        self._scores: Dict[str, float] = {}
        self._last_update: Dict[str, float] = {}

    def _decay(self, key: str, now: float) -> None:
        last = self._last_update.get(key, now)
        dt = max(0.0, now - last)
        if dt > 0 and key in self._scores:
            self._scores[key] *= 0.5 ** (dt / SCORE_HALFLIFE_S)
        self._last_update[key] = now

    def apply_action(self, key: str, action: PeerAction, reason: str = "") -> None:
        now = time.monotonic()
        self._decay(key, now)
        score = self._scores.get(key, 0.0) + _ACTION_WEIGHT[action]
        self._scores[key] = max(MIN_SCORE, score)
        if action != PeerAction.HIGH_TOLERANCE:
            logger.debug("peer %s penalized (%s): %s -> %.1f", key, action.value, reason, self._scores[key])

    def score(self, key: str) -> float:
        self._decay(key, time.monotonic())
        return self._scores.get(key, 0.0)

    def state(self, key: str) -> ScoreState:
        s = self.score(key)
        if s <= MIN_SCORE_BEFORE_BAN:
            return ScoreState.BANNED
        if s <= MIN_SCORE_BEFORE_DISCONNECT:
            return ScoreState.DISCONNECT
        return ScoreState.HEALTHY


@dataclass
class Peer:
    peer_id: str
    reqresp: object  # ReqRespNode
    wire: object  # Wire
    status: Optional[object] = None  # last Status from the peer
    metadata: Optional[object] = None
    score: int = 0
    remote_key: str = ""  # stable identity for the score store (host:port)
    tasks: List[asyncio.Task] = field(default_factory=list)

    def penalize(self, points: int = 1) -> None:
        self.score -= points


class PeerManager:
    def __init__(self, max_peers: int = 55):
        self.max_peers = max_peers
        self.peers: Dict[str, Peer] = {}

    def add(self, peer: Peer) -> None:
        self.peers[peer.peer_id] = peer

    def remove(self, peer_id: str) -> Optional[Peer]:
        return self.peers.pop(peer_id, None)

    def get(self, peer_id: str) -> Optional[Peer]:
        return self.peers.get(peer_id)

    def connected(self) -> List[Peer]:
        return list(self.peers.values())

    def best_peer_for_sync(self) -> Optional[Peer]:
        """Peer with the highest advertised head slot (rangeSync picks its
        target chain from peer statuses — range.ts:76)."""
        best = None
        for p in self.peers.values():
            if p.status is None:
                continue
            if best is None or p.status.head_slot > best.status.head_slot:
                best = p
        return best

    async def handshake(self, peer: Peer, local_status) -> object:
        """Exchange Status on connect (peerManager onConnect flow); stores
        and returns the peer's status."""
        status = await peer.reqresp.status(local_status)
        peer.status = status
        try:
            peer.metadata = await peer.reqresp.metadata()
        except Exception:
            peer.metadata = None
        return status
