"""Range sync: pipelined beaconBlocksByRange towards the best peers' head.

Reference: packages/beacon-node/src/sync/range/range.ts:76 (SyncChain),
chain.ts:85 (EPOCHS_PER_BATCH, BATCH_BUFFER_SIZE download-ahead), batch.ts
(retry with a different peer, downscore on bad batches), sync.ts:16 (the
stalled -> syncing -> synced state machine).

Batches download ahead of the
serial import pipeline (BATCH_BUFFER_SIZE in flight), every batch retries
on a different peer when a download fails or its blocks don't import, and
misbehaving peers are reported to the score store instead of stalling the
whole sync.  Bulk segments remain exactly the >=1000-set workloads the
batched verifier wants (SURVEY §2.6).
"""

from __future__ import annotations

import asyncio
import enum
from typing import List, Optional, Set, Tuple

from ..params import Preset
from ..utils.logger import get_logger

logger = get_logger("range-sync")

EPOCHS_PER_BATCH = 2
BATCH_BUFFER_SIZE = 5  # download-ahead depth (range/chain.ts:85)
MAX_BATCH_DOWNLOAD_ATTEMPTS = 3


class SyncState(str, enum.Enum):
    stalled = "stalled"
    syncing = "syncing"
    synced = "synced"


class RangeSync:
    def __init__(
        self, preset: Preset, chain, peer_manager, metrics=None, report_peer=None
    ):
        self.p = preset
        self.chain = chain
        self.peers = peer_manager
        self.metrics = metrics
        # async callable (peer, action, reason) -> None; wired to
        # Network.report_peer when running in a full node (peers/score.ts)
        self.report_peer = report_peer
        self.state = SyncState.stalled
        self.batch_size = EPOCHS_PER_BATCH * preset.SLOTS_PER_EPOCH

    def _local_head_slot(self) -> int:
        return self.chain.head_state().slot

    def _sync_peers(self) -> List:
        return [p for p in self.peers.connected() if p.status is not None]

    async def _downscore(self, peer, reason: str) -> None:
        peer.penalize(10)
        if self.report_peer is not None:
            try:
                from ..network.peer import PeerAction

                await self.report_peer(peer, PeerAction.MID_TOLERANCE, reason)
            except Exception:  # pragma: no cover - scoring must not break sync
                pass

    async def _download_batch(
        self, start: int, count: int, exclude: Set[str], prefer=None
    ) -> Optional[Tuple[object, List]]:
        """Fetch [start, start+count) from some healthy peer: `prefer`
        first (the round-robin assignment that spreads a window across
        peers), then anyone not in `exclude`; downscores peers whose
        download errors.  Returns (peer, blocks) or None when no peer
        could serve it."""
        tried: Set[str] = set()
        for _ in range(MAX_BATCH_DOWNLOAD_ATTEMPTS):
            candidates = [
                p
                for p in self._sync_peers()
                if p.peer_id not in tried and p.status.head_slot >= start
            ]
            if not candidates:
                return None
            if prefer is not None and any(p.peer_id == prefer.peer_id for p in candidates):
                peer = prefer
                prefer = None
            else:
                fresh = [p for p in candidates if p.peer_id not in exclude]
                pool = fresh or candidates
                peer = max(pool, key=lambda p: p.status.head_slot)
            try:
                blocks = await peer.reqresp.blocks_by_range(start, count)
                return peer, blocks
            except Exception as e:  # noqa: BLE001
                tried.add(peer.peer_id)
                logger.debug("batch download from %s failed: %s", peer.peer_id, e)
                await self._downscore(peer, f"blocks_by_range:{e}")
        return None

    async def run_to_head(self, max_batches: int = 1000) -> int:
        """Sync until the local head reaches the best peer's advertised
        head.  Returns imported block count."""
        imported = 0
        batches_done = 0
        while batches_done < max_batches:
            peers = self._sync_peers()
            if not peers:
                self.state = SyncState.stalled
                return imported
            target = max(p.status.head_slot for p in peers)
            local = self._local_head_slot()
            if local >= target:
                self.state = SyncState.synced
                return imported
            self.state = SyncState.syncing

            # plan a window of download-ahead batches (chain.ts:85): all
            # downloads start concurrently; imports consume them in order
            window: List[Tuple[int, int]] = []
            cursor = local + 1
            while cursor <= target and len(window) < BATCH_BUFFER_SIZE:
                count = min(self.batch_size, target - cursor + 1)
                window.append((cursor, count))
                cursor += count
            # round-robin batch->peer assignment so one "best" peer never
            # serves (and so never gates) the whole window
            ranked = sorted(peers, key=lambda p: -p.status.head_slot)
            tasks = [
                asyncio.create_task(
                    self._download_batch(start, count, set(), prefer=ranked[i % len(ranked)])
                )
                for i, (start, count) in enumerate(window)
            ]

            progressed = False
            failed = False
            empty_servers: List = []
            for (start, count), task in zip(window, tasks):
                result = await task
                attempts = 0
                bad_peers: Set[str] = set()
                while True:
                    if result is None:
                        failed = True
                        break
                    peer, blocks = result
                    if not blocks:
                        # possibly-legitimate empty range (skipped slots);
                        # remember who served it — an ALL-empty window up
                        # to an advertised head is withholding
                        empty_servers.append(peer)
                        break
                    try:
                        import time as _time

                        _bt0 = _time.monotonic()
                        n_ok = await self.chain.process_chain_segment(blocks)
                        imported += n_ok
                        progressed = progressed or n_ok > 0
                        if self.metrics:
                            self.metrics.sync_batches_total.inc()
                            self.metrics.sync_blocks_total.inc(n_ok)
                            self.metrics.sync_batch_seconds.observe(
                                _time.monotonic() - _bt0
                            )
                        break
                    except Exception as e:  # noqa: BLE001
                        # bad batch: downscore the server and retry the
                        # SAME range from a different peer (batch.ts)
                        logger.warning(
                            "segment [%d..%d) from %s failed: %s",
                            start, start + count, peer.peer_id, e,
                        )
                        await self._downscore(peer, f"bad-segment:{e}")
                        bad_peers.add(peer.peer_id)
                        attempts += 1
                        if attempts >= MAX_BATCH_DOWNLOAD_ATTEMPTS:
                            failed = True
                            break
                        result = await self._download_batch(start, count, bad_peers)
                if failed:
                    break
            batches_done += len(window)
            for t in tasks:
                if not t.done():
                    t.cancel()
            if failed and not progressed:
                # nothing moved this round and a batch is unservable:
                # surface stalled instead of spinning
                self.state = SyncState.stalled
                return imported
            if not progressed and self._local_head_slot() < target:
                # a whole window of empty responses below an advertised
                # head means at minimum the head block itself was withheld:
                # suspicious, not success — downscore the
                # serving peers and report stalled
                for peer in empty_servers:
                    from ..network.peer import PeerAction

                    peer.penalize(2)
                    if self.report_peer is not None:
                        try:
                            await self.report_peer(
                                peer, PeerAction.HIGH_TOLERANCE, "empty-window"
                            )
                        except Exception:
                            pass
                self.state = SyncState.stalled
                return imported
            logger.info(
                "range sync: %d blocks imported (head %d / target %d)",
                imported, self._local_head_slot(), target,
            )
        return imported
