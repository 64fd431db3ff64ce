"""Light-client server: bootstrap + best-update production per sync period.

Reference: packages/beacon-node/src/chain/lightClient/index.ts:151
(LightClientServer: onImportBlockHead tracks attested/finalized data and
keeps the best LightClientUpdate per sync-committee period, served over
the API; getBootstrap serves header + current committee + proof).

Shape here: the server subscribes to block imports; every altair block
whose sync_aggregate attests its parent yields a candidate update for the
parent's period, scored by participation (isBetterUpdate reduced to the
participation ordering, which dominates in practice).
"""

from __future__ import annotations

from typing import Dict, Optional

from ..params import Preset
from ..ssz import Fields
from ..state_transition import compute_epoch_at_slot
from ..types import get_types
from ..utils.logger import get_logger

logger = get_logger("light-client-server")


def sync_period_at_slot(p: Preset, slot: int) -> int:
    return compute_epoch_at_slot(p, slot) // p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD


def block_to_header(p: Preset, block, body_root: Optional[bytes] = None) -> Fields:
    from ..state_transition.upgrade import block_types

    t = block_types(p, block)
    return Fields(
        slot=block.slot,
        proposer_index=block.proposer_index,
        parent_root=bytes(block.parent_root),
        state_root=bytes(block.state_root),
        body_root=body_root or t.BeaconBlockBody.hash_tree_root(block.body),
    )


class LightClientServer:
    def __init__(self, preset: Preset, chain):
        self.p = preset
        self.chain = chain
        self.t = get_types(preset)
        self.best_update_by_period: Dict[int, object] = {}
        # latest head/finality updates (reference lightClient/index.ts:198
        # onImportBlockHead keeps latestHeadUpdate + finalized variant and
        # emits lightClientOptimisticUpdate / lightClientFinalityUpdate)
        self.latest_optimistic_update = None
        self.latest_finality_update = None
        # parked (attested_block, attested_state, agg, signature_slot) whose
        # finality proof hasn't been materialised yet (see
        # _track_head_updates on why this is lazy)
        self._pending_finality = None
        from .emitter import ChainEvent

        chain.emitter.on(ChainEvent.BLOCK, self._on_block)

    # -- bootstrap (getBootstrap) ---------------------------------------------

    def get_bootstrap(self, block_root: bytes):
        """Header + current sync committee + proof for a trusted root."""
        from ..state_transition.upgrade import state_types

        block = self.chain.get_block_by_root(block_root)
        state = self.chain.get_state_by_block_root(block_root)
        if block is None or state is None:
            return None
        st = state_types(self.p, state).BeaconState
        committee_root, branch = st.get_field_proof(state, "current_sync_committee")
        return Fields(
            header=block_to_header(self.p, block.message),
            current_sync_committee=state.current_sync_committee,
            current_sync_committee_branch=[bytes(b) for b in branch],
        )

    # -- update production (onImportBlock) ------------------------------------

    def _on_block(self, signed_block, block_root: bytes) -> None:
        block = signed_block.message
        body = block.body
        if "sync_aggregate" not in body.keys():
            return
        agg = body.sync_aggregate
        participation = sum(agg.sync_committee_bits)
        if participation == 0:
            return
        attested_root = bytes(block.parent_root)
        attested_block = self.chain.get_block_by_root(attested_root)
        attested_state = self.chain.get_state_by_block_root(attested_root)
        if attested_block is None or attested_state is None:
            return
        self._track_head_updates(block, attested_block, attested_state, agg)
        period = sync_period_at_slot(self.p, attested_block.message.slot)
        # spec is_better_update cascade, computed without building the
        # update: supermajority, then participation below it, then
        # relevance ("relevant" = signed within the attested header's own
        # period, so a store whose next committee is still unknown can
        # verify it — an update attesting the LAST slot of a period is
        # signed by the NEXT period's committee), then finality presence,
        # then participation.  Final tie-break deviates from the spec's
        # older-attested preference (a client-side stability heuristic):
        # a SERVER serves the update ladder, and the fresher attested
        # header carries the freshest finalized header — an early-period
        # update's finality can predate a client's bootstrap entirely
        new_rel = sync_period_at_slot(self.p, block.slot) == period
        # finality-bearing only when the finalized BLOCK is present in the
        # store: _build_update serves an empty finality_branch
        # when it cannot materialize the finalized header, and an
        # empty-branch candidate must not win the is_better_update cascade
        # on the finality tiebreak
        fin_cp = attested_state.finalized_checkpoint
        new_fin = (
            bytes(fin_cp.root) != b"\x00" * 32
            and self.chain.get_block_by_root(bytes(fin_cp.root)) is not None
        )
        cur = self.best_update_by_period.get(period)
        if cur is not None:
            max_bits = len(agg.sync_committee_bits)
            cur_part = sum(cur.sync_aggregate.sync_committee_bits)
            cur_rel = sync_period_at_slot(self.p, cur.signature_slot) == period
            cur_fin = cur.finalized_header.slot != 0 or (
                bytes(cur.finalized_header.state_root) != b"\x00" * 32
            )
            new_sup = participation * 3 >= max_bits * 2
            cur_sup = cur_part * 3 >= max_bits * 2
            if new_sup != cur_sup:
                better = new_sup
            elif not new_sup and participation != cur_part:
                better = participation > cur_part
            elif new_rel != cur_rel:
                better = new_rel
            elif new_fin != cur_fin:
                better = new_fin
            elif participation != cur_part:
                better = participation > cur_part
            else:
                better = attested_block.message.slot > cur.attested_header.slot
            if not better:
                return
        update = self._build_update(attested_block, attested_state, agg,
                                    signature_slot=block.slot)
        if update is not None:
            self.best_update_by_period[period] = update

    def _finality_proof(self, attested_state):
        """(finalized_header, finality_branch) for an attested state, or
        (None, None) when it has no finality — the ONE implementation of
        the Checkpoint generalized-index layout ([htr(epoch)] + the
        finalized_checkpoint state branch) that both the per-period updates
        and the head finality updates serve, mirrored by the client's
        idx = 1 + 2*field_index('finalized_checkpoint') verification."""
        from ..state_transition.upgrade import state_types
        from ..ssz import uint64 as u64t

        fin_cp = attested_state.finalized_checkpoint
        if bytes(fin_cp.root) == b"\x00" * 32:
            return None, None
        fin_block = self.chain.get_block_by_root(bytes(fin_cp.root))
        if fin_block is None:
            return None, None
        st = state_types(self.p, attested_state).BeaconState
        _, state_branch = st.get_field_proof(attested_state, "finalized_checkpoint")
        finality_branch = [u64t.hash_tree_root(fin_cp.epoch)] + [
            bytes(b) for b in state_branch
        ]
        return block_to_header(self.p, fin_block.message), finality_branch

    def _track_head_updates(self, block, attested_block, attested_state, agg) -> None:
        """Maintain latest optimistic + finality updates and emit events
        (reference lightClient/index.ts:198 onImportBlockHead; routes
        lightclient.ts:60 getLightClientOptimisticUpdate /
        getLightClientFinalityUpdate).

        The finality update's merkle proof costs a partial state
        re-merkleization (~300 ms at 250k validators on a fresh state), so
        it is built LAZILY: the candidate block/state are parked and the
        proof is materialised on first demand (REST route or SSE
        subscriber) — block import never pays for it."""
        from .emitter import ChainEvent

        attested_slot = attested_block.message.slot
        participation = sum(agg.sync_committee_bits)
        cur = self.latest_optimistic_update
        # newer attested header wins; same header needs more participation
        if cur is None or attested_slot > cur.attested_header.slot or (
            attested_slot == cur.attested_header.slot
            and participation > sum(cur.sync_aggregate.sync_committee_bits)
        ):
            ou = Fields(
                attested_header=block_to_header(self.p, attested_block.message),
                sync_aggregate=agg,
                signature_slot=block.slot,
            )
            self.latest_optimistic_update = ou
            self.chain.emitter.emit(ChainEvent.LIGHT_CLIENT_OPTIMISTIC_UPDATE, ou)

        if bytes(attested_state.finalized_checkpoint.root) == b"\x00" * 32:
            return
        # participation only competes between SAME-slot candidates — an
        # older update's high participation must not block a newer header
        cur = self.latest_finality_update
        cur_slot = cur.attested_header.slot if cur is not None else -1
        cur_part = -1
        if cur is not None and cur_slot == attested_slot:
            cur_part = sum(cur.sync_aggregate.sync_committee_bits)
        if self._pending_finality is not None:
            pend_block, _, pend_agg, _sig = self._pending_finality
            cur_slot = max(cur_slot, pend_block.message.slot)
            if pend_block.message.slot == attested_slot:
                cur_part = max(cur_part, sum(pend_agg.sync_committee_bits))
        if not (attested_slot > cur_slot
                or (attested_slot == cur_slot and participation > cur_part)):
            return
        self._pending_finality = (attested_block, attested_state, agg, block.slot)
        # only materialise eagerly when someone is listening for the event,
        # and only emit a FRESHLY built update — a failed materialisation
        # (finalized block missing from the store) must not re-emit stale
        # state every import
        if self.chain.emitter.has_listeners(ChainEvent.LIGHT_CLIENT_FINALITY_UPDATE):
            fu = self._materialize_pending()
            if fu is not None:
                self.chain.emitter.emit(ChainEvent.LIGHT_CLIENT_FINALITY_UPDATE, fu)

    def _build_update(self, attested_block, attested_state, sync_aggregate,
                      signature_slot: int = 0):
        from ..state_transition.upgrade import state_types

        st = state_types(self.p, attested_state).BeaconState
        try:
            _, nsc_branch = st.get_field_proof(attested_state, "next_sync_committee")
        except StopIteration:
            return None  # pre-altair attested state: no update possible
        finalized_header, finality_branch = self._finality_proof(attested_state)
        if finality_branch is None:
            finality_branch = []
        empty_header = Fields(
            slot=0, proposer_index=0, parent_root=b"\x00" * 32,
            state_root=b"\x00" * 32, body_root=b"\x00" * 32,
        )
        return Fields(
            attested_header=block_to_header(self.p, attested_block.message),
            next_sync_committee=attested_state.next_sync_committee,
            next_sync_committee_branch=[bytes(b) for b in nsc_branch],
            finalized_header=finalized_header or empty_header,
            finality_branch=finality_branch,
            sync_aggregate=sync_aggregate,
            # spec LightClientUpdate field; clients derive the signing
            # domain from their own fork schedule at this slot (an
            # update-supplied fork version is never trusted)
            signature_slot=signature_slot or (attested_block.message.slot + 1),
        )

    def get_update(self, period: int):
        return self.best_update_by_period.get(period)

    def get_latest_update(self):
        if not self.best_update_by_period:
            return None
        return self.best_update_by_period[max(self.best_update_by_period)]

    def _materialize_pending(self):
        """Build the parked finality update; returns it only when freshly
        built (None on no pending candidate or a missing finalized block)."""
        if self._pending_finality is None:
            return None
        attested_block, attested_state, agg, sig_slot = self._pending_finality
        self._pending_finality = None
        finalized_header, finality_branch = self._finality_proof(attested_state)
        if finalized_header is None:
            return None
        fu = Fields(
            attested_header=block_to_header(self.p, attested_block.message),
            finalized_header=finalized_header,
            finality_branch=finality_branch,
            sync_aggregate=agg,
            signature_slot=sig_slot,
        )
        self.latest_finality_update = fu
        return fu

    def get_finality_update(self):
        self._materialize_pending()
        return self.latest_finality_update

    def get_optimistic_update(self):
        return self.latest_optimistic_update
