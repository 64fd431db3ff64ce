"""LightClient: spec LightClientStore over validated sync-committee updates.

Reference: packages/light-client/src/index.ts:110 with the altair sync
protocol semantics: an update is valid when (1) its sync aggregate has
enough participation, (2) the aggregate signature by the KNOWN sync
committee verifies over the attested header, (3) the merkle branches tie
the next sync committee and finalized header into the attested state
root.  The store additionally keeps the best-seen valid update per spec
(`best_valid_update`) so `force_update` can advance past a period whose
updates never reached finality (forced committee advance —
light-client/src/index.ts:110 subscribes and forces on timeout), and an
optimistic header gated by the safety threshold
(max active participants across the last two periods / 2).

Finality and optimistic updates (the head-following routes,
api/src/beacon/routes/lightclient.ts:60) are processed with the same
validator — they are updates without a next-sync-committee proof.
"""

from __future__ import annotations

import hashlib
from typing import Optional

from ..config.chain_config import ChainConfig
from ..params import DOMAIN_SYNC_COMMITTEE, Preset
from ..ssz import Fields
from ..state_transition import compute_domain, compute_epoch_at_slot
from ..types import get_types
from ..utils.logger import get_logger

logger = get_logger("light-client")


class LightClientError(Exception):
    pass


def _verify_branch(leaf: bytes, branch, index_in_container: int, root: bytes) -> bool:
    """is_valid_merkle_branch over a bottom-up sibling list for a field at
    position `index_in_container` of the (padded) container tree; for the
    finality branch the caller pre-composes the deeper path."""
    h = leaf
    idx = index_in_container
    for sib in branch:
        if idx & 1:
            h = hashlib.sha256(bytes(sib) + h).digest()
        else:
            h = hashlib.sha256(h + bytes(sib)).digest()
        idx //= 2
    return h == root


def _has_sync_committee(update) -> bool:
    try:
        return update.next_sync_committee is not None and bool(
            update.next_sync_committee_branch
        )
    except (AttributeError, KeyError):
        return False


def _has_finality(update) -> bool:
    try:
        fin = update.finalized_header
    except (AttributeError, KeyError):
        return False
    return fin is not None and (
        fin.slot != 0 or bytes(fin.state_root) != b"\x00" * 32
    )


class LightClient:
    def __init__(self, preset: Preset, cfg: ChainConfig, bootstrap,
                 genesis_validators_root: bytes):
        self.p = preset
        self.cfg = cfg
        self.t = get_types(preset)
        self.gvr = genesis_validators_root
        from ..config.fork_config import ForkConfig

        self.fork_config = ForkConfig(cfg)
        self.finalized_header = bootstrap.header
        self.optimistic_header = bootstrap.header
        self.current_sync_committee = bootstrap.current_sync_committee
        self.next_sync_committee = None
        # spec LightClientStore tail: candidate update for forced advance +
        # participation watermarks feeding the optimistic safety threshold
        self.best_valid_update = None
        self.previous_max_active_participants = 0
        self.current_max_active_participants = 0
        # the sync-committee period the watermarks currently describe —
        # rotation is keyed on this so the clock hook (process_slot) and
        # the update path (_apply) rotate at most once per period
        self._participants_period = self._sync_period(bootstrap.header.slot)
        # verify the bootstrap proof against the trusted header state root
        st_alt = self.t.altair
        leaf = st_alt.SyncCommittee.hash_tree_root(bootstrap.current_sync_committee)
        idx = self._field_index("current_sync_committee")
        if not _verify_branch(
            leaf, bootstrap.current_sync_committee_branch, idx,
            bytes(bootstrap.header.state_root),
        ):
            raise LightClientError("invalid bootstrap sync committee proof")

    def _sync_period(self, slot: int) -> int:
        return (
            compute_epoch_at_slot(self.p, slot)
            // self.p.EPOCHS_PER_SYNC_COMMITTEE_PERIOD
        )

    def _field_index(self, name: str) -> int:
        fields = [f for f, _ in self.t.altair.BeaconState.fields]
        return fields.index(name)

    def _rotate_participants(self, period: int) -> None:
        """Roll the previous/current max-participation watermarks forward
        to ``period`` (idempotent; a multi-period gap clears both)."""
        if period <= self._participants_period:
            return
        if period == self._participants_period + 1:
            self.previous_max_active_participants = (
                self.current_max_active_participants
            )
        else:
            self.previous_max_active_participants = 0
        self.current_max_active_participants = 0
        self._participants_period = period

    def process_slot(self, current_slot: int) -> None:
        """Clock-driven per-period hook: rotate the
        participation watermarks when the WALL CLOCK crosses into a new
        sync-committee period — keyed on
        compute_sync_committee_period(current_slot), not only on the
        update path (_apply).  Without this, a store that stops receiving
        period-crossing finalized updates keeps an ancient
        current_max_active_participants and the optimistic safety
        threshold (max of the two watermarks / 2) can hold the head back
        forever.  Drive it once per slot (or per poll) from the follow
        loop."""
        self._rotate_participants(self._sync_period(int(current_slot)))

    # -- validation (spec validate_light_client_update) ------------------------

    def _validate(self, update) -> None:
        agg = update.sync_aggregate
        participation = sum(agg.sync_committee_bits)
        if participation < self.p.MIN_SYNC_COMMITTEE_PARTICIPANTS:
            raise LightClientError("insufficient sync committee participation")
        attested = update.attested_header
        state_root = bytes(attested.state_root)
        st_alt = self.t.altair

        if _has_sync_committee(update):
            nsc_leaf = st_alt.SyncCommittee.hash_tree_root(update.next_sync_committee)
            if not _verify_branch(
                nsc_leaf, update.next_sync_committee_branch,
                self._field_index("next_sync_committee"), state_root,
            ):
                raise LightClientError("invalid next_sync_committee branch")

        if _has_finality(update):
            fin_root = self.t.phase0.BeaconBlockHeader.hash_tree_root(
                update.finalized_header
            )
            # path: root within Checkpoint (index 1), checkpoint in state
            idx = 1 + 2 * self._field_index("finalized_checkpoint")
            if not _verify_branch(fin_root, update.finality_branch, idx, state_root):
                raise LightClientError("invalid finality branch")

        # sync aggregate signature over the attested header under
        # DOMAIN_SYNC_COMMITTEE.  The signing committee is the one of the
        # SIGNATURE slot's period: the store's current committee for a
        # same-period update, the proven next committee for the update
        # that crosses into the following period (spec
        # validate_light_client_update committee selection).  The fork
        # version is derived from OUR fork schedule at the signature slot —
        # trusting an update-supplied fork_version would let a malicious
        # server pick whichever domain it likes
        from ..crypto.bls.api import PublicKey
        from ..state_transition.altair import eth_fast_aggregate_verify

        store_period = self._sync_period(self.finalized_header.slot)
        sig_slot = self._signature_slot(update)
        if sig_slot <= attested.slot:
            raise LightClientError("signature slot not after attested header")
        sig_period = self._sync_period(sig_slot)
        if sig_period == store_period:
            committee = self.current_sync_committee
        elif sig_period == store_period + 1 and self.next_sync_committee is not None:
            committee = self.next_sync_committee
        else:
            raise LightClientError(
                f"update signature period {sig_period} outside known committees"
                f" (store period {store_period})"
            )
        # spec validate_light_client_update: fork version at
        # epoch(max(signature_slot, 1) - 1) — the aggregate is signed with
        # the domain of the slot BEFORE the signature slot, so an update
        # straddling a fork activation must use the pre-fork version
        sig_epoch = compute_epoch_at_slot(self.p, max(sig_slot, 1) - 1)
        fork_version = self.fork_config.get_fork_version(sig_epoch)
        domain = compute_domain(
            self.p, DOMAIN_SYNC_COMMITTEE, fork_version, self.gvr
        )
        signing_root = self.t.phase0.SigningData.hash_tree_root(
            Fields(
                object_root=self.t.phase0.BeaconBlockHeader.hash_tree_root(attested),
                domain=domain,
            )
        )
        pks = [
            PublicKey.from_bytes(bytes(pk))
            for pk, bit in zip(committee.pubkeys, agg.sync_committee_bits)
            if bit
        ]
        if not eth_fast_aggregate_verify(
            pks, signing_root, bytes(agg.sync_committee_signature)
        ):
            raise LightClientError("invalid sync aggregate signature")

    def _signature_slot(self, update) -> int:
        try:
            s = update.signature_slot
            if s:
                return int(s)
        except (AttributeError, KeyError):
            pass
        return update.attested_header.slot + 1

    # -- update ranking (spec is_better_update) --------------------------------

    def _is_better_update(self, new, old) -> bool:
        max_bits = len(new.sync_aggregate.sync_committee_bits)
        new_n = sum(new.sync_aggregate.sync_committee_bits)
        old_n = sum(old.sync_aggregate.sync_committee_bits)
        new_sup = new_n * 3 >= max_bits * 2
        old_sup = old_n * 3 >= max_bits * 2
        if new_sup != old_sup:
            return new_sup
        if not new_sup and new_n != old_n:
            return new_n > old_n
        new_rel = _has_sync_committee(new) and self._sync_period(
            new.attested_header.slot
        ) == self._sync_period(self._signature_slot(new))
        old_rel = _has_sync_committee(old) and self._sync_period(
            old.attested_header.slot
        ) == self._sync_period(self._signature_slot(old))
        if new_rel != old_rel:
            return new_rel
        new_fin = _has_finality(new)
        old_fin = _has_finality(old)
        if new_fin != old_fin:
            return new_fin
        # sync-committee finality: a finalized header in the attested
        # header's own period keeps the committee rotation sound — without
        # this, force_update can adopt a candidate whose finalized header
        # crosses periods and strand the store (spec is_better_update)
        if new_fin:
            new_scf = self._sync_period(new.finalized_header.slot) == self._sync_period(
                new.attested_header.slot
            )
            old_scf = self._sync_period(old.finalized_header.slot) == self._sync_period(
                old.attested_header.slot
            )
            if new_scf != old_scf:
                return new_scf
        if new_n != old_n:
            return new_n > old_n
        if new.attested_header.slot != old.attested_header.slot:
            return new.attested_header.slot < old.attested_header.slot
        return self._signature_slot(new) < self._signature_slot(old)

    # -- update processing (spec process_light_client_update) ------------------

    def process_update(self, update) -> None:
        self._validate(update)
        bits = update.sync_aggregate.sync_committee_bits
        participation = sum(bits)
        max_bits = len(bits)
        self.current_max_active_participants = max(
            self.current_max_active_participants, participation
        )
        # optimistic advance past the safety threshold (spec
        # get_safety_threshold: half the best participation seen across the
        # current + previous periods — a dip below it signals a possible
        # committee split and holds the head back)
        threshold = max(
            self.previous_max_active_participants,
            self.current_max_active_participants,
        ) // 2
        attested = update.attested_header
        if participation > threshold and attested.slot > self.optimistic_header.slot:
            self.optimistic_header = attested

        supermajority = participation * 3 >= max_bits * 2
        fills_committee = (
            self.next_sync_committee is None
            and _has_sync_committee(update)
            and _has_finality(update)
            and self._sync_period(update.finalized_header.slot)
            == self._sync_period(attested.slot)
        )
        if supermajority and (
            (_has_finality(update)
             and update.finalized_header.slot > self.finalized_header.slot)
            or fills_committee
        ):
            self._apply(update)
            self.best_valid_update = None
        elif self.best_valid_update is None or self._is_better_update(
            update, self.best_valid_update
        ):
            self.best_valid_update = update

    def process_finality_update(self, update) -> None:
        """A finality update is an update without a sync-committee proof
        (routes/lightclient.ts:60 getLightClientFinalityUpdate)."""
        if _has_sync_committee(update):
            raise LightClientError("finality update must not carry a committee proof")
        self.process_update(update)

    def process_optimistic_update(self, update) -> None:
        """Head-only update: attested header + aggregate, no proofs
        (routes/lightclient.ts:60 getLightClientOptimisticUpdate)."""
        if _has_sync_committee(update) or _has_finality(update):
            raise LightClientError("optimistic update must carry no proofs")
        self.process_update(update)

    # -- forced committee advance (spec process_..._store_force_update) --------

    def force_update(self, current_slot: int) -> bool:
        """Advance on timeout: when no finalized update arrived for a whole
        UPDATE_TIMEOUT window but a valid candidate exists, adopt it —
        treating its attested header as finalized — so the store's committee
        knowledge doesn't fall more than a period behind the chain
        (light-client/src/index.ts:110 forced advance)."""
        u = self.best_valid_update
        if u is None:
            return False
        if current_slot <= self.finalized_header.slot + self.p.UPDATE_TIMEOUT:
            return False
        update = u
        if not _has_finality(u) or (
            u.finalized_header.slot <= self.finalized_header.slot
        ):
            # no usable finalized header: promote the attested one (spec
            # force update substitutes attested_header)
            update = Fields(**{k: u[k] for k in u.keys()})
            update.finalized_header = u.attested_header
        try:
            self._apply(update)
        except LightClientError:
            # a candidate the store cannot apply (e.g. cross-period
            # finality with no committee) must not wedge the store: drop
            # it so a better one can take the slot
            self.best_valid_update = None
            return False
        self.best_valid_update = None
        logger.info(
            "light client FORCED advance to slot %d (period %d)",
            self.finalized_header.slot,
            self._sync_period(self.finalized_header.slot),
        )
        return True

    # -- application (spec apply_light_client_update) --------------------------

    def _apply(self, update) -> None:
        store_period = self._sync_period(self.finalized_header.slot)
        fin = update.finalized_header
        new_period = self._sync_period(fin.slot)
        if self.next_sync_committee is None:
            if _has_sync_committee(update):
                # committee backfill is only sound within the store's period
                if new_period != store_period:
                    raise LightClientError(
                        "cannot learn next committee from a cross-period update"
                    )
                self.next_sync_committee = update.next_sync_committee
            elif new_period != store_period:
                raise LightClientError("period rotation without known next committee")
        elif new_period == store_period + 1:
            self.current_sync_committee = self.next_sync_committee
            self.next_sync_committee = (
                update.next_sync_committee if _has_sync_committee(update) else None
            )
            # watermark rotation shares the clock hook's idempotent path:
            # if process_slot already rolled this period, don't double-clear
            self._rotate_participants(new_period)
        elif new_period > store_period + 1:
            raise LightClientError("update skips a sync-committee period")
        if fin.slot > self.finalized_header.slot:
            self.finalized_header = fin
            if fin.slot > self.optimistic_header.slot:
                self.optimistic_header = fin
        logger.info(
            "light client advanced: optimistic slot %d, finalized slot %d",
            self.optimistic_header.slot, self.finalized_header.slot,
        )
