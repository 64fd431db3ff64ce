"""ValidatorClient: duty polling + production over the REST API.

Reference: packages/validator/src/validator.ts:60 (orchestrator),
services/block.ts (produce->sign->publish), services/attestation.ts:22
(duties->attestation_data->sign->submit).  The client is clock-agnostic:
`run_slot(slot)` performs the duties for one slot so tests (and a real
timer loop) drive it explicitly.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..api.client import ApiClient
from ..api.serde import from_json, to_json
from ..config.chain_config import ChainConfig
from ..params import Preset
from ..ssz import Fields
from ..state_transition import compute_epoch_at_slot
from ..utils.logger import get_logger
from .store import ValidatorStore

logger = get_logger("validator")


class ValidatorClient:
    def __init__(self, preset: Preset, cfg: ChainConfig, store: ValidatorStore, api: ApiClient,
                 doppelganger_epochs: int = 0,
                 fee_recipient: bytes = b"\x00" * 20,
                 gas_limit: int = 30_000_000,
                 builder_enabled: bool = False):
        self.p = preset
        self.cfg = cfg
        self.store = store
        self.api = api
        # proposer preparation + builder registration config
        # (services/prepareBeaconProposer.ts, --suggestedFeeRecipient flag)
        self.fee_recipient = fee_recipient
        self.gas_limit = gas_limit
        self.builder_enabled = builder_enabled
        # per-pubkey overrides, written by the keymanager
        # feerecipient/gas_limit routes (keymanager routes.ts)
        self.fee_recipient_overrides: Dict[bytes, bytes] = {}
        self.gas_limit_overrides: Dict[bytes, int] = {}
        self._attester_duties: Dict[int, List[dict]] = {}  # epoch -> duties
        self._proposer_duties: Dict[int, List[dict]] = {}
        # doppelganger protection (validator.ts + services/doppelgangerService):
        # observe N full epochs of chain liveness before signing anything;
        # if one of our validators attests during the window, another
        # instance is live with our keys -> refuse to start
        self.doppelganger_epochs = doppelganger_epochs
        self._doppelganger_window: Optional[set] = None
        # optional ChainHeaderTracker (services/chainHeaderTracker.ts):
        # when present, attestations trigger on the head SSE event
        self.header_tracker = None
        self.attested_on_event = 0

    def _fee_recipient_for(self, pubkey: bytes) -> bytes:
        return self.fee_recipient_overrides.get(bytes(pubkey), self.fee_recipient)

    def _gas_limit_for(self, pubkey: bytes) -> int:
        return self.gas_limit_overrides.get(bytes(pubkey), self.gas_limit)

    class DoppelgangerDetected(Exception):
        pass

    async def check_doppelganger(self, current_epoch: int) -> bool:
        """True once EVERY epoch of the observation window has been probed
        clean via the liveness API.  Raises DoppelgangerDetected if any of
        our validators was seen attesting in a probed epoch.

        Window = the immediately-past epoch plus the next
        ``doppelganger_epochs`` epochs; an epoch becomes probe-able only
        after it has completed, so the final window epoch is actually
        queried before the check clears (the reference's
        doppelgangerService semantics)."""
        if self.doppelganger_epochs == 0:
            return True
        if self._doppelganger_window is None:
            self._doppelganger_window = set(
                range(max(0, current_epoch - 1), current_epoch + self.doppelganger_epochs)
            )
        indices = [str(i) for i in self.store.pubkeys]
        for epoch in sorted(self._doppelganger_window):
            if epoch >= current_epoch:
                continue  # not complete yet — probe on a later call
            try:
                resp = await self.api.post(
                    f"/eth/v1/validator/liveness/{epoch}", indices
                )
            except Exception:
                return False  # cannot prove liveness either way: keep waiting
            live = [d for d in resp.get("data", []) if d.get("is_live")]
            if live:
                raise self.DoppelgangerDetected(
                    f"validators {[d['index'] for d in live]} are live elsewhere"
                )
            self._doppelganger_window.discard(epoch)
        return not self._doppelganger_window

    # -- duties (services/attestationDuties.ts / blockDuties.ts) --------------

    async def poll_duties(self, epoch: int) -> None:
        indices = [str(i) for i in self.store.pubkeys]
        att = await self.api.post(f"/eth/v1/validator/duties/attester/{epoch}", indices)
        self._attester_duties[epoch] = att["data"]
        prop = await self.api.get(f"/eth/v1/validator/duties/proposer/{epoch}")
        ours = {str(i) for i in self.store.pubkeys}
        self._proposer_duties[epoch] = [
            d for d in prop["data"] if d["validator_index"] in ours
        ]
        # advertise committee subnets for the polled duties (the
        # AttnetsService feed, services/attestationDuties.ts subscriptions)
        subs = [
            {
                "validator_index": d["validator_index"],
                "committee_index": d["committee_index"],
                "committees_at_slot": d.get("committees_at_slot", 1),
                "slot": d["slot"],
                "is_aggregator": True,
            }
            for d in att["data"]
        ]
        if subs:
            try:
                await self.api.post(
                    "/eth/v1/validator/beacon_committee_subscriptions", subs
                )
            except Exception:  # noqa: BLE001 - advertisement is best-effort
                pass
        # re-send proposer preparations every epoch so the entries survive
        # the node's PROPOSER_PRESERVE_EPOCHS pruning
        # (services/prepareBeaconProposer.ts)
        try:
            await self.prepare_beacon_proposer()
            if self.builder_enabled:
                await self.register_validators()
        except Exception:  # noqa: BLE001 - preparation is best-effort
            pass

    async def prepare_beacon_proposer(self) -> None:
        entries = [
            {
                "validator_index": str(i),
                "fee_recipient": "0x" + self._fee_recipient_for(pk).hex(),
            }
            for i, pk in self.store.pubkeys.items()
        ]
        if entries:
            await self.api.post("/eth/v1/validator/prepare_beacon_proposer", entries)

    async def register_validators(self, timestamp: Optional[int] = None) -> None:
        """Sign + submit builder registrations for every managed validator
        (services/validatorRegistration — DOMAIN_APPLICATION_BUILDER)."""
        import time as _time

        ts = int(timestamp if timestamp is not None else _time.time())
        regs = [
            to_json(
                self.store.sign_validator_registration(
                    i, self._fee_recipient_for(pk), self._gas_limit_for(pk), ts
                )
            )
            for i, pk in self.store.pubkeys.items()
        ]
        if regs:
            await self.api.post("/eth/v1/validator/register_validator", regs)

    # -- block production ------------------------------------------------------

    async def propose_if_due(self, slot: int) -> Optional[bytes]:
        epoch = compute_epoch_at_slot(self.p, slot)
        if epoch not in self._proposer_duties:
            await self.poll_duties(epoch)
        duty = next(
            (d for d in self._proposer_duties[epoch] if int(d["slot"]) == slot), None
        )
        if duty is None:
            return None
        vi = int(duty["validator_index"])
        randao = self.store.sign_randao(vi, epoch)
        # builder path first when enabled (services/block.ts
        # produceBlindedBlock preference), full production as fallback
        blinded = False
        resp = None
        if self.builder_enabled:
            try:
                resp = await self.api.get(
                    f"/eth/v1/validator/blinded_blocks/{slot}?randao_reveal=0x{randao.hex()}"
                )
                blinded = True
            except Exception:  # noqa: BLE001 - builder down -> local block
                resp = None
        if resp is None:
            resp = await self.api.get(
                f"/eth/v2/validator/blocks/{slot}?randao_reveal=0x{randao.hex()}"
            )
        block = from_json(resp["data"])
        sig = self.store.sign_block(vi, block)
        publish_path = "/eth/v1/beacon/blinded_blocks" if blinded else "/eth/v1/beacon/blocks"
        out = await self.api.post(
            publish_path, to_json(Fields(message=block, signature=sig))
        )
        root = bytes.fromhex(out["data"]["root"][2:])
        logger.info("proposed block at slot %d: %s", slot, root.hex()[:12])
        return root

    # -- attestations ----------------------------------------------------------

    async def attest(self, slot: int) -> int:
        epoch = compute_epoch_at_slot(self.p, slot)
        if epoch not in self._attester_duties:
            await self.poll_duties(epoch)
        duties = [d for d in self._attester_duties[epoch] if int(d["slot"]) == slot]
        submitted = 0
        by_committee: Dict[int, List[dict]] = {}
        for d in duties:
            by_committee.setdefault(int(d["committee_index"]), []).append(d)
        for committee_index, ds in by_committee.items():
            resp = await self.api.get(
                f"/eth/v1/validator/attestation_data?slot={slot}&committee_index={committee_index}"
            )
            data = from_json(resp["data"])
            atts = []
            for d in ds:
                vi = int(d["validator_index"])
                sig = self.store.sign_attestation(vi, data)
                bits = [False] * int(d["committee_length"])
                bits[int(d["validator_committee_index"])] = True
                atts.append(to_json(Fields(aggregation_bits=bits, data=data, signature=sig)))
            await self.api.post("/eth/v1/beacon/pool/attestations", atts)
            submitted += len(atts)
        return submitted

    # -- aggregation (services/attestation.ts aggregation phase) ---------------

    async def aggregate(self, slot: int) -> int:
        """2/3-slot duty: for each committee where one of our validators is
        an aggregator, fetch the pool aggregate and publish a signed
        AggregateAndProof."""
        from ..chain.validation import is_aggregator
        from ..types import get_types

        t = get_types(self.p).phase0
        epoch = compute_epoch_at_slot(self.p, slot)
        duties = [d for d in self._attester_duties.get(epoch, []) if int(d["slot"]) == slot]
        submitted = 0
        done_committees = set()
        for d in duties:
            committee_index = int(d["committee_index"])
            if committee_index in done_committees:
                continue
            vi = int(d["validator_index"])
            proof = self.store.sign_selection_proof(vi, slot)
            if not is_aggregator(self.p, int(d["committee_length"]), proof):
                continue
            done_committees.add(committee_index)
            resp = await self.api.get(
                f"/eth/v1/validator/attestation_data?slot={slot}&committee_index={committee_index}"
            )
            data = from_json(resp["data"])
            data_root = t.AttestationData.hash_tree_root(data)
            try:
                agg_resp = await self.api.get(
                    f"/eth/v1/validator/aggregate_attestation?slot={slot}"
                    f"&attestation_data_root=0x{data_root.hex()}"
                )
            except Exception:
                continue  # nothing in the pool for this committee
            aggregate = from_json(agg_resp["data"])
            anp = Fields(
                aggregator_index=vi, aggregate=aggregate, selection_proof=proof
            )
            sig = self.store.sign_aggregate_and_proof(vi, anp)
            await self.api.post(
                "/eth/v1/validator/aggregate_and_proofs",
                [to_json(Fields(message=anp, signature=sig))],
            )
            submitted += 1
        return submitted

    # -- sync-committee duties (services/syncCommittee.ts) ---------------------

    async def sync_committee_duties(self, slot: int) -> int:
        """Sign + submit sync-committee messages over the head root; for
        aggregator validators, fetch the pooled contribution and publish a
        signed ContributionAndProof."""
        from ..chain.sync_committee_pools import is_sync_committee_aggregator

        indices = [str(i) for i in self.store.pubkeys]
        epoch = compute_epoch_at_slot(self.p, slot)
        try:
            duties = (await self.api.post(f"/eth/v1/validator/duties/sync/{epoch}", indices))["data"]
        except Exception:
            return 0  # pre-altair node
        if not duties:
            return 0
        head = await self.api.get("/eth/v1/beacon/headers/head")
        head_root = bytes.fromhex(head["data"]["root"][2:])
        msgs = []
        for d in duties:
            vi = int(d["validator_index"])
            msgs.append(to_json(self.store.sign_sync_committee_message(vi, slot, head_root)))
        await self.api.post("/eth/v1/beacon/pool/sync_committees", msgs)
        submitted = len(msgs)
        # aggregation phase
        done_subs = set()
        for d in duties:
            vi = int(d["validator_index"])
            for sub_s in d["validator_sync_committee_indices"]:
                sub = int(sub_s)
                if sub in done_subs:
                    continue
                proof = self.store.sign_sync_selection_proof(vi, slot, sub)
                if not is_sync_committee_aggregator(self.p, proof):
                    continue
                done_subs.add(sub)
                try:
                    c = await self.api.get(
                        f"/eth/v1/validator/sync_committee_contribution?slot={slot}"
                        f"&subcommittee_index={sub}&beacon_block_root=0x{head_root.hex()}"
                    )
                except Exception:
                    continue
                contribution = from_json(c["data"])
                msg = Fields(
                    aggregator_index=vi, contribution=contribution, selection_proof=proof
                )
                sig = self.store.sign_contribution_and_proof(vi, msg)
                await self.api.post(
                    "/eth/v1/validator/contribution_and_proofs",
                    [to_json(Fields(message=msg, signature=sig))],
                )
        return submitted

    async def run_slot(self, slot: int, head_wait_s: float = 0.0) -> None:
        if self.doppelganger_epochs:
            # no duty signs anything until the observation window clears
            if not await self.check_doppelganger(compute_epoch_at_slot(self.p, slot)):
                logger.info("doppelganger window open — skipping duties for slot %d", slot)
                return
        await self.propose_if_due(slot)
        if self.header_tracker is not None and head_wait_s > 0:
            # attest the moment the slot's block lands (head SSE event)
            # rather than blind at the clock mark; the timeout is the
            # 1/3-slot fallback (chainHeaderTracker.ts semantics)
            on_event = await self.header_tracker.wait_for_slot_head(slot, head_wait_s)
            if on_event:
                self.attested_on_event += 1
        await self.attest(slot)
        await self.aggregate(slot)
        await self.sync_committee_duties(slot)
