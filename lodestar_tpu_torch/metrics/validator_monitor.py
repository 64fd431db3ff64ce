"""ValidatorMonitor: opt-in per-validator duty tracking inside the node.

Reference: packages/beacon-node/src/metrics/validatorMonitor.ts:165 —
operators register the indices they care about; the node then records,
per epoch, whether each one attested (inclusion delay, target/head
correctness), proposed, and fulfilled sync-committee duties, surfacing
hit-rates and timeliness through the metrics registry and epoch
summaries through logs (the reference's registerAttestationInBlock /
registerBeaconBlock / registerSyncAggregateInBlock +
onceEveryEndOfEpoch summary).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, Optional, Sequence, Set

from ..params import Preset
from ..state_transition import compute_epoch_at_slot, compute_start_slot_at_epoch
from ..utils.logger import get_logger

logger = get_logger("validator-monitor")


class _Inclusion:
    __slots__ = ("delay", "target_correct", "head_correct")

    def __init__(self, delay: int, target_correct: bool, head_correct: bool):
        self.delay = delay
        self.target_correct = target_correct
        self.head_correct = head_correct


class ValidatorMonitor:
    def __init__(self, preset: Preset, metrics=None):
        self.p = preset
        self.metrics = metrics
        self.registered: Set[int] = set()
        # epoch -> index -> best (lowest-delay) inclusion record
        self._att_inclusion: Dict[int, Dict[int, _Inclusion]] = defaultdict(dict)
        # epoch -> set of registered proposers who proposed
        self._proposals: Dict[int, Set[int]] = defaultdict(set)
        # epoch -> index -> [hits, duties] for sync-committee participation
        self._sync_duty: Dict[int, Dict[int, list]] = defaultdict(dict)
        self._last_summarized_epoch = -1

    def register_local_validator(self, index: int) -> None:
        self.registered.add(int(index))

    # -- feed (called from BeaconChain on import) ----------------------------

    def on_block(
        self,
        block,
        ctx,
        ancestor_at: Optional[Callable[[int], Optional[bytes]]] = None,
        sync_committee_indices: Optional[Sequence[int]] = None,
    ) -> None:
        """Record proposals by, attestation inclusions of, and
        sync-committee participation by registered validators.

        ``ancestor_at(slot)`` resolves the canonical block root at a slot
        on the imported block's chain — used to judge target/head vote
        correctness (validatorMonitor registerAttestationInBlock's
        correctHead/correctTarget).  ``sync_committee_indices`` is the
        validator index per committee position for the block's period
        (registerSyncAggregateInBlock)."""
        if not self.registered:
            return
        if int(block.proposer_index) in self.registered:
            epoch = compute_epoch_at_slot(self.p, block.slot)
            self._proposals[epoch].add(int(block.proposer_index))
            if self.metrics:
                self.metrics.monitor_proposals_total.inc()
        for att in block.body.attestations:
            data = att.data
            try:
                indices = ctx.get_attesting_indices(data, att.aggregation_bits)
            except Exception:
                continue
            watched = [int(vi) for vi in indices if int(vi) in self.registered]
            if not watched:
                continue
            delay = max(1, int(block.slot) - int(data.slot))
            epoch = data.target.epoch
            target_correct = head_correct = True
            if ancestor_at is not None:
                boundary = ancestor_at(
                    compute_start_slot_at_epoch(self.p, data.target.epoch)
                )
                if boundary is not None:
                    target_correct = bytes(data.target.root) == boundary
                head = ancestor_at(int(data.slot))
                if head is not None:
                    head_correct = bytes(data.beacon_block_root) == head
            rec = _Inclusion(delay, target_correct, head_correct)
            for vi in watched:
                prev = self._att_inclusion[epoch].get(vi)
                if prev is None or delay < prev.delay:
                    self._att_inclusion[epoch][vi] = rec
                    # observe on REPLACEMENT too (ADVICE r5): a later block
                    # carrying a lower-delay inclusion is the record the
                    # dashboards should reflect, not only the first sight
                    if self.metrics:
                        self.metrics.monitor_inclusion_delay.observe(delay)
                        if target_correct:
                            self.metrics.monitor_timely_total.labels(
                                flag="target"
                            ).inc()
                        if head_correct:
                            self.metrics.monitor_timely_total.labels(flag="head").inc()
        if sync_committee_indices and "sync_aggregate" in block.body.keys():
            agg = block.body.sync_aggregate
            epoch = compute_epoch_at_slot(self.p, block.slot)
            for pos, vi in enumerate(sync_committee_indices):
                vi = int(vi)
                if vi not in self.registered:
                    continue
                cell = self._sync_duty[epoch].setdefault(vi, [0, 0])
                cell[1] += 1
                if agg.sync_committee_bits[pos]:
                    cell[0] += 1

    def on_clock_epoch(self, epoch: int) -> None:
        """Summarize the epoch before last (its inclusions are final) —
        the reference's onceEveryEndOfEpoch summary."""
        done = epoch - 2
        if done < 0 or done <= self._last_summarized_epoch:
            return
        self._last_summarized_epoch = done
        summary = self.epoch_summary(done)
        if summary is None:
            return
        logger.info(
            "epoch %d: %d/%d registered attested (avg delay %.2f, "
            "target-correct %d, head-correct %d); sync duties %d/%d",
            done, summary["attested"], summary["registered"],
            summary["avg_inclusion_delay"], summary["target_correct"],
            summary["head_correct"], summary["sync_hits"],
            summary["sync_duties"],
        )
        if self.metrics:
            self.metrics.monitor_attestation_hit_ratio.set(
                summary["attested"] / max(1, summary["registered"])
            )
            if summary["sync_duties"]:
                self.metrics.monitor_sync_committee_hit_ratio.set(
                    summary["sync_hits"] / summary["sync_duties"]
                )
        # prune old epochs
        for store in (self._att_inclusion, self._proposals, self._sync_duty):
            for e in [e for e in store if e < done - 2]:
                del store[e]

    # -- queries -------------------------------------------------------------

    def epoch_summary(self, epoch: int) -> Optional[dict]:
        if not self.registered:
            return None
        inc = self._att_inclusion.get(epoch, {})
        delays = [r.delay for r in inc.values()]
        sync = self._sync_duty.get(epoch, {})
        return {
            "epoch": epoch,
            "registered": len(self.registered),
            "attested": len(inc),
            "missed": sorted(self.registered - set(inc)),
            "avg_inclusion_delay": (sum(delays) / len(delays)) if delays else 0.0,
            "target_correct": sum(1 for r in inc.values() if r.target_correct),
            "head_correct": sum(1 for r in inc.values() if r.head_correct),
            "proposals": sorted(self._proposals.get(epoch, ())),
            "sync_hits": sum(c[0] for c in sync.values()),
            "sync_duties": sum(c[1] for c in sync.values()),
        }
