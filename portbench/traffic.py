"""The one traffic generator: a node deployment (``configs/<config>.json``)
and an open-loop mix (``traffic/<traffic>.json``) in, a seeded schedule of
verification jobs out.

The deployment gives each gossip topic's rate from the preset numbers
(``topic_table``); the mix gives the offered rate in sets/s.  The block
arrives once a slot; the gossip topics share what is left of the offered
rate in their deployment proportions, as one Poisson stream of arrivals.
Every seed gets the same work at the same instants: each topic's count,
the gossip arrival instants and the blocks' instants are fixed by the
deployment, the mix and the window, and the seed only orders the jobs
over those instants (which topic arrives at which instant) and draws the
keys, committees and roots.

The offered rate is the mix's share of the configuration's knee
(``offered_sets_per_s``), or a rate given outright (the sweep's).

A job is a list of ``SetSpec``: the signing keys (indices into the
interop bank; an aggregate's keys are summed), the 32-byte signing root,
and a ``tamper`` mark.  The tampered jobs are the jobs whose verdict is
False:

- in every window, the middle block: +D on one attestation's signature,
  -D on another's, D a random point of G2.  Each set is then wrong, but
  the pair cancels in an unweighted sum: a verifier that batches without
  random coefficients accepts that block, at bucket 256;
- where the mix has ``tampered_gossip``, the first aggregate job
  (``beacon_aggregate_and_proof``, 3 sets) after each of its ``pairs_at``
  fractions of the window, +D on its selection proof and -D on its
  aggregate: the same cancelling pair, in the gossip batches of the small
  buckets; and the first single attestation after ``single_at``, its
  signature plus E, a second random point: wrong in every sum, so that a
  verifier that accepts a small batch unseen fails too.  Each fails its
  merged batch, whose jobs the pool then verifies one by one, so a mix
  near the knee cannot carry them (``PERF.md``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Tuple

import numpy as np

#: the gossip topics and the port's lane (``SignatureSetPriority`` name)
#: its handler submits on (``chain/validation.py``,
#: ``chain/sync_committee_pools.py``, ``chain/beacon_chain.py``)
LANES = {
    "beacon_attestation": "UNAGGREGATED",
    "beacon_aggregate_and_proof": "AGGREGATE",
    "sync_committee_contribution_and_proof": "AGGREGATE",
    "sync_committee": "SYNC_COMMITTEE",
    "beacon_block": "BLOCK_PROPOSAL",
}
#: topics whose handler stamps a deadline of one slot after intake
DEADLINE_TOPICS = ("beacon_attestation", "sync_committee")
BLOCK = "beacon_block"


@dataclasses.dataclass(frozen=True)
class SetSpec:
    keys: Tuple[int, ...]
    root: bytes
    tamper: int = 0  # +1: the signature plus D; -1: minus D; 2: plus E


@dataclasses.dataclass
class Job:
    index: int
    due: float  # seconds after the window opens
    topic: str
    sets: List[SetSpec]
    #: one compressed signature per set, once signed
    signatures: List[bytes] = dataclasses.field(default_factory=list)

    @property
    def lane(self) -> str:
        return LANES[self.topic]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def committee_size(cfg: dict) -> int:
    per_slot = cfg["active_validators"] // cfg["slots_per_epoch"]
    return per_slot // committees_per_slot(cfg)


def committees_per_slot(cfg: dict) -> int:
    """get_committee_count_per_slot: active validators over slots per
    epoch over TARGET_COMMITTEE_SIZE, between 1 and MAX_COMMITTEES_PER_SLOT."""
    n = cfg["active_validators"] // cfg["slots_per_epoch"] // cfg["target_committee_size"]
    return max(1, min(cfg["max_committees_per_slot"], n))


def topic_table(cfg: dict) -> Dict[str, Dict[str, float]]:
    """Per topic: jobs a second and sets a job, from the deployment."""
    sps = cfg["seconds_per_slot"]
    attesters = cfg["active_validators"] / cfg["slots_per_epoch"]
    sub = cfg["sync_committee_size"] // cfg["sync_committee_subnet_count"]
    return {
        "beacon_attestation": {
            "jobs_per_s": cfg["subscribed_attestation_subnets"]
            / cfg["attestation_subnet_count"] * attesters / sps,
            "sets": 1},
        "beacon_aggregate_and_proof": {
            "jobs_per_s": committees_per_slot(cfg)
            * cfg["target_aggregators_per_committee"] / sps,
            "sets": 3},
        "sync_committee_contribution_and_proof": {
            "jobs_per_s": cfg["sync_committee_subnet_count"]
            * cfg["target_aggregators_per_sync_subcommittee"] / sps,
            "sets": 3},
        "sync_committee": {
            "jobs_per_s": cfg["subscribed_sync_subnets"] * sub / sps,
            "sets": 1},
        BLOCK: {"jobs_per_s": 1.0 / sps, "sets": 3 + cfg["max_attestations_per_block"]},
    }


def deployment_sets_per_s(cfg: dict) -> float:
    return sum(t["jobs_per_s"] * t["sets"] for t in topic_table(cfg).values())


def offered_sets_per_s(cfg: dict, mix: dict) -> float:
    """The mix's offered rate: ``sets_per_s`` where the mix gives one (a
    sweep's rate), else its ``share_of_knee`` of the configuration's
    ``knee_sets_per_s``."""
    if "sets_per_s" in mix:
        return float(mix["sets_per_s"])
    return round(cfg["knee_sets_per_s"] * mix["share_of_knee"], 9)


def gossip_job_counts(cfg: dict, sets_per_s: float, seconds: float) -> Dict[str, int]:
    """Jobs of each gossip topic in a window of ``seconds`` at ``sets_per_s``
    offered in all: the block's sets come first, the rest is shared in the
    deployment's proportions."""
    table = topic_table(cfg)
    block_sets = table[BLOCK]["jobs_per_s"] * table[BLOCK]["sets"]
    gossip = {k: v for k, v in table.items() if k != BLOCK and v["jobs_per_s"] > 0}
    gossip_sets = sum(v["jobs_per_s"] * v["sets"] for v in gossip.values())
    scale = max(0.0, sets_per_s - block_sets) / gossip_sets
    return {k: int(round(v["jobs_per_s"] * scale * seconds)) for k, v in gossip.items()}


def _root(seed: int, *parts) -> bytes:
    h = hashlib.sha256(b"portbench/root")
    h.update(str(seed).encode())
    for p in parts:
        h.update(b"/" + str(p).encode())
    return h.digest()


def _fixed_rng(*parts) -> np.random.Generator:
    """A generator that depends on ``parts`` and not on the run's seed."""
    h = hashlib.sha256(("portbench/fixed/" + "/".join(map(str, parts))).encode())
    return np.random.default_rng(int.from_bytes(h.digest()[:8], "little"))


def _fixed_instants(n: int, seconds: float) -> np.ndarray:
    """n Poisson arrival instants in [0, seconds), the same for every seed:
    n + 1 exponential gaps scaled to sum to ``seconds``."""
    gaps = _fixed_rng("arrivals", n, seconds).exponential(1.0, size=n + 1)
    return np.cumsum(gaps * (seconds / gaps.sum()))[:-1]


class _Keys:
    """The keys of single sets: a seeded permutation of the bank, handed out
    in order, so that no key signs two roots of one slot and the point
    cache sees each key once per bank."""

    def __init__(self, rng: np.random.Generator, bank: int):
        self.order = rng.permutation(bank)
        self.bank = bank
        self.next = 0

    def take(self) -> int:
        k = int(self.order[self.next % self.bank])
        self.next += 1
        return k


def schedule(cfg: dict, mix: dict, seed: int, seconds: float, start_slot: int = 1000
             ) -> List[Job]:
    """The window's jobs, by due time: gossip at the mix's rate, and one
    block a slot; the middle block is tampered, and the gossip the mix's
    ``tampered_gossip`` names (the module's docstring)."""
    rng = np.random.default_rng(seed)
    bank = cfg["validator_keys"]
    keys = _Keys(rng, bank)
    csize = committee_size(cfg)
    sps = cfg["seconds_per_slot"]
    n_comm = committees_per_slot(cfg)
    sub = cfg["sync_committee_size"] // cfg["sync_committee_subnet_count"]
    sync_committee = rng.choice(bank, size=cfg["sync_committee_size"], replace=False)
    att_subnets = rng.choice(cfg["attestation_subnet_count"],
                             size=cfg["subscribed_attestation_subnets"], replace=False)

    def slot_of(t: float) -> int:
        return start_slot + int(t // sps)

    def committee() -> Tuple[int, ...]:
        # every member participates; each aggregate draws its own members,
        # so that no two aggregates of the window share a signature
        return tuple(int(k) for k in rng.choice(bank, size=csize, replace=False))

    sync_order = rng.permutation(sync_committee)
    sync_next = [0]

    def sync_member() -> int:
        # cycled, so that no member signs one slot's root twice
        k = int(sync_order[sync_next[0] % len(sync_order)])
        sync_next[0] += 1
        return k

    sync_agg_order = [rng.permutation(sub) for _ in range(cfg["sync_committee_subnet_count"])]
    sync_aggregators: Dict[Tuple[int, int], int] = {}

    def att_root(slot: int, index: int) -> bytes:
        return _root(seed, "attestation", slot, index)

    jobs: List[Job] = []
    counts = gossip_job_counts(cfg, offered_sets_per_s(cfg, mix), seconds)
    topics = rng.permutation([t for t, n in counts.items() for _ in range(n)])
    for topic, t in zip(topics, _fixed_instants(len(topics), seconds)):
        topic, t = str(topic), float(t)
        slot = slot_of(t)
        j = len(jobs)
        if topic == "beacon_attestation":
            subnet = int(att_subnets[rng.integers(len(att_subnets))])
            sets = [SetSpec((keys.take(),), att_root(slot, subnet))]
        elif topic == "beacon_aggregate_and_proof":
            index = int(rng.integers(n_comm))
            agg = keys.take()
            sets = [SetSpec((agg,), _root(seed, "selection", slot)),
                    SetSpec((agg,), _root(seed, "aggregate_and_proof", j)),
                    SetSpec(committee(), att_root(slot, index))]
        elif topic == "sync_committee_contribution_and_proof":
            sc = int(rng.integers(cfg["sync_committee_subnet_count"]))
            members = tuple(int(k) for k in sync_committee[sc * sub:(sc + 1) * sub])
            # each member of a subcommittee aggregates at most once a slot
            n_agg = sync_aggregators.get((slot, sc), 0)
            sync_aggregators[(slot, sc)] = n_agg + 1
            agg = members[int(sync_agg_order[sc][n_agg % sub])]
            sets = [SetSpec((agg,), _root(seed, "sync_selection", slot, sc)),
                    SetSpec((agg,), _root(seed, "contribution_and_proof", j)),
                    SetSpec(members, _root(seed, "contribution", j))]
        else:  # sync_committee
            sets = [SetSpec((sync_member(),), _root(seed, "sync_block_root", slot))]
        jobs.append(Job(j, t, topic, sets))
    _plant(jobs, seconds, mix.get("tampered_gossip", {}))
    n_blocks = int(seconds // sps) if seconds >= sps else 0
    phase = float(_fixed_rng("block", sps).uniform(0, sps))
    tampered = n_blocks // 2 if n_blocks else None
    for b in range(n_blocks):
        t = phase + b * sps
        slot = slot_of(t)
        proposer = keys.take()
        atts = [SetSpec(committee(), _root(seed, "block_attestation", slot, i))
                for i in range(cfg["max_attestations_per_block"])]
        if b == tampered:
            # both in the block's second half of sets
            half = len(atts) // 2
            i, k = (int(x) for x in rng.choice(np.arange(half, len(atts)), size=2,
                                                 replace=False))
            atts[i] = dataclasses.replace(atts[i], tamper=1)
            atts[k] = dataclasses.replace(atts[k], tamper=-1)
        sets = ([SetSpec((proposer,), _root(seed, "block", slot)),
                 SetSpec((proposer,), _root(seed, "randao", slot // cfg["slots_per_epoch"]))]
                + atts
                + [SetSpec(tuple(int(k) for k in sync_committee),
                           _root(seed, "sync_block_root", slot - 1))])
        jobs.append(Job(len(jobs), t, BLOCK, sets))
    jobs.sort(key=lambda job: job.due)
    for i, job in enumerate(jobs):
        job.index = i
    return jobs


def _plant(jobs: List[Job], seconds: float, plan: dict) -> None:
    """Tamper the first aggregate job after each of ``plan["pairs_at"]``'s
    instants (its first and last set, +D and -D) and the first single
    attestation after ``plan["single_at"]``'s (+E); where none of the
    topic follows an instant, the last before it."""

    def first(topic: str, frac: float):
        free = [job for job in jobs if job.topic == topic
                and not any(s.tamper for s in job.sets)]
        after = [job for job in free if job.due >= frac * seconds]
        return after[0] if after else (free[-1] if free else None)

    for frac in plan.get("pairs_at", ()):
        job = first("beacon_aggregate_and_proof", frac)
        if job is not None:
            job.sets[0] = dataclasses.replace(job.sets[0], tamper=1)
            job.sets[-1] = dataclasses.replace(job.sets[-1], tamper=-1)
    if "single_at" in plan:
        job = first("beacon_attestation", plan["single_at"])
        if job is not None:
            job.sets[0] = dataclasses.replace(job.sets[0], tamper=2)


def tamper_point_seed(seed: int, point: str = "D") -> Tuple[int, bytes]:
    """(the scalar, the root) that make ``point`` = k H(root): D, the
    cancelling pairs' point, or E, the single tampered set's."""
    tag = b"portbench/tamper" + (b"" if point == "D" else point.encode())
    h = hashlib.sha256(tag + str(seed).encode()).digest()
    return int.from_bytes(h, "big") % (2**250) + 1, h
