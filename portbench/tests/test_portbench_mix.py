"""The mix arithmetic from the preset numbers, and the schedule's work."""

import collections
import os

import pytest

from portbench import traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _cfg(name):
    return traffic.load_json(os.path.join(ROOT, "portbench", "configs", f"{name}.json"))


@pytest.mark.parametrize("name, column", [
    ("mainnet-default-node", {"beacon_attestation": 40.69, "beacon_aggregate_and_proof": 256.0,
                              "sync_committee_contribution_and_proof": 16.0,
                              "sync_committee": 0.0, "beacon_block": 10.92}),
    ("mainnet-all-subnets", {"beacon_attestation": 1302.08, "beacon_aggregate_and_proof": 256.0,
                             "sync_committee_contribution_and_proof": 16.0,
                             "sync_committee": 42.67, "beacon_block": 10.92}),
])
def test_topic_rates_are_the_preset_columns(name, column):
    cfg = _cfg(name)
    assert traffic.committee_size(cfg) == 244
    assert traffic.committees_per_slot(cfg) == 64
    table = traffic.topic_table(cfg)
    got = {k: round(v["jobs_per_s"] * v["sets"], 2) for k, v in table.items()}
    assert got == column
    assert table["beacon_block"]["sets"] == 131


def test_deployment_totals():
    assert round(traffic.deployment_sets_per_s(_cfg("mainnet-default-node")), 1) == 323.6
    assert round(traffic.deployment_sets_per_s(_cfg("mainnet-all-subnets")), 1) == 1627.7


def test_gossip_share_after_the_block():
    cfg = _cfg("mainnet-default-node")
    counts = traffic.gossip_job_counts(cfg, 200.0, 36)
    sets = sum(n * traffic.topic_table(cfg)[k]["sets"] for k, n in counts.items())
    assert abs(sets + 3 * 131 - 200.0 * 36) < 10
    assert "sync_committee" not in counts


def _work(jobs):
    return sorted((j.topic, tuple(len(s.keys) for s in j.sets)) for j in jobs)


def test_every_seed_gets_the_same_work(tiny_config):
    """The same jobs at the same instants, in another order."""
    a = traffic.schedule(tiny_config, {"sets_per_s": 30.0}, 1, 24)
    b = traffic.schedule(tiny_config, {"sets_per_s": 30.0}, 2**31 + 5, 24)
    assert _work(a) == _work(b)
    assert [j.due for j in a] == [j.due for j in b]
    assert [j.topic for j in a] != [j.topic for j in b]
    assert [s.root for j in a for s in j.sets] != [s.root for j in b for s in j.sets]


PLAN = {"pairs_at": [0.2, 0.45, 0.7], "single_at": 0.9}


def test_schedule_shape(tiny_config):
    jobs = traffic.schedule(tiny_config, {"sets_per_s": 30.0, "tampered_gossip": PLAN}, 7, 36)
    assert all(0 <= j.due < 36 for j in jobs)
    assert [j.due for j in jobs] == sorted(j.due for j in jobs)
    blocks = [j for j in jobs if j.topic == "beacon_block"]
    assert len(blocks) == 3
    tampered = [j for j in jobs if any(s.tamper for s in j.sets)]
    marks = [(i, s.tamper) for i, s in enumerate(blocks[1].sets) if s.tamper]
    assert sorted(t for _, t in marks) == [-1, 1]
    assert all(i >= len(blocks[1].sets) // 2 for i, _ in marks)
    # three aggregates with a cancelling pair, one attestation with +E,
    # each the first of its topic after its instant
    pairs = [j for j in tampered if j.topic == "beacon_aggregate_and_proof"]
    singles = [j for j in tampered if j.topic == "beacon_attestation"]
    assert sorted(tampered, key=lambda j: j.due) == sorted(pairs + singles + [blocks[1]],
                                                           key=lambda j: j.due)
    for job, frac in zip(pairs, PLAN["pairs_at"]):
        assert [s.tamper for s in job.sets] == [1, 0, -1]
        assert job == next(j for j in jobs if j.topic == job.topic and j.due >= frac * 36)
    assert len(pairs) == 3 and len(singles) == 1
    assert [s.tamper for s in singles[0].sets] == [2]
    # without a plan, the middle block alone, the rest of the work the same
    plain = traffic.schedule(tiny_config, {"sets_per_s": 30.0}, 7, 36)
    assert [j for j in plain if any(s.tamper for s in j.sets)] == [blocks[1]]
    assert [(j.due, j.topic) for j in plain] == [(j.due, j.topic) for j in jobs]
    later = [j for j in jobs if j.topic == "beacon_attestation"
             and j.due >= PLAN["single_at"] * 36]
    assert singles[0] == (later[0] if later else
                          [j for j in jobs if j.topic == "beacon_attestation"][-1])
    # fresh: no two sets sign the same root with the same keys
    pairs = collections.Counter((s.keys, s.root) for j in jobs for s in j.sets)
    assert max(pairs.values()) == 1
    lanes = {j.topic: j.lane for j in jobs}
    assert lanes["beacon_block"] == "BLOCK_PROPOSAL"
    assert lanes["beacon_attestation"] == "UNAGGREGATED"


@pytest.mark.parametrize("config, mix, rate", [
    ("mainnet-default-node", "slo-default-node", 80.0),
    ("mainnet-all-subnets", "slo-all-subnets", 116.0),
    ("mainnet-default-node", "light-default-node", 25.0),
])
def test_cells_offer_their_share_of_the_knee(config, mix, rate):
    """A cell's rate is its traffic file's share of its configuration's
    knee; a rate given outright (a sweep's) wins."""
    cfg = _cfg(config)
    m = traffic.load_json(os.path.join(ROOT, "portbench", "traffic", f"{mix}.json"))
    assert set(m) - {"tampered_gossip"} == {"loop", "share_of_knee", "why"}
    assert traffic.offered_sets_per_s(cfg, m) == rate
    assert traffic.offered_sets_per_s(cfg, {"sets_per_s": 7.5}) == 7.5
    assert rate < traffic.deployment_sets_per_s(cfg)
