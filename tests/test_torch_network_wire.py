"""The port's wire against the JAX package's, byte for byte: the snappy
block and frame codecs, the framed connection's payloads (requests,
response chunks and ends, gossip and gossipsub control records), the
req/resp request bodies, the gossip topic strings, message ids and score
weights, and the attestation and sync subnet services.  Payloads come from
numpy's ``default_rng``: empty, short, compressible, incompressible,
maximal (over one 64 KiB snappy chunk) and truncated ones; a malformed
input must give the same exception type and message in both packages.
Then the cases of ``tests/test_wire_fuzz.py``, ``test_gossip_mesh.py`` and
``test_subnets.py`` run over each package, with every outcome the two can
share held equal.  The tolerance is exact throughout."""

import asyncio
import importlib
import secrets

import numpy as np
import pytest

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
SEED = 19


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def outcome(fn, *args, **kw):
    """A call's result, or the type and message of what it raised."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the comparison is the point
        return ("raised", type(e).__name__, str(e))


def payloads():
    rng = np.random.default_rng(SEED)
    return {
        "empty": b"",
        "one": b"\x00",
        "short": rng.integers(0, 256, 37, dtype=np.uint8).tobytes(),
        "compressible": bytes(rng.integers(0, 4, 5000, dtype=np.uint8)) * 3,
        "incompressible": rng.integers(0, 256, 9000, dtype=np.uint8).tobytes(),
        "runs": b"".join(bytes([int(b)]) * int(n) for b, n in zip(
            rng.integers(0, 256, 300), rng.integers(1, 200, 300))),
        "maximal": rng.integers(0, 8, 65536 + 70_000, dtype=np.uint8).tobytes(),
    }


PAYLOADS = payloads()


def truncations(blob: bytes, n: int = 12):
    rng = np.random.default_rng(len(blob) + SEED)
    cuts = {0, 1, len(blob) // 2, max(0, len(blob) - 1)}
    cuts |= {int(c) for c in rng.integers(0, max(1, len(blob)), n)}
    return sorted(c for c in cuts if c < len(blob))


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_snappy_block_and_frame_codecs_equal_the_jax_packages(name):
    data = PAYLOADS[name]
    j, p = mod("jax", "utils.snappy"), mod("port", "utils.snappy")
    assert p.compress(data) == j.compress(data)
    assert p.frame_compress(data) == j.frame_compress(data)
    assert p.crc32c(data) == j.crc32c(data)
    block, frame = j.compress(data), j.frame_compress(data)
    assert p.uncompress(block) == data
    assert p.frame_uncompress(frame) == data
    # bounded outputs refuse alike
    assert outcome(p.frame_uncompress, frame, max_output=len(data) // 2) == outcome(
        j.frame_uncompress, frame, max_output=len(data) // 2)
    for cut in truncations(frame):
        assert outcome(p.frame_uncompress, frame[:cut]) == outcome(j.frame_uncompress, frame[:cut])
    for cut in truncations(block):
        assert outcome(p.uncompress, block[:cut]) == outcome(j.uncompress, block[:cut])
    # a flipped byte in the body: the checksum (or the decoder) refuses alike
    if len(frame) > 20:
        bad = bytearray(frame)
        bad[len(frame) // 2] ^= 0x5A
        assert outcome(p.frame_uncompress, bytes(bad)) == outcome(j.frame_uncompress, bytes(bad))


def test_uvarints_equal_the_jax_packages():
    j, p = mod("jax", "network.wire"), mod("port", "network.wire")
    rng = np.random.default_rng(SEED)
    values = [0, 1, 127, 128, 255, 300, 2**14, 2**21 - 1, 2**32, 2**63 - 1,
              *map(int, rng.integers(0, 2**62, 40))]
    for v in values:
        enc = j.write_uvarint(v)
        assert p.write_uvarint(v) == enc
        assert p.read_uvarint(enc) == j.read_uvarint(enc) == (v, len(enc))
        for cut in range(len(enc)):
            assert outcome(p.read_uvarint, enc[:cut]) == outcome(j.read_uvarint, enc[:cut])
    too_long = b"\xff" * 11
    assert outcome(p.read_uvarint, too_long) == outcome(j.read_uvarint, too_long)


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_frame_payloads_equal_the_jax_packages(name):
    data = PAYLOADS[name]
    J, P = mod("jax", "network.wire").Wire, mod("port", "network.wire").Wire
    rng = np.random.default_rng(len(data))
    method, req_id = int(rng.integers(0, 6)), int(rng.integers(1, 2**40))
    topic = f"/eth2/{bytes(rng.integers(0, 256, 4, dtype=np.uint8)).hex()}/beacon_block/ssz_snappy"
    cases = [
        ("request", (method, req_id, data), "decode_request"),
        ("response_chunk", (req_id, int(rng.integers(0, 4)), data), "decode_response_chunk"),
        ("response_end", (req_id,), "decode_response_end"),
        ("gossip", (topic, data), "decode_gossip"),
    ]
    for enc, args, dec in cases:
        blob = getattr(J, f"encode_{enc}")(*args)
        assert getattr(P, f"encode_{enc}")(*args) == blob, enc
        assert outcome(getattr(P, dec), blob) == outcome(getattr(J, dec), blob), dec
        for cut in truncations(blob, 6):
            assert outcome(getattr(P, dec), blob[:cut]) == outcome(getattr(J, dec), blob[:cut]), \
                (dec, cut)


def test_gossipsub_control_records_equal_the_jax_packages():
    J, P = mod("jax", "network.wire").Wire, mod("port", "network.wire").Wire
    rng = np.random.default_rng(SEED)

    def ids(n):
        return [bytes(rng.integers(0, 256, 20, dtype=np.uint8)) for _ in range(n)]

    ctrls = [
        {},
        {"sub": ["/eth2/aabbccdd/beacon_block/ssz_snappy"], "graft": ["t1", "t2"],
         "ihave": [("t1", ids(2))], "iwant": ids(1)},
        {"unsub": [f"beacon_attestation_{i}" for i in range(64)], "prune": ["x" * 300],
         "ihave": [(f"t{i}", ids(int(rng.integers(0, 9)))) for i in range(7)], "iwant": ids(40)},
        {"iwant": [b"\x01" * 7, b"\x02" * 25]},  # short and long ids: padded and cut alike
    ]
    for ctrl in ctrls:
        blob = J.encode_gossip_ctrl(ctrl)
        assert P.encode_gossip_ctrl(ctrl) == blob
        assert outcome(P.decode_gossip_ctrl, blob) == outcome(J.decode_gossip_ctrl, blob)
        for cut in truncations(blob, 8):
            assert outcome(P.decode_gossip_ctrl, blob[:cut]) == outcome(J.decode_gossip_ctrl,
                                                                        blob[:cut])
    hostile = [J._enc_topics(["t"] * 5000)[:8], bytes([0x80, 0x80, 0x80, 0x80, 0x01]) + b"\x00" * 4,
               b"\x00" * 4 + bytes([0x81, 0x20]), b"\x00" * 5 + bytes([0xff, 0x80, 0x01])]
    for blob in hostile:
        assert outcome(P.decode_gossip_ctrl, blob) == outcome(J.decode_gossip_ctrl, blob)


def test_reqresp_request_bodies_equal_the_jax_packages():
    """The SSZ bodies req/resp sends (status, ping, metadata, the block
    range and root requests) over seeded values, through each package's
    types, and the chunk codec around them."""
    rng = np.random.default_rng(SEED)
    out = {}
    for pkg in PKGS:
        t = mod(pkg, "types").get_types(mod(pkg, "params").MINIMAL).phase0
        Fields = mod(pkg, "ssz").Fields
        r = np.random.default_rng(SEED)
        status = Fields(fork_digest=bytes(r.integers(0, 256, 4, dtype=np.uint8)),
                        finalized_root=bytes(r.integers(0, 256, 32, dtype=np.uint8)),
                        finalized_epoch=int(r.integers(0, 2**40)),
                        head_root=bytes(r.integers(0, 256, 32, dtype=np.uint8)),
                        head_slot=int(r.integers(0, 2**40)))
        rng_req = Fields(start_slot=int(r.integers(0, 2**30)), count=int(r.integers(1, 1024)),
                         step=1)
        blobs = [t.Status.serialize(status), t.BeaconBlocksByRangeRequest.serialize(rng_req)]
        Wire = mod(pkg, "network.wire").Wire
        out[pkg] = blobs + [Wire.encode_response_chunk(7, 0, b) for b in blobs]
        rr = mod(pkg, "network.reqresp")
        out[pkg].append((rr.METHOD_STATUS, rr.METHOD_GOODBYE, rr.METHOD_PING, rr.METHOD_METADATA,
                         rr.METHOD_BLOCKS_BY_RANGE, rr.METHOD_BLOCKS_BY_ROOT,
                         rr.MAX_REQUEST_BLOCKS, sorted(rr.MAX_RESPONSE_CHUNKS.items())))
    assert rng is not None
    assert out["port"] == out["jax"]


def test_gossip_topics_message_ids_and_scores_equal_the_jax_packages():
    j, p = mod("jax", "network.gossip"), mod("port", "network.gossip")
    rng = np.random.default_rng(SEED)
    names = [j.TOPIC_BLOCK, j.TOPIC_AGGREGATE, j.TOPIC_EXIT, j.TOPIC_PROPOSER_SLASHING,
             j.TOPIC_ATTESTER_SLASHING, j.TOPIC_SYNC_CONTRIBUTION,
             *(j.TOPIC_ATTESTATION.format(subnet=s) for s in range(64)),
             *(j.TOPIC_SYNC_COMMITTEE.format(subnet=s) for s in range(4)), "unknown"]
    for name in names:
        digest = bytes(rng.integers(0, 256, 4, dtype=np.uint8))
        topic = j.topic_string(digest, name)
        assert p.topic_string(digest, name) == topic
        assert p.parse_topic(topic) == j.parse_topic(topic) == name
        assert p.topic_score_params(topic).__dict__ == j.topic_score_params(topic).__dict__
        assert p.sheddable_topic(name) == j.sheddable_topic(name)
        for data in (b"", bytes(rng.integers(0, 256, int(rng.integers(1, 600)), dtype=np.uint8))):
            assert p.message_id(topic, data) == j.message_id(topic, data)
    for bad in ("", "/eth2/x/y", "eth2/aa/beacon_block/ssz_snappy", "/eth2/aa/b/ssz"):
        assert p.parse_topic(bad) == j.parse_topic(bad)
    consts = ("GOSSIP_D", "GOSSIP_D_LOW", "GOSSIP_D_HIGH", "GOSSIP_D_LAZY", "GOSSIP_FACTOR",
              "MCACHE_LEN", "MCACHE_GOSSIP", "HEARTBEAT_INTERVAL", "MAX_IHAVE_LEN",
              "GOSSIP_THRESHOLD", "PUBLISH_THRESHOLD", "GRAYLIST_THRESHOLD",
              "ATTESTATION_SUBNET_COUNT", "SYNC_COMMITTEE_SUBNET_COUNT")
    assert {c: getattr(p, c) for c in consts} == {c: getattr(j, c) for c in consts}


def test_subnet_services_equal_the_jax_packages():
    """AttnetsService's long-lived subnets (seeded node ids, validators),
    committee subscriptions and their expiry, SyncnetsService, and the
    metadata they publish, slot by slot."""
    rng = np.random.default_rng(SEED)
    seeds = [bytes(rng.integers(0, 256, 8, dtype=np.uint8)) for _ in range(3)] + [b""]
    validators = [int(v) for v in rng.integers(0, 100_000, 6)]
    subs = [(int(s), int(u)) for s, u in zip(rng.integers(0, 64, 8), rng.integers(1, 400, 8))]
    slots = sorted(int(s) for s in rng.integers(0, 3 * 256 * 8, 40))
    trace = {}
    for pkg in PKGS:
        sn = mod(pkg, "network.subnets")
        preset = mod(pkg, "params").MINIMAL
        rows = []
        for seed in seeds:
            md = sn.MetadataController()
            att = sn.AttnetsService(preset, md, node_seed=seed)
            sync = sn.SyncnetsService(preset, md)
            for v in validators:
                att.add_validator(v)
            for s, until in subs:
                att.add_committee_subscription(s, until_slot=until)
                sync.add_subscription(s % 4, until_slot=until)
            for slot in slots:
                att.on_slot(slot)
                sync.on_slot(slot)
                rows.append((slot, sorted(att.active_subnets()), sorted(sync.active_subnets()),
                             md.seq_number, list(md.attnets), list(md.syncnets),
                             [att.should_process(s) for s in range(64)]))
            rows.append([att._random_subnet_for(v, e) for v in validators for e in (0, 255, 256)])
        trace[pkg] = rows
    assert trace["port"] == trace["jax"]


# -- the cases of tests/test_wire_fuzz.py, test_gossip_mesh.py, test_subnets.py ------


def _cfg(pkg):
    return mod(pkg, "config.chain_config").ChainConfig(
        PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16,
        ALTAIR_FORK_EPOCH=2**64 - 1, BELLATRIX_FORK_EPOCH=2**64 - 1)


def _node(pkg, pool):
    dev = mod(pkg, "node.dev_chain").DevChain(mod(pkg, "params").MINIMAL, _cfg(pkg), 16, pool)
    handlers = mod(pkg, "chain.handlers").GossipHandlers(dev.chain)
    return dev, mod(pkg, "network").Network(mod(pkg, "params").MINIMAL, dev.chain, handlers)


def _pool(pkg):
    return mod(pkg, "chain.bls_pool").BlsBatchPool(
        mod(pkg, "crypto.bls.native_verifier").FastBlsVerifier(), max_buffer_wait=0.005)


def test_malformed_frames_do_not_kill_the_port_node():
    """test_wire_fuzz's first case on the port's node: garbage kinds,
    truncated uvarints, random bodies and an oversized length claim drop
    the sender, and the node still serves a well-behaved peer."""
    write_uvarint = mod("port", "network.wire").write_uvarint

    async def main():
        pool = _pool("port")
        _a, net = _node("port", pool)
        port = await net.listen(0)

        async def blast(frames):
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            for f in frames:
                writer.write(f)
            await writer.drain()
            writer.close()

        await blast([
            bytes([0x77]) + write_uvarint(5) + b"\x01\x02\x03\x04\x05",
            bytes([0x01]) + write_uvarint(3) + b"\xff\xff\xff",
            bytes([0x04]) + write_uvarint(10) + secrets.token_bytes(10),
            bytes([0x02]) + write_uvarint(2) + b"\x00",
        ])
        await asyncio.sleep(0.2)
        await blast([bytes([0x01]) + write_uvarint(1 << 30)])
        await asyncio.sleep(0.2)
        _b, net_b = _node("port", pool)
        peer = await asyncio.wait_for(net_b.connect("127.0.0.1", port), 30)
        assert peer.status is not None
        assert await asyncio.wait_for(peer.reqresp.ping(3), 30) == 3
        await net_b.close()
        await net.close()
        pool.close()

    asyncio.run(main())


def test_reqresp_rate_limiting_equals_the_jax_packages():
    """test_wire_fuzz's quota case: the same requests through each
    package's ``RateTracker`` give the same verdicts."""
    import time

    verdicts = {}
    for pkg in PKGS:
        rr = mod(pkg, "network.reqresp")
        rt, bt = rr.RateTracker(limit=3, window_s=60.0), rr.RateTracker(limit=100, window_s=60.0)
        v = [rt.request_units(1) for _ in range(4)]
        v += [bt.request_units(64), bt.request_units(64), bt.request_units(36)]
        rt2 = rr.RateTracker(limit=1, window_s=0.05)
        v += [rt2.request_units(1), rt2.request_units(1)]
        time.sleep(0.06)  # the window expires and frees the quota
        v.append(rt2.request_units(1))
        verdicts[pkg] = v
    assert verdicts["port"] == verdicts["jax"] == [True, True, True, False, True, False, True,
                                                   True, False, True]


def _cluster(pkg, n, topic="t"):
    """test_gossip_mesh's fully-connected in-process cluster of routers."""
    g, Wire = mod(pkg, "network.gossip"), mod(pkg, "network.wire").Wire
    routers = [g.GossipRouter() for _ in range(n)]
    delivered = [0] * n
    for i, r in enumerate(routers):
        r._rng.seed(SEED + i)  # each router's own mesh-selection stream
        r.sent_msgs = 0

        async def handler(data, _i=i):
            delivered[_i] += 1

        r.subscribe(topic, handler)
    for i, ri in enumerate(routers):
        for j, rj in enumerate(routers):
            if i == j:
                continue

            async def send_msg(t, data, _s=i, _d=rj):
                routers[_s].sent_msgs += 1
                await _d.on_message(t, data, from_peer=f"n{_s}")

            async def send_ctrl(ctrl, _s=i, _d=rj):
                await _d.on_control(f"n{_s}", Wire.decode_gossip_ctrl(Wire.encode_gossip_ctrl(ctrl)))

            ri.add_peer(f"n{j}", send_msg, send_ctrl)
    return routers, delivered


def _mesh_run(pkg):
    g = mod(pkg, "network.gossip")

    async def run():
        n = 16
        routers, delivered = _cluster(pkg, n)
        for i, r in enumerate(routers):
            for j in range(n):
                if j != i:
                    await r.announce_subscriptions(f"n{j}")
        for _ in range(3):
            for r in routers:
                await r.heartbeat()
        degrees = [len(r.mesh["t"]) for r in routers]
        assert all(1 <= d <= g.GOSSIP_D_HIGH for d in degrees)
        for r in routers:
            r.sent_msgs = 0
        await routers[0].publish("t", b"payload-1")
        await asyncio.sleep(0)
        assert delivered[0] == 0 and all(d == 1 for d in delivered[1:]), delivered
        sent = [r.sent_msgs for r in routers]
        assert max(sent) <= g.GOSSIP_D_HIGH
        return degrees, sent, sorted(sorted(r.mesh["t"]) for r in routers)

    return asyncio.run(run())


def test_mesh_bounds_fanout_and_delivers_as_the_jax_router():
    """16 fully-connected routers: the mesh degree within [1, D_HIGH], a
    publish reaching every node once, each node's sends bounded by
    D_HIGH; with each router's random stream seeded alike, the port's
    meshes and sends are the JAX router's."""
    assert _mesh_run("port") == _mesh_run("jax")


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ihave_iwant_recovers_a_missed_message(pkg):
    g, Wire = mod(pkg, "network.gossip"), mod(pkg, "network.wire").Wire

    async def run():
        a, b = g.GossipRouter(), g.GossipRouter()
        log = []

        async def h(data):
            log.append(data)

        async def hb(data):
            log.append(b"b:" + data)

        a.subscribe("t", h)
        b.subscribe("t", hb)

        async def a_send_msg(t, d):
            await b.on_message(t, d, from_peer="a")

        async def a_send_ctrl(c):
            await b.on_control("a", Wire.decode_gossip_ctrl(Wire.encode_gossip_ctrl(c)))

        async def b_send_msg(t, d):
            await a.on_message(t, d, from_peer="b")

        async def b_send_ctrl(c):
            await a.on_control("b", Wire.decode_gossip_ctrl(Wire.encode_gossip_ctrl(c)))

        a.add_peer("b", a_send_msg, a_send_ctrl)
        b.add_peer("a", b_send_msg, b_send_ctrl)
        await a.announce_subscriptions("b")
        await b.announce_subscriptions("a")
        data = b"missed-message"
        a.seen.check_and_add(g.message_id("t", data))
        a._mcache_put(g.message_id("t", data), "t", data)
        a.mesh["t"].clear()
        await a._emit_gossip()
        await asyncio.sleep(0)
        assert any(d == b"b:" + data for d in log), log
        return a.iwant_received, log

    assert asyncio.run(run())[0] >= 1


def _bad_peer_run(pkg):
    g = mod(pkg, "network.gossip")
    v = mod(pkg, "chain.validation")

    async def run():
        evicted, scores = [], []
        r = g.GossipRouter(on_evict=lambda k, s: evicted.append((k, s)))
        topic = "/eth2/00000000/beacon_block/ssz_snappy"

        async def bad_handler(data):
            raise v.GossipValidationError(v.GossipAction.REJECT, "bad")

        async def noop_msg(t, d):
            pass

        async def noop_ctrl(c):
            pass

        r.subscribe(topic, bad_handler)
        r.add_peer("mallory", noop_msg, noop_ctrl)
        await r.on_control("mallory", {"sub": [topic], "graft": [topic]})
        assert "mallory" in r.mesh[topic]
        for i in range(40):
            await r.on_message(topic, b"junk-%d" % i, from_peer="mallory")
            scores.append(r.score("mallory"))
        assert r.score("mallory") < g.GRAYLIST_THRESHOLD
        await r.heartbeat()
        assert "mallory" not in r.mesh[topic]
        assert evicted and evicted[0][0] == "mallory"
        return scores, [k for k, _ in evicted]

    return asyncio.run(run())


def test_bad_peer_pruned_and_evicted_as_by_the_jax_router():
    """A peer relaying REJECTed messages: pruned, then evicted below the
    graylist; its score after each message is the JAX router's."""
    assert _bad_peer_run("port") == _bad_peer_run("jax")


def _graft_run(pkg):
    g = mod(pkg, "network.gossip")

    async def run():
        r = g.GossipRouter()
        sent = []

        async def noop_msg(t, d):
            pass

        async def ctrl_sink(c):
            sent.append(c)

        r.add_peer("p", noop_msg, ctrl_sink)
        await r.on_control("p", {"graft": ["unknown-topic"]})
        assert "unknown-topic" not in r.mesh
        assert any("prune" in c for c in sent)
        return sent

    return asyncio.run(run())


def test_graft_refused_when_not_subscribed_as_by_the_jax_router():
    assert _graft_run("port") == _graft_run("jax")


def test_long_lived_subnets_rotate_and_bump_metadata_on_the_port():
    sn = mod("port", "network.subnets")
    preset = mod("port", "params").MINIMAL
    md = sn.MetadataController()
    svc = sn.AttnetsService(preset, md, node_seed=b"\x01" * 8)
    assert md.seq_number == 0
    svc.add_validator(5)
    assert md.seq_number == 1 and len(svc.active_subnets()) == 1
    first = svc.active_subnets()
    svc.on_slot(10 * preset.SLOTS_PER_EPOCH)
    assert svc.active_subnets() == first
    rotated = False
    for epochs in range(0, 3 * sn.EPOCHS_PER_RANDOM_SUBNET_SUBSCRIPTION, 16):
        svc.on_slot(epochs * preset.SLOTS_PER_EPOCH)
        if svc.active_subnets() != first:
            rotated = True
            break
    assert rotated


def test_committee_and_sync_subscriptions_expire_on_the_port():
    sn = mod("port", "network.subnets")
    preset = mod("port", "params").MINIMAL
    md = sn.MetadataController()
    svc = sn.AttnetsService(preset, md)
    svc.add_committee_subscription(7, until_slot=20)
    assert svc.should_process(7) and md.attnets[7] is True
    seq = md.seq_number
    svc.on_slot(21)
    assert not svc.should_process(7) and md.attnets[7] is False and md.seq_number > seq
    sync = sn.SyncnetsService(preset, md)
    sync.add_subscription(2, until_slot=50)
    assert sync.active_subnets() == {2} and md.syncnets == [False, False, True, False]
    sync.on_slot(51)
    assert sync.active_subnets() == set() and md.syncnets == [False] * 4


def test_port_metadata_served_over_reqresp_to_a_jax_peer():
    """test_subnets' req/resp case across the packages: a JAX node reads
    the port node's metadata (two attnets) over the loopback."""

    async def main():
        pool_p, pool_j = _pool("port"), _pool("jax")
        _a, net_a = _node("port", pool_p)
        _b, net_b = _node("jax", pool_j)
        net_a.attnets.add_committee_subscription(3, until_slot=100)
        net_a.attnets.add_committee_subscription(9, until_slot=100)
        port = await net_a.listen(0)
        peer = await asyncio.wait_for(net_b.connect("127.0.0.1", port), 30)
        md = await asyncio.wait_for(peer.reqresp.metadata(), 30)
        assert md.seq_number == net_a.metadata.seq_number
        assert list(md.attnets)[3] is True and list(md.attnets)[9] is True
        assert sum(md.attnets) == 2
        await net_b.close()
        await net_a.close()
        pool_p.close()
        pool_j.close()

    asyncio.run(main())
