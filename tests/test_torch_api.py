"""The port's REST API against the JAX package's: the same deterministic
``DevChain`` (16 interop validators, Altair at epoch 1, 42 slots, each
package over its own ``FastBlsVerifier`` pool) behind each package's
``RestApiServer``, with the gossip handlers, the light-client server, a
listening ``Network`` and a metrics registry wired as the ``dev`` command
wires them.  Every GET route that needs no validator client gives the
same status and JSON (or SSZ bytes) through each package's ``ApiClient``;
the ``lodestar`` routes that read the pool, the verifier, the journal and
the recorder give the same field names and types (their values are the
process's own); ``/metrics`` carries the JAX names.  The POST routes the
gossip handlers serve (attestations, exits, proposer and attester
slashings) pool the same objects in both.  Exact throughout."""

import asyncio
import importlib
import re

import pytest

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
N = 16
N_SLOTS = 5 * 8 + 2


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


class Served:
    """One package's dev chain behind its REST server, on ``loop``."""

    def __init__(self, pkg: str, loop):
        self.pkg, self.loop = pkg, loop
        p = self.p = mod(pkg, "params").MINIMAL
        self.cfg = mod(pkg, "config.chain_config").ChainConfig(
            PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
            MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N, ALTAIR_FORK_EPOCH=1,
            BELLATRIX_FORK_EPOCH=2**64 - 1)
        self.metrics = mod(pkg, "metrics").create_metrics()
        self.pool = mod(pkg, "chain.bls_pool").BlsBatchPool(
            mod(pkg, "crypto.bls.native_verifier").FastBlsVerifier(), max_buffer_wait=0.005,
            metrics=self.metrics)
        self.dev = mod(pkg, "node.dev_chain").DevChain(p, self.cfg, N, self.pool)
        self.chain = self.dev.chain
        self.handlers = mod(pkg, "chain.handlers").GossipHandlers(self.chain)
        self.lc = mod(pkg, "chain.light_client").LightClientServer(p, self.chain)
        loop.run_until_complete(self.dev.run(N_SLOTS))
        self.net = mod(pkg, "network").Network(p, self.chain, self.handlers, metrics=self.metrics)
        loop.run_until_complete(self.net.listen(0))
        self.rest = mod(pkg, "api").RestApiServer(p, self.chain, network=self.net,
                                                  metrics_registry=self.metrics.reg,
                                                  metrics=self.metrics)
        self.rest.gossip_handlers = self.handlers
        self.rest.light_client_server = self.lc
        port = loop.run_until_complete(self.rest.listen(0))
        self.api = mod(pkg, "api").ApiClient("127.0.0.1", port)

    def get(self, path: str):
        """(status, body) of a GET through the package's own client."""
        err = mod(self.pkg, "api.client").ApiClientError
        try:
            return 200, self.loop.run_until_complete(self.api.get(path))
        except err as e:
            return e.status, e.body

    def post(self, path: str, body):
        err = mod(self.pkg, "api.client").ApiClientError
        try:
            return 200, self.loop.run_until_complete(self.api.post(path, body))
        except err as e:
            return e.status, e.body

    def close(self):
        self.loop.run_until_complete(self.rest.close())
        self.loop.run_until_complete(self.net.close())
        self.pool.close()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The card verifier's case builds ``TorchBlsVerifier``: one intra-op
    thread, as the other program-running files pin it."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def served():
    loop = asyncio.new_event_loop()
    nodes = {pkg: Served(pkg, loop) for pkg in PKGS}
    assert nodes["port"].chain.head_root == nodes["jax"].chain.head_root
    yield nodes
    for node in nodes.values():
        node.close()
    loop.close()


def _boot_root(node) -> str:
    c = node.chain
    return "0x" + c.fork_choice.get_ancestor(c.head_root, node.p.SLOTS_PER_EPOCH + 1).hex()


ROUTES = [
    "/eth/v1/node/health", "/eth/v1/node/version", "/eth/v1/node/syncing",
    "/eth/v1/node/peers", "/eth/v1/node/peers?state=disconnected", "/eth/v1/node/peer_count",
    "/eth/v1/node/peers/nobody",
    "/eth/v1/config/spec", "/eth/v1/config/fork_schedule", "/eth/v1/config/deposit_contract",
    "/eth/v1/beacon/genesis", "/eth/v1/beacon/states/head/finality_checkpoints",
    "/eth/v1/beacon/states/finalized/finality_checkpoints",
    "/eth/v1/beacon/states/head/validators/0", "/eth/v1/beacon/states/head/validators/15",
    "/eth/v1/beacon/states/head/validators/99", "/eth/v1/beacon/headers/head",
    "/eth/v1/beacon/headers/{boot}", "/eth/v1/beacon/headers/0x" + "00" * 32,
    "/eth/v2/beacon/blocks/head", "/eth/v2/beacon/blocks/{boot}",
    "/eth/v2/debug/beacon/states/head",
    "/eth/v1/beacon/light_client/bootstrap/{boot}",
    "/eth/v1/beacon/light_client/updates?start_period=0&count=4",
    "/eth/v1/beacon/light_client/finality_update",
    "/eth/v1/beacon/light_client/optimistic_update",
    "/eth/v1/validator/duties/proposer/5", "/eth/v1/validator/duties/proposer/6",
    "/eth/v1/validator/attestation_data?slot={head}&committee_index=0",
    "/eth/v1/lodestar/profile", "/eth/v1/no/such/route",
]


@pytest.mark.parametrize("route", ROUTES)
def test_get_route_equals_the_jax_route(served, route):
    jax, port = served["jax"], served["port"]
    path = route.format(boot=_boot_root(jax), head=int(jax.chain.head_state().slot))
    got, want = port.get(path), jax.get(path)
    assert got == want
    if not route.startswith(("/eth/v1/lodestar", "/eth/v1/no", "/eth/v1/node/peers/")) \
            and "validators/99" not in route and "0x" + "00" * 32 not in route:
        assert want[0] == 200, want


def test_node_identity_equals_the_jax_route_but_for_the_listening_port(served):
    got, want = served["port"].get("/eth/v1/node/identity"), served["jax"].get(
        "/eth/v1/node/identity")

    def norm(doc):
        return re.sub(r"/tcp/\d+", "/tcp/P", repr(doc))

    assert got[0] == want[0] == 200 and norm(got) == norm(want)


def _shape(x):
    """Field names and types, recursively (the values are the process's)."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return ["list", sorted({repr(_shape(v)) for v in x})]
    return type(x).__name__


@pytest.mark.parametrize("route", ["/eth/v1/lodestar/bls_stages", "/eth/v1/lodestar/health",
                                   "/eth/v1/lodestar/traces", "/eth/v1/lodestar/observatory"])
def test_lodestar_route_has_the_jax_routes_fields(served, route):
    (gs, got), (ws, want) = served["port"].get(route), served["jax"].get(route)
    assert gs == ws
    if route.endswith("observatory"):
        # the JAX ledger counts jax.monitoring events; the port has none
        # (observatory/compile_ledger.py records its builds and captures)
        assert isinstance(want["data"]["compile_ledger"].pop("events_seen"), int)
    assert _shape(got) == _shape(want)
    if route.endswith("bls_stages"):
        d, w = got["data"], want["data"]
        assert d["verifier"] == w["verifier"] == "FastBlsVerifier"
        assert {k: d[k] for k in ("sets_verified", "dispatches", "inflight_peak",
                                  "pipeline_depth", "fused_fallbacks")} == {
            k: w[k] for k in ("sets_verified", "dispatches", "inflight_peak", "pipeline_depth",
                              "fused_fallbacks")}
    if route.endswith("observatory"):
        assert got["data"]["latency_buckets_s"] == want["data"]["latency_buckets_s"]


def test_forensics_route_writes_a_bundle_with_the_jax_manifests_fields(served):
    (gs, got), (ws, want) = (served[p].get("/eth/v1/lodestar/forensics?reason=parity")
                             for p in ("port", "jax"))
    assert gs == ws == 200
    assert "api-parity" in got["data"]["bundle"] and "api-parity" in want["data"]["bundle"]
    assert sorted(got["data"]["manifest"]) == sorted(want["data"]["manifest"])
    assert got["data"]["manifest"]["reason"] == want["data"]["manifest"]["reason"]


def test_metrics_route_carries_the_jax_names(served):
    (gs, got), (ws, want) = served["port"].get("/metrics"), served["jax"].get("/metrics")
    assert gs == ws == 200

    def names(body):
        text = body.decode() if isinstance(body, bytes) else str(body)
        return set(re.findall(r"^# TYPE (\S+) ", text, re.M))

    port_names, jax_names = names(got), names(want)
    assert port_names and port_names <= jax_names
    for family in ("lodestar_peers", "lodestar_gossip_messages_total",
                   "lodestar_gossip_validation_total", "lodestar_gossip_queue_dropped_total",
                   "lodestar_gossip_mesh_peers", "lodestar_gossip_peer_score",
                   "lodestar_gossip_control_total", "lodestar_reqresp_request_seconds",
                   "lodestar_reqresp_errors_total", "lodestar_range_sync_batches_total",
                   "lodestar_range_sync_blocks_total", "lodestar_range_sync_batch_seconds",
                   "lodestar_api_requests_total", "lodestar_api_response_seconds"):
        assert family in port_names, family


def _signed(node, ssz_type, message, domain_type, epoch, key_index):
    st = mod(node.pkg, "state_transition")
    state = node.chain.head_state()
    domain = st.get_domain(node.p, state, domain_type, epoch)
    root = st.compute_signing_root(node.p, ssz_type, message, domain)
    return node.dev.keys[key_index].sign(root).to_bytes()


def _ops(node):
    """A single-bit attestation of the head slot, a voluntary exit, a
    proposer slashing and an attester slashing, signed, as JSON."""
    pkg, p = node.pkg, node.p
    Fields, params = mod(pkg, "ssz").Fields, mod(pkg, "params")
    st = mod(pkg, "state_transition")
    to_json = mod(pkg, "api.serde").to_json
    t0 = mod(pkg, "types").get_types(p).phase0
    state = node.chain.head_state()
    slot = int(state.slot)
    epoch = st.compute_epoch_at_slot(p, slot)
    ctx = st.EpochContext.create_from_state(p, state)
    committee = [int(v) for v in ctx.get_beacon_committee(slot, 0)]
    boundary = st.compute_start_slot_at_epoch(p, epoch)
    target = node.chain.head_root if boundary >= slot else bytes(
        state.block_roots[boundary % p.SLOTS_PER_HISTORICAL_ROOT])
    data = Fields(slot=slot, index=0, beacon_block_root=node.chain.head_root,
                  source=state.current_justified_checkpoint,
                  target=Fields(epoch=epoch, root=target))
    att = Fields(aggregation_bits=[i == 0 for i in range(len(committee))], data=data,
                 signature=_signed(node, t0.AttestationData, data, params.DOMAIN_BEACON_ATTESTER,
                                   epoch, committee[0]))
    exit_msg = Fields(epoch=0, validator_index=5)
    exit_ = Fields(message=exit_msg, signature=_signed(node, t0.VoluntaryExit, exit_msg,
                                                       params.DOMAIN_VOLUNTARY_EXIT, epoch, 5))

    def header(body_byte):
        h = Fields(slot=3, proposer_index=7, parent_root=b"\x01" * 32, state_root=b"\x02" * 32,
                   body_root=bytes([body_byte]) * 32)
        return Fields(message=h, signature=_signed(node, t0.BeaconBlockHeader, h,
                                                   params.DOMAIN_BEACON_PROPOSER, 0, 7))

    proposer_slashing = Fields(signed_header_1=header(3), signed_header_2=header(4))

    def indexed(root_byte):
        d = Fields(slot=2, index=0, beacon_block_root=bytes([root_byte]) * 32,
                   source=Fields(epoch=0, root=b"\x00" * 32),
                   target=Fields(epoch=0, root=b"\x05" * 32))
        return Fields(attesting_indices=[9], data=d,
                      signature=_signed(node, t0.AttestationData, d,
                                        params.DOMAIN_BEACON_ATTESTER, 0, 9))

    attester_slashing = Fields(attestation_1=indexed(6), attestation_2=indexed(7))
    return dict(att=to_json(att), exit=to_json(exit_), ps=to_json(proposer_slashing),
                asl=to_json(attester_slashing)), committee[0]


def test_post_routes_pool_what_the_jax_routes_pool(served):
    out = {}
    for pkg in ("jax", "port"):
        node = served[pkg]
        ops, attester = _ops(node)
        slot = int(node.chain.head_state().slot)
        node.dev.clock.set_slot(slot)
        before = sum(len(g.bits_and_sigs)
                     for g in node.chain.att_pool._by_slot.get(slot, {}).values())
        t = mod(pkg, "types").get_types(node.p).phase0
        responses = [node.post("/eth/v1/beacon/pool/attestations", [ops["att"]]),
                     node.post("/eth/v1/beacon/pool/attestations", [ops["att"]]),  # a repeat
                     node.post("/eth/v1/beacon/pool/voluntary_exits", ops["exit"]),
                     node.post("/eth/v1/beacon/pool/proposer_slashings", ops["ps"]),
                     node.post("/eth/v1/beacon/pool/attester_slashings", ops["asl"])]
        pool = node.chain.op_pool
        out[pkg] = dict(
            ops=ops, attester=attester, responses=[(s, repr(b)) for s, b in responses],
            pooled=sum(len(g.bits_and_sigs)
                       for g in node.chain.att_pool._by_slot.get(slot, {}).values()) - before,
            exits=sorted(pool.voluntary_exits),
            proposer_slashings=sorted(pool.proposer_slashings),
            attester_slashings=sorted(pool.attester_slashings),
            roots=[t.AttesterSlashing.hash_tree_root(s) for s in pool.attester_slashings.values()])
    assert out["port"] == out["jax"]
    assert out["port"]["pooled"] == 1
    assert out["port"]["responses"][0][0] == 200 and out["port"]["responses"][1][0] == 400
    assert out["port"]["exits"] == [5] and out["port"]["proposer_slashings"] == [7]


def test_lodestar_routes_read_the_card_verifiers_own_counters():
    """Over a pool on ``TorchBlsVerifier`` (here on the CPU) every field of
    ``bls_stages`` that the JAX route reads by ``getattr`` with a default
    is a real attribute of the port's verifier (none reports a default
    0), and ``health`` adds the verifier's executors; the field names are
    the JAX route's over a JAX pool of the same kind."""
    import numpy as np

    from lodestar_tpu_torch.api.rest import RestApiServer
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.params import MINIMAL

    verifier = TorchBlsVerifier(device="cpu", buckets=(4,), rng=np.random.default_rng(1))
    pool = BlsBatchPool(verifier)

    class Chain:
        bls = pool

    rest = RestApiServer(MINIMAL, Chain())
    stages = rest._bls_stages({}, {}, b"")["data"]
    for field in ("stage_seconds", "dispatches", "sets_verified", "padding_wasted",
                  "host_final_exps", "n_devices", "pack_cache_hits", "pack_cache_misses",
                  "pack_rejected"):
        assert hasattr(verifier, field), field
    assert stages["verifier"] == "TorchBlsVerifier"
    assert set(stages["stage_seconds"]) == set(verifier.stage_seconds)
    assert stages["device_inflight"] == verifier.device_inflight()
    assert stages["fused_fallbacks"] == 0  # no degrade ladder in the port
    rest._health = lambda pp, q, b: {}  # no head state behind the stub chain
    health = rest._lodestar_health({}, {}, b"")[1]["data"]
    assert health["executors"] == verifier.executor_health()
    assert [h["state"] for h in health["executors"].values()] == ["healthy"]
    pool.close()
    verifier.close()
