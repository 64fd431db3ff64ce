"""The port's remote signer (``validator/remote_signer.py``) against the
JAX package's, over one in-process web3signer double holding interop keys
0-3: both clients see it up and list the same keys; every signing method
of a remote-signed port ``ValidatorStore`` gives the bytes of a local
port store and of the JAX remote store (phase0 and Altair domains); a
double vote is refused before any request leaves; an unknown index and an
unreachable signer raise as in the JAX client.  Exact bytes throughout;
seconds on one core."""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from lodestar_tpu.config.chain_config import ChainConfig as JaxChainConfig
from lodestar_tpu.crypto.bls.api import interop_secret_key as jax_key
from lodestar_tpu.params import MINIMAL as JAX_MINIMAL
from lodestar_tpu.ssz import Fields as JaxFields
from lodestar_tpu.validator.remote_signer import RemoteSignerClient as JaxClient
from lodestar_tpu.validator.store import ValidatorStore as JaxStore
from lodestar_tpu_torch.config.chain_config import ChainConfig
from lodestar_tpu_torch.crypto.bls.api import interop_secret_key
from lodestar_tpu_torch.params import MINIMAL
from lodestar_tpu_torch.ssz import Fields
from lodestar_tpu_torch.validator.remote_signer import RemoteSignerClient, RemoteSignerError
from lodestar_tpu_torch.validator.slashing_protection import SlashingError
from lodestar_tpu_torch.validator.store import ValidatorStore

KEYS = range(4)


class _MockSigner(BaseHTTPRequestHandler):
    """A web3signer double over interop keys 0-3 (signing in the JAX
    package's key surface, which the port's signatures must equal)."""

    keys = {jax_key(i).to_public_key().to_bytes(): jax_key(i) for i in KEYS}
    sign_requests = 0

    def log_message(self, *a):
        pass

    def _reply(self, code, obj):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("content-type", "application/json")
        self.send_header("content-length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/upcheck":
            return self._reply(200, {"status": "OK"})
        if self.path == "/api/v1/eth2/publicKeys":
            return self._reply(200, ["0x" + k.hex() for k in self.keys])
        return self._reply(404, {"error": "not found"})

    def do_POST(self):
        if not self.path.startswith("/api/v1/eth2/sign/"):
            return self._reply(404, {"error": "not found"})
        type(self).sign_requests += 1
        sk = self.keys.get(bytes.fromhex(self.path.rsplit("/", 1)[1][2:]))
        if sk is None:
            return self._reply(404, {"error": "unknown key"})
        body = json.loads(self.rfile.read(int(self.headers["content-length"])))
        root = bytes.fromhex(body["signingRoot"][2:])
        return self._reply(200, {"signature": "0x" + sk.sign(root).to_bytes().hex()})


@pytest.fixture(scope="module")
def signer():
    srv = HTTPServer(("127.0.0.1", 0), _MockSigner)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _config(cls):
    return cls(PRESET_BASE="minimal", ALTAIR_FORK_EPOCH=1, BELLATRIX_FORK_EPOCH=2**64 - 1)


def _stores(url):
    pubkeys = {i: interop_secret_key(i).to_public_key().to_bytes() for i in KEYS}
    remote = ValidatorStore(MINIMAL, _config(ChainConfig), {},
                            remote_signer=RemoteSignerClient(url), remote_keys=pubkeys)
    local = ValidatorStore(MINIMAL, _config(ChainConfig),
                           {i: interop_secret_key(i) for i in KEYS})
    jax = JaxStore(JAX_MINIMAL, _config(JaxChainConfig), {},
                   remote_signer=JaxClient(url), remote_keys=dict(pubkeys))
    return remote, local, jax


def _signatures(store, F, epoch: int, index: int) -> list:
    """Every signing method of ``store`` at ``epoch`` (bytes)."""
    slot = epoch * 8 + 3
    data = F(slot=slot, index=0, beacon_block_root=b"\x01" * 32,
             source=F(epoch=max(0, epoch - 1), root=b"\x00" * 32),
             target=F(epoch=epoch, root=b"\x02" * 32))
    agg = F(aggregation_bits=[True, False], data=data, signature=b"\xc0" + b"\x00" * 95)
    contribution = F(slot=slot, beacon_block_root=b"\x03" * 32, subcommittee_index=1,
                     aggregation_bits=[True] * 8, signature=b"\xc0" + b"\x00" * 95)
    return [
        store.sign_randao(index, epoch),
        store.sign_attestation(index, data),
        store.sign_selection_proof(index, slot),
        store.sign_aggregate_and_proof(index, F(aggregator_index=index, aggregate=agg,
                                                selection_proof=b"\x11" * 96)),
        store.sign_voluntary_exit(index, epoch).signature,
        store.sign_validator_registration(index, b"\x0f" * 20, 30_000_000, 99).signature,
    ] + ([
        store.sign_sync_committee_message(index, slot, b"\x03" * 32).signature,
        store.sign_sync_selection_proof(index, slot, 1),
        store.sign_contribution_and_proof(index, F(aggregator_index=index,
                                                   contribution=contribution,
                                                   selection_proof=b"\x22" * 96)),
    ] if epoch >= 1 else [])


def test_both_clients_see_the_signer_and_its_keys(signer):
    port, jax = RemoteSignerClient(signer), JaxClient(signer)
    assert port.up_check() and jax.up_check()
    assert port.public_keys() == jax.public_keys()
    assert interop_secret_key(0).to_public_key().to_bytes() in port.public_keys()


@pytest.mark.parametrize("epoch", [0, 1])
def test_remote_signatures_equal_local_and_the_jax_remote_stores(signer, epoch):
    remote, local, jax = _stores(signer)
    got = [bytes(s) for s in _signatures(remote, Fields, epoch, 2)]
    assert got == [bytes(s) for s in _signatures(local, Fields, epoch, 2)]
    assert got == [bytes(s) for s in _signatures(jax, JaxFields, epoch, 2)]
    assert all(len(s) == 96 for s in got)


def test_slashing_protection_gates_before_the_request(signer):
    remote, _, _ = _stores(signer)
    data = Fields(slot=5, index=0, beacon_block_root=b"\x01" * 32,
                  source=Fields(epoch=0, root=b"\x00" * 32),
                  target=Fields(epoch=1, root=b"\x02" * 32))
    remote.sign_attestation(1, data)
    before = _MockSigner.sign_requests
    data.beacon_block_root = b"\x03" * 32
    with pytest.raises(SlashingError):
        remote.sign_attestation(1, data)
    assert _MockSigner.sign_requests == before


def test_unknown_index_and_unreachable_signer_raise(signer):
    remote, _, _ = _stores(signer)
    with pytest.raises(KeyError):
        remote._sign(9, b"\x00" * 32)
    client = RemoteSignerClient("http://127.0.0.1:1")  # nothing listens
    with pytest.raises(RemoteSignerError):
        client.sign(b"\x00" * 48, b"\x00" * 32)
    assert not client.up_check()
    tls = RemoteSignerClient("https://signer.example:9000")
    assert (tls.scheme, tls.host, tls.port) == ("https", "signer.example", 9000)
