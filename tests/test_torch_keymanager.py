"""The port's keymanager API (``validator/keymanager.py``) against the JAX
package's: one sequence of HTTP requests (bearer auth refused and given,
keystore list / import with a slashing-protection interchange / duplicate
/ wrong password / delete, the remotekeys namespace, per-key fee
recipient and gas limit, an unknown route, bad JSON) sent to a
``KeymanagerServer`` of each package over identical stores gives the same
status codes and JSON, exactly; the imported history protects at once and
the placeholder indices of not-yet-active keys never collide.  Seconds on
one core (pbkdf2 keystores)."""

import asyncio
import importlib
import json

import pytest

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
TOKEN = "s3cret"


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


class FakeClient:
    """The validator client's fee-recipient and gas-limit defaults."""

    def __init__(self):
        self.fee_recipient = b"\xaa" * 20
        self.gas_limit = 25_000_000
        self.fee_recipient_overrides = {}
        self.gas_limit_overrides = {}


def _api(pkg: str, indices=(0, 1), remote=True):
    chain_config, bls = mod(pkg, "config.chain_config"), mod(pkg, "crypto.bls.api")
    validator = mod(pkg, "validator")
    cfg = chain_config.ChainConfig(PRESET_BASE="minimal", MIN_GENESIS_TIME=0,
                                   SHARD_COMMITTEE_PERIOD=0,
                                   MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16)
    protection = validator.SlashingProtection()
    store = validator.ValidatorStore(mod(pkg, "params").MINIMAL, cfg,
                                     {i: bls.interop_secret_key(i) for i in indices}, protection)
    if remote:
        store.remote_signer = mod(pkg, "validator.remote_signer").RemoteSignerClient(
            "http://127.0.0.1:9999")
    client = FakeClient()
    api = mod(pkg, "validator.keymanager").KeymanagerApi(store, protection, client=client)
    return api, store, protection, client


async def _request(port: int, method: str, path: str, body=None, auth=True, raw=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = raw if raw is not None else (json.dumps(body).encode() if body is not None else b"")
    head = f"{method} {path} HTTP/1.1\r\nhost: x\r\ncontent-length: {len(data)}\r\n"
    if auth:
        head += f"authorization: Bearer {TOKEN}\r\n"
    writer.write(head.encode() + b"\r\n" + data)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    while (await reader.readline()) not in (b"\r\n", b"\n", b""):
        pass
    payload = json.loads(await reader.read())
    writer.close()
    if isinstance(payload, dict) and "slashing_protection" in payload:
        payload["slashing_protection"] = json.loads(payload["slashing_protection"])
    return status, payload


def _sequence(keystore: dict, interchange: str, pk7: str, pk2: str, pk0: str):
    fee, gas = f"/eth/v1/validator/{pk0}/feerecipient", f"/eth/v1/validator/{pk0}/gas_limit"
    return [
        ("GET", "/eth/v1/keystores", None, False, None),
        ("GET", "/eth/v1/keystores", None, True, None),
        ("POST", "/eth/v1/keystores", {"keystores": [json.dumps(keystore)], "passwords": ["pw"],
                                       "slashing_protection": interchange}, True, None),
        ("POST", "/eth/v1/keystores", {"keystores": [json.dumps(keystore)],
                                       "passwords": ["pw"]}, True, None),
        ("POST", "/eth/v1/keystores", {"keystores": [json.dumps(keystore)],
                                       "passwords": ["nope"]}, True, None),
        ("GET", "/eth/v1/keystores", None, True, None),
        ("DELETE", "/eth/v1/keystores", {"pubkeys": [pk7]}, True, None),
        ("DELETE", "/eth/v1/keystores", {"pubkeys": [pk7]}, True, None),
        ("POST", "/eth/v1/remotekeys", {"remote_keys": [{"pubkey": pk2,
                                                          "url": "http://127.0.0.1:9999"}]},
         True, None),
        ("POST", "/eth/v1/remotekeys", {"remote_keys": [{"pubkey": pk2}]}, True, None),
        ("GET", "/eth/v1/remotekeys", None, True, None),
        ("DELETE", "/eth/v1/remotekeys", {"pubkeys": [pk2]}, True, None),
        ("DELETE", "/eth/v1/remotekeys", {"pubkeys": [pk0]}, True, None),
        ("GET", fee, None, True, None),
        ("POST", fee, {"ethaddress": "0x" + "bb" * 20}, True, None),
        ("GET", fee, None, True, None),
        ("DELETE", fee, None, True, None),
        ("GET", fee, None, True, None),
        ("GET", gas, None, True, None),
        ("POST", gas, {"gas_limit": "31000000"}, True, None),
        ("GET", gas, None, True, None),
        ("DELETE", gas, None, True, None),
        ("GET", "/eth/v1/nothing", None, True, None),
        ("POST", "/eth/v1/keystores", None, True, b"{not json"),
    ]


def test_the_same_http_sequence_gives_the_jax_servers_json():
    jax_bls = mod("jax", "crypto.bls.api")
    sk7 = jax_bls.interop_secret_key(7)
    pk7 = sk7.to_public_key().to_bytes()
    keystore = mod("jax", "validator.keystore").create_keystore(sk7.to_bytes(), "pw", kdf="pbkdf2")
    prior = mod("jax", "validator").SlashingProtection()
    prior.check_and_insert_attestation(pk7, 3, 4, b"\xaa" * 32)
    interchange = json.dumps(prior.export_interchange())
    pk = lambda i: "0x" + jax_bls.interop_secret_key(i).to_public_key().to_bytes().hex()  # noqa: E731

    async def run(pkg):
        api, store, protection, client = _api(pkg)
        server = mod(pkg, "validator.keymanager").KeymanagerServer(api, token=TOKEN)
        port = await server.listen(0)
        out = [await _request(port, *req) for req in _sequence(keystore, interchange,
                                                               "0x" + pk7.hex(), pk(2), pk(0))]
        await server.close()
        return out, dict(overrides=(dict(client.fee_recipient_overrides),
                                    dict(client.gas_limit_overrides)),
                         pubkeys=dict(store.pubkeys))

    got, want = asyncio.run(run("port")), asyncio.run(run("jax"))
    statuses = [status for status, _ in got[0]]
    assert statuses[:2] == [401, 200] and statuses[-2:] == [404, 400]
    assert got == want


def test_imported_history_protects_at_once_and_placeholders_never_collide():
    api, store, protection, client = _api("port", indices=(0,))
    validator, bls = mod("port", "validator"), mod("port", "crypto.bls.api")
    sk7 = bls.interop_secret_key(7)
    pk7 = sk7.to_public_key().to_bytes()
    prior = validator.SlashingProtection()
    prior.check_and_insert_attestation(pk7, 3, 4, b"\xaa" * 32)
    ks = mod("port", "validator.keystore").create_keystore(sk7.to_bytes(), "pw", kdf="pbkdf2")
    out = api.import_keystores({"keystores": [json.dumps(ks)], "passwords": ["pw"],
                                "slashing_protection": json.dumps(prior.export_interchange())})
    assert out["data"][0]["status"] == "imported" and pk7 in store.pubkeys.values()
    with pytest.raises(validator.SlashingError):
        protection.check_and_insert_attestation(pk7, 3, 4, b"\xbb" * 32)

    def pk(i):
        return "0x" + bls.interop_secret_key(i).to_public_key().to_bytes().hex()

    # import A, B; delete A; import C: B survives
    api.import_remote_keys({"remote_keys": [{"pubkey": pk(2)}]})
    api.import_remote_keys({"remote_keys": [{"pubkey": pk(3)}]})
    api.delete_remote_keys({"pubkeys": [pk(2)]})
    api.import_remote_keys({"remote_keys": [{"pubkey": pk(4)}]})
    assert {e["pubkey"] for e in api.list_remote_keys()["data"]} == {pk(3), pk(4)}
    # a remote key with no signer configured is an error, as in the JAX api
    bare, *_ = _api("port", indices=(0,), remote=False)
    assert bare.import_remote_keys({"remote_keys": [{"pubkey": pk(5)}]})["data"][0][
        "status"] == "error"
