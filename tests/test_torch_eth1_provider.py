"""The port's eth1 JSON-RPC provider and merge-block tracker
(``eth1/provider.py``) against the JAX package's, over one canned local
JSON-RPC server (``tests/test_eth1_provider.py``'s ``FakeEth1Server``: a
PoW chain whose block n has total difficulty 100 (n + 1)): the same block
number, blocks by number and by hash, a batch in one HTTP request, the
same decoded deposit logs (and seeded ABI payloads decoded alike), the
same errors, and the same terminal PoW block for every TTD across the
chain.  Exact values; seconds on one core."""

import asyncio
import importlib

import numpy as np
import pytest

from test_eth1_provider import FakeEth1Server, _abi_bytes

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def plain(value):
    """Fields (and lists of them) as dicts, for comparing across packages."""
    if hasattr(value, "keys"):
        return {k: plain(value[k]) for k in value.keys()}
    if isinstance(value, list):
        return [plain(v) for v in value]
    return value


async def _answers(pkg: str, srv: FakeEth1Server) -> dict:
    provider_mod = mod(pkg, "eth1.provider")
    p = provider_mod.Eth1JsonRpcProvider("127.0.0.1", srv.port)
    out = dict(number=await p.get_block_number(),
               block=plain(await p.get_block_by_number(3)),
               by_hash=plain(await p.get_block_by_hash((7).to_bytes(32, "big"))),
               missing=await p.get_block_by_number(99))
    b0 = srv.batch_requests
    out["batch"] = plain(await p.get_blocks_by_number([1, 2, 3, 25]))
    out["batch_requests"] = srv.batch_requests - b0
    out["empty_batch"] = await p.rpc_batch([])
    out["events"] = plain(await p.get_deposit_events(b"\x11" * 20, 5, 6))
    errors = []
    for call in (p.rpc("eth_nothing", []), p.rpc_batch([("eth_blockNumber", []),
                                                        ("eth_nothing", [])])):
        try:
            await call
            errors.append(None)
        except provider_mod.Eth1Error as e:
            errors.append(str(e).split(" {")[0].split(": {")[0])
    out["errors"] = errors
    cfg = mod(pkg, "config.chain_config").ChainConfig
    out["terminal"] = [
        plain(await provider_mod.Eth1MergeBlockTracker(
            cfg(PRESET_BASE="minimal", TERMINAL_TOTAL_DIFFICULTY=ttd), p).get_terminal_pow_block())
        for ttd in (*range(1, 2200, 97), 10**9)]
    return out


def test_the_provider_and_tracker_give_the_jax_packages_answers():
    async def main():
        srv = FakeEth1Server(head=20)
        await srv.start()
        try:
            return {pkg: await _answers(pkg, srv) for pkg in PKGS}
        finally:
            await srv.stop()

    got = asyncio.run(main())
    port = got["port"]
    assert port["number"] == 20 and port["block"]["total_difficulty"] == 400
    assert port["batch_requests"] == 1 and port["batch"][-1] is None
    assert port["events"][0]["deposit_data"]["amount"] == 32 * 10**9
    assert port["terminal"][-1] is None and port["terminal"][10]["number"] == 9
    assert all(e is not None for e in port["errors"])
    assert port == got["jax"]


@pytest.mark.parametrize("seed", range(4))
def test_deposit_event_payloads_decode_alike(seed):
    rng = np.random.default_rng(seed)
    fields = [rng.bytes(48), rng.bytes(32), int(rng.integers(1, 2**63)).to_bytes(8, "little"),
              rng.bytes(96), int(rng.integers(0, 2**40)).to_bytes(8, "little")]
    head, tail, offset = b"", b"", 5 * 32
    for f in fields:
        head += offset.to_bytes(32, "big")
        enc = _abi_bytes(f)
        tail += enc
        offset += len(enc)
    data = head + tail
    got = {pkg: plain(mod(pkg, "eth1.provider")._decode_deposit_event_data(data)) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert got["port"]["pubkey"] == fields[0]
    assert got["port"]["amount"] == int.from_bytes(fields[2], "little")


def test_eth1_package_exports_equal_the_jax_packages():
    names = {pkg: sorted(n for n in dir(mod(pkg, "eth1")) if not n.startswith("_"))
             for pkg in PKGS}
    assert names["port"] == names["jax"]
    assert mod("port", "eth1.provider").DEPOSIT_EVENT_TOPIC == \
        mod("jax", "eth1.provider").DEPOSIT_EVENT_TOPIC
