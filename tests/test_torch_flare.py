"""The port's ``flare`` (``python -m lodestar_tpu_torch.flare``) against the
JAX package's:

- the parser's commands and flags are the JAX parser's, letter for letter;
- on a phase0 chain (genesis fork version 0x00000000) the port's
  ``self-slash-proposer`` and ``self-slash-attester`` pool the bytes that
  the JAX commands pool when the JAX module signs under the node's chain
  config (its own signs under the minimal preset's published config,
  genesis version 0x00000001);
- on a chain past Altair and Bellatrix (16 validators, Altair at 1,
  Bellatrix at 2) the port's slashings, signed under the node's fork
  schedule, ride the next block, verify and slash both indices, while the
  JAX commands' slashings make that block fail its signature check (the
  reference's problem, ROADMAP Queue 3);
- ``dump-block`` prints a stored block as the JAX command does.

Exact bytes and JSON.  About 15 s on one core."""

import argparse
import asyncio
import contextlib
import importlib
import io
import json

import pytest

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
N = 16


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _flags(parser):
    out = {}
    subs = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    for cmd, sub in subs.choices.items():
        for a in sub._actions:
            if not isinstance(a, argparse._HelpAction):
                out[(cmd, a.dest)] = (tuple(a.option_strings), a.default, a.required,
                                      tuple(a.choices) if a.choices else None,
                                      getattr(a.type, "__name__", None))
    return out


def test_the_parser_is_the_jax_parser(monkeypatch):
    parsers = {}

    def capture(self, *a, **kw):  # main's parser, caught as it parses
        parsers.setdefault("parser", self)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    for pkg in PKGS:
        with pytest.raises(SystemExit):
            mod(pkg, "flare").main(["dump-block", "--db", "x", "--root", "0x00"])
        parsers[pkg] = _flags(parsers.pop("parser"))
    assert parsers["port"] == parsers["jax"]
    assert {cmd for cmd, _ in parsers["port"]} == {"self-slash-proposer", "self-slash-attester",
                                                    "dump-block"}


def _config(pkg: str, altair=2**64 - 1, bellatrix=2**64 - 1):
    return mod(pkg, "config.chain_config").ChainConfig(
        PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
        MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=N, ALTAIR_FORK_EPOCH=altair,
        BELLATRIX_FORK_EPOCH=bellatrix)


async def _node(pkg: str, cfg, slots: int = 0, db=None):
    pool = mod(pkg, "chain.bls_pool").BlsBatchPool(
        mod(pkg, "crypto.bls.native_verifier").FastBlsVerifier(), max_buffer_wait=0.005)
    p = mod(pkg, "params").MINIMAL
    dev = mod(pkg, "node.dev_chain").DevChain(p, cfg, N, pool, db=db)
    await dev.run(slots)
    rest = mod(pkg, "api").RestApiServer(p, dev.chain)
    port = await rest.listen(0)
    return dev, rest, pool, port


class Args:
    def __init__(self, port, **kw):
        self.server, self.preset = f"http://127.0.0.1:{port}", "minimal"
        self.__dict__.update(kw)


async def _slash(pkg: str, flare_pkg: str, cfg, slots: int, proposer_kw: dict,
                 attester_kw: dict, monkeypatch=None):
    dev, rest, pool, port = await _node(pkg, cfg, slots)
    flare = mod(flare_pkg, "flare")
    if monkeypatch is not None:  # the JAX module signing under the node's config
        monkeypatch.setattr(flare, "_preset_cfg", lambda name: (dev.p, cfg))
    with contextlib.redirect_stdout(io.StringIO()):
        sent = (await flare.self_slash_proposer(Args(port, **proposer_kw)),
                await flare.self_slash_attester(Args(port, **attester_kw)))
    to_json = mod(pkg, "api.serde").to_json
    slashings = dev.chain.op_pool.get_slashings_and_exits(dev.chain.head_state())
    return dev, rest, pool, sent, [[to_json(s) for s in kind] for kind in slashings[:2]]


def test_phase0_slashings_equal_the_jax_commands_under_the_nodes_config(monkeypatch):
    async def run(pkg, patch):
        dev, rest, pool, sent, pooled = await _slash(
            pkg, pkg, _config(pkg), 0, dict(index_start=3, count=2, slot=1),
            dict(index_start=0, count=3, epoch=0), monkeypatch if patch else None)
        await rest.close()
        pool.close()
        return sent, pooled

    got, want = asyncio.run(run("port", False)), asyncio.run(run("jax", True))
    assert got[0] == (2, 1) and len(got[1][0]) == 2 and len(got[1][1]) == 1
    assert got == want


def test_slashings_ride_a_bellatrix_block_only_when_signed_under_the_nodes_schedule():
    async def run(pkg):
        cfg = _config(pkg, altair=1, bellatrix=2)
        dev, rest, pool, sent, pooled = await _slash(
            pkg, pkg, cfg, 2 * 8 + 1, dict(index_start=5, count=1, slot=16),
            dict(index_start=6, count=1, epoch=2))
        outcome = {}
        try:
            root = await dev.advance_slot(18)
            block = dev.chain.get_block_by_root(root).message
            state = dev.chain.head_state()
            outcome = dict(proposer=len(block.body.proposer_slashings),
                           attester=len(block.body.attester_slashings),
                           slashed=[bool(state.validators[i].slashed) for i in (5, 6)])
        except mod(pkg, "chain.beacon_chain").BlockError as e:
            outcome = dict(error=str(e))
        await rest.close()
        pool.close()
        return outcome

    assert asyncio.run(run("port")) == dict(proposer=1, attester=1, slashed=[True, True])
    assert "error" in asyncio.run(run("jax"))


def test_dump_block_prints_the_jax_commands_json(tmp_path):
    async def build():
        db_mod = mod("port", "db.beacon")
        controller = mod("port", "db.controller").SqliteDbController(str(tmp_path / "b.db"))
        p = mod("port", "params").MINIMAL
        dev, rest, pool, _ = await _node("port", _config("port"), 3,
                                         db=db_mod.BeaconDb(p, controller))
        root = dev.chain.head_root.hex()
        await rest.close()
        pool.close()
        controller.close()
        return root

    root = asyncio.run(build())
    out = {}
    for pkg in PKGS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = mod(pkg, "flare").main(["dump-block", "--db", str(tmp_path / "b.db"),
                                           "--root", "0x" + root])
        out[pkg] = (code, json.loads(buf.getvalue()))
    assert out["port"][0] == 0 and out["port"][1]["message"]["slot"] == "3"
    assert out["port"] == out["jax"]
