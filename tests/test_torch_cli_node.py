"""The port's commands against the JAX package's: ``main(["dev", ...])``
with the host verifier prints the JAX command's head JSON; the two
parsers' ``dev``, ``beacon``, ``validator``, ``lightclient``, ``init``,
``account create`` and ``account list`` flags are equal but for the three
renames of the port's BLS flags (``--bls-verifier``'s ``tpu`` is
``torch``, ``--jax-profile`` is ``--torch-profile``, ``--bls-cache-dir``
is gone); ``account create`` / ``account list`` and ``init`` / ``--config``
give the JAX commands' outputs; ``auto`` is the card's verifier and raises
without a card; the README's two-node sync (``dev`` and ``beacon
--connect`` as child processes, through chip_smoke's phase 18c code with
``--bls-verifier native``) reaches one head, and its validator flow
(``beacon`` and ``validator`` as children, through phase 19c's code) puts votes
in blocks and stops cleanly, each bounded to a minute."""

import argparse
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

DEV = ["dev", "--slots", "16", "--validators", "16", "--bls-verifier", "native",
       "--listen-port", "0", "--rest-port", "0"]


def run_main(package: str, argv, tmp_path) -> dict:
    code = (f"import sys\nfrom {package}.cli import main\n"
            f"sys.exit(main({argv!r}))\n")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Traceback" not in proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_dev_command_prints_the_jax_commands_head(tmp_path):
    flags = DEV + ["--forensics-dir", str(tmp_path / "f")]
    got = run_main("lodestar_tpu_torch", flags, tmp_path)
    want = run_main("lodestar_tpu", flags, tmp_path)
    assert got == want
    assert got["head_slot"] == 16


RENAMED = {"bls_cache_dir": None, "jax_profile": "torch_profile"}


def _flags(parser, cmd):
    """{dest: spec} of a command's flags; ``cmd`` may name a subcommand
    ("account create")."""
    for name in cmd.split():
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        parser = sub.choices[name]
    out = {}
    for a in parser._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[a.dest] = dict(options=tuple(a.option_strings), default=a.default,
                           choices=tuple(a.choices) if a.choices else None, nargs=a.nargs,
                           type=getattr(a.type, "__name__", None), action=type(a).__name__,
                           required=a.required)
    return out


def _renamed(jax: dict) -> dict:
    """The JAX command's flags under the port's names (commands with the
    BLS flags: dev, beacon, init)."""
    if "bls_verifier" not in jax:
        return jax
    for old, new in RENAMED.items():
        spec = jax.pop(old)
        if new is not None:
            spec["options"] = tuple(o.replace(old.replace("_", "-"), new.replace("_", "-"))
                                    for o in spec["options"])
            jax[new] = spec
    jax["bls_verifier"]["choices"] = tuple("torch" if c == "tpu" else c
                                           for c in jax["bls_verifier"]["choices"])
    return jax


@pytest.mark.parametrize("cmd", ["dev", "beacon", "validator", "lightclient", "init",
                                 "account create", "account list"])
def test_parser_flags_equal_the_jax_parsers_but_for_the_renames(cmd):
    from lodestar_tpu.cli import build_parser as jax_parser
    from lodestar_tpu_torch.cli import build_parser

    port, jax = _flags(build_parser(), cmd), _renamed(_flags(jax_parser(), cmd))
    assert port == jax and port


def test_account_create_and_list_give_the_jax_commands_outputs(tmp_path, capsys):
    """Keystores made by either command list alike through both commands
    and open in the other package (pbkdf2, so seconds)."""
    from lodestar_tpu.cli import main as jax_main
    from lodestar_tpu.validator.keystore import load_keystores_dir as jax_load
    from lodestar_tpu_torch.cli import main
    from lodestar_tpu_torch.validator.keystore import load_keystores_dir

    password = tmp_path / "pw.txt"
    password.write_text("correct horse\n")
    for run, name in ((main, "port"), (jax_main, "jax")):
        out_dir = tmp_path / name
        assert run(["account", "create", "--out-dir", str(out_dir), "--password-file",
                    str(password), "--count", "2", "--kdf", "pbkdf2"]) == 0
        wrote = capsys.readouterr().out.split()
        assert wrote[::2] == ["wrote", "wrote"] and len(list(out_dir.iterdir())) == 2
    for name in ("port", "jax"):
        listed = []
        for run in (main, jax_main):
            assert run(["account", "list", "--keystores-dir", str(tmp_path / name)]) == 0
            listed.append(capsys.readouterr().out)
        assert listed[0] == listed[1] and listed[0].count("0x") == 2
    # each package opens the other's keystores to the keys they list
    assert sorted(jax_load(str(tmp_path / "port"), "correct horse")) == \
        sorted(load_keystores_dir(str(tmp_path / "port"), "correct horse"))
    assert len(load_keystores_dir(str(tmp_path / "jax"), "correct horse")) == 2


def test_init_writes_the_jax_commands_rc_file_and_beacon_starts_from_it(tmp_path, capsys):
    from lodestar_tpu.cli import main as jax_main
    from lodestar_tpu_torch.cli import _apply_config_file, build_parser, main

    flags = ["--validators", "128", "--preset", "minimal", "--rest-port", "9701",
             "--bls-buckets", "4,16,128", "--bls-warmup", "blocking", "--metrics"]
    rc = {}
    for run, name in ((main, "port"), (jax_main, "jax")):
        path = tmp_path / f"{name}.json"
        assert run(["init", *flags, "--out", str(path)]) == 0
        assert capsys.readouterr().out.strip() == f"wrote {path}"
        rc[name] = json.loads(path.read_text())
    jax = dict(rc["jax"])
    for old, new in RENAMED.items():
        value = jax.pop(old)
        if new is not None:
            jax[new] = value
    assert rc["port"] == jax and rc["port"]["validators"] == 128
    # a beacon command started from the rc file takes its values, and a
    # flag on the command line wins
    argv = ["beacon", "--config", str(tmp_path / "port.json"), "--rest-port", "9702"]
    args = build_parser().parse_args(argv)
    _apply_config_file(args, argv)
    assert (args.validators, args.bls_buckets, args.bls_warmup, args.metrics, args.rest_port) == \
        (128, "4,16,128", "blocking", True, 9702)


def test_lightclient_command_behaves_as_the_jax_command_on_an_altair_chain():
    """Both ``lightclient`` commands bootstrap from a trusted root of a
    port node's Altair chain (16 validators, Altair at 1, 18 slots) and
    poll its updates; built with no fork epochs (the JAX command's
    config), both refuse the updates' sync aggregates, log the failed
    polls, print no header and exit 0 (ROADMAP Queue 3)."""
    import asyncio
    import threading

    from lodestar_tpu_torch.api import RestApiServer
    from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
    from lodestar_tpu_torch.chain.light_client import LightClientServer
    from lodestar_tpu_torch.config.chain_config import ChainConfig
    from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier
    from lodestar_tpu_torch.node.dev_chain import DevChain
    from lodestar_tpu_torch.params import MINIMAL

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    async def start():
        pool = BlsBatchPool(FastBlsVerifier(), max_buffer_wait=0.005)
        cfg = ChainConfig(PRESET_BASE="minimal", SHARD_COMMITTEE_PERIOD=0, MIN_GENESIS_TIME=0,
                          MIN_GENESIS_ACTIVE_VALIDATOR_COUNT=16, ALTAIR_FORK_EPOCH=1)
        dev = DevChain(MINIMAL, cfg, 16, pool)
        rest = RestApiServer(MINIMAL, dev.chain)
        rest.light_client_server = LightClientServer(MINIMAL, dev.chain)
        await dev.run(18)
        root = dev.chain.fork_choice.get_ancestor(dev.chain.head_root, 9)
        return pool, rest, await rest.listen(0), root

    pool, rest, port, root = asyncio.run_coroutine_threadsafe(start(), loop).result(120)
    try:
        argv = ["lightclient", "--beacon-url", f"http://127.0.0.1:{port}", "--checkpoint-root",
                "0x" + root.hex(), "--max-polls", "2", "--poll-seconds", "0"]
        runs = {}
        for package in ("lodestar_tpu_torch", "lodestar_tpu"):
            code = f"import sys\nfrom {package}.cli import main\nsys.exit(main({argv!r}))\n"
            env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
            proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                                  capture_output=True, text=True, timeout=120)
            runs[package] = (proc.returncode, proc.stdout, proc.stderr.count("update poll failed"))
    finally:
        asyncio.run_coroutine_threadsafe(rest.close(), loop).result(30)
        pool.close()
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
    assert runs["lodestar_tpu_torch"] == (0, "", 2) == runs["lodestar_tpu"]


def test_auto_verifier_is_the_cards_and_raises_without_one(monkeypatch):
    from lodestar_tpu_torch.cli import build_parser, make_verifier

    for argv in (["dev"], ["beacon"], ["dev", "--tpu-bls", "--bls-verifier", "native"]):
        args = build_parser().parse_args(argv)
        assert args.bls_verifier in ("auto", "native")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            make_verifier(args)


def test_beacon_and_validator_children_put_votes_in_blocks(tmp_path):
    """The README's validator flow on the host (phase 19c's code): the
    accounts, ``init`` and ``beacon --config`` (16 validators, no fork
    flags), ``validator`` driving it past slot 4; both exit 0 on SIGINT
    and the protection file is interchange JSON."""
    out = chip_smoke.run_cli_validator(str(tmp_path), validators=16, head=4, host=True,
                                       timeout=60)
    assert out["exit_codes"] == {"validator": 0, "beacon": 0}
    assert out["head_slot"] > 4 and out["head_attestations"] > 0
    assert out["beacon"]["stages"] == {} and out["beacon"]["executors"] == {}  # a host verifier
    assert out["rc"]["validators"] == 16 and len(out["accounts"]) == 2
    assert 0 < out["interchange"]["validators"] <= 16 and out["interchange"]["version"] == "5"


def test_dev_and_beacon_children_reach_one_head(tmp_path):
    out = chip_smoke.run_cli_pair(str(tmp_path), validators=16, dev_head=8, host=True,
                                  timeout=60)
    assert out["exit_codes"] == {"beacon": 0, "dev": 0}
    assert out["beacon_head"]["slot"] >= 8
    assert out["beacon_range_sync"]["blocks"] >= 8
    assert out["dev"]["stages"] == {} and out["dev"]["executors"] == {}  # a host verifier
    assert out["dev_final"]["head_slot"] >= out["beacon_head"]["slot"]
