"""The port's ``dev`` and ``beacon`` commands against the JAX package's:
``main(["dev", ...])`` with the host verifier prints the JAX command's
head JSON; the two parsers' ``dev`` and ``beacon`` flags are equal but for
the three renames of the port's BLS flags (``--bls-verifier``'s ``tpu`` is
``torch``, ``--jax-profile`` is ``--torch-profile``, ``--bls-cache-dir``
is gone); the commands not ported yet are argparse errors; ``auto`` is the
card's verifier and raises without a card; and the README's two-node sync
(``dev`` and ``beacon --connect`` as child processes, chip_smoke's phase
18c driver with ``--bls-verifier native``) reaches one head, bounded to a
minute."""

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
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    out = {}
    for a in sub.choices[cmd]._actions:
        if isinstance(a, argparse._HelpAction):
            continue
        out[a.dest] = dict(options=tuple(a.option_strings), default=a.default,
                           choices=tuple(a.choices) if a.choices else None, nargs=a.nargs,
                           type=getattr(a.type, "__name__", None), action=type(a).__name__,
                           required=a.required)
    return out


@pytest.mark.parametrize("cmd", ["dev", "beacon"])
def test_parser_flags_equal_the_jax_parsers_but_for_the_renames(cmd):
    from lodestar_tpu.cli import build_parser as jax_parser
    from lodestar_tpu_torch.cli import build_parser

    port, jax = _flags(build_parser(), cmd), _flags(jax_parser(), cmd)
    for old, new in RENAMED.items():
        spec = jax.pop(old)
        if new is not None:
            spec["options"] = tuple(o.replace(old.replace("_", "-"), new.replace("_", "-"))
                                    for o in spec["options"])
            jax[new] = spec
    jax["bls_verifier"]["choices"] = tuple("torch" if c == "tpu" else c
                                           for c in jax["bls_verifier"]["choices"])
    assert port == jax


@pytest.mark.parametrize("cmd", ["validator", "lightclient", "account", "init"])
def test_commands_not_ported_yet_are_argparse_errors(cmd, capsys):
    from lodestar_tpu_torch.cli import main

    with pytest.raises(SystemExit) as e:
        main([cmd])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


def test_auto_verifier_is_the_cards_and_raises_without_one(monkeypatch):
    from lodestar_tpu_torch.cli import build_parser, make_verifier

    for argv in (["dev"], ["beacon"], ["dev", "--tpu-bls", "--bls-verifier", "native"]):
        args = build_parser().parse_args(argv)
        assert args.bls_verifier in ("auto", "native")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            make_verifier(args)


def test_dev_and_beacon_children_reach_one_head(tmp_path):
    out = chip_smoke.run_cli_pair(str(tmp_path), validators=16, dev_head=8, host=True,
                                  timeout=60)
    assert out["exit_codes"] == {"beacon": 0, "dev": 0}
    assert out["beacon_head"]["slot"] >= 8
    assert out["beacon_range_sync"]["blocks"] >= 8
    assert out["dev"]["stages"] == {} and out["dev"]["executors"] == {}  # a host verifier
    assert out["dev_final"]["head_slot"] >= out["beacon_head"]["slot"]
