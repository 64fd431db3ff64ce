"""The port's CLI part (``lodestar_tpu_torch/cli.py``) held against the JAX
package's ``cli.py`` on the CPU.

- ``add_bls_flags`` gives the JAX ``build_parser``'s BLS and
  observability flags (its ``dev`` command's, from ``--bls-verifier`` to
  ``--telemetry-interval-s``) with their names, defaults, types and
  choices, but for the three stated changes: the choice ``tpu`` is
  ``torch``, ``--jax-profile`` is ``--torch-profile``, ``--bls-cache-dir``
  is gone.
- ``make_verifier`` passes the JAX ``_make_verifier``'s arguments to the
  verifier and calls the same warmup, both through stubbed verifier
  classes; ``--bls-fused auto`` is the fused program (the JAX CLI's
  ``None``, which its verifier turns on only on a TPU).
- ``auto`` and ``torch`` with no card raise: nothing falls back; a
  load-only warmup's store miss propagates.
- ``FastBlsVerifier`` (the ``native`` choice) gives the JAX one's verdicts
  on seeded valid and corrupted sets.
- The observability helpers over a pool on the CPU: the tracer, the
  sampler over the verifier's executors, a profile window over one flush
  and the merged trace written at shutdown.
"""

import argparse
import asyncio
import json
import os

import numpy as np
import pytest
import torch

from lodestar_tpu import cli as jcli
from lodestar_tpu.crypto.bls import api as japi
from lodestar_tpu.crypto.bls import native_verifier as jnative
from lodestar_tpu.crypto.bls import tpu_verifier as jtv
from lodestar_tpu.crypto.bls import verifier as jverifier
from lodestar_tpu_torch import cli, tracing
from lodestar_tpu_torch.aot import AotStoreMiss
from lodestar_tpu_torch.crypto.bls import api
from lodestar_tpu_torch.crypto.bls import torch_verifier as tv
from lodestar_tpu_torch.crypto.bls import verifier as pverifier
from lodestar_tpu_torch.crypto.bls.native_verifier import FastBlsVerifier
from lodestar_tpu_torch.observatory import device_sampler, xprof

from test_xprof import check_trace

FLAG_PREFIXES = ("--bls-", "--trace-", "--jax-profile", "--torch-profile", "--profile-window",
                 "--forensics-dir",
                 "--watchdog-deadline-s", "--log-format", "--telemetry-interval-s")


def _flags(parser):
    out = {}
    for a in parser._actions:
        name = next((o for o in a.option_strings if o.startswith("--")), None)
        if name and name.startswith(FLAG_PREFIXES):
            out[name] = (a.dest, a.default, a.type, tuple(a.choices or ()), type(a).__name__)
    return out


def test_the_flags_are_the_jax_clis_with_three_changes():
    dev = jcli.build_parser()._subparsers._group_actions[0].choices["dev"]
    want = _flags(dev)
    got = _flags(cli.add_bls_flags(argparse.ArgumentParser()))
    # the three changes
    dest, default, typ, choices, kind = want.pop("--bls-verifier")
    assert choices == ("auto", "tpu", "native", "python")
    want["--bls-verifier"] = (dest, default, typ, ("auto", "torch", "native", "python"), kind)
    _dest, *rest = want.pop("--jax-profile")
    want["--torch-profile"] = ("torch_profile", *rest)
    assert want.pop("--bls-cache-dir")[0] == "bls_cache_dir"
    assert got == want
    assert len(got) == 26


class _Stub:
    """A verifier class that records its arguments and warmups."""

    def __init__(self, **kw):
        self.kw = kw
        self.calls = []
        self.fused = kw.get("fused")
        self._native_tier_only = False

    def warmup(self, buckets=None, load_only=None):
        self.calls.append(("warmup", load_only))
        return 0.0

    def warmup_async(self, buckets=None):
        self.calls.append(("warmup_async", None))


def _both(monkeypatch, argv, tmp_path):
    """(the port's verifier stub, the JAX one) for one command line."""
    monkeypatch.setattr(jtv, "TpuBlsVerifier", lambda **kw: _Stub(**kw))
    monkeypatch.setattr(jtv, "configure_persistent_cache", lambda d: None)
    monkeypatch.setattr(tv, "TorchBlsVerifier", lambda **kw: _Stub(**kw))
    monkeypatch.setenv("LODESTAR_TPU_AOT_STORE", "")
    monkeypatch.delenv("LODESTAR_TPU_TORCH_AOT_STORE", raising=False)
    port_args = cli.add_bls_flags(argparse.ArgumentParser()).parse_args(argv)
    jax_argv = [{"torch": "tpu", "--torch-profile": "--jax-profile"}.get(a, a) for a in argv]
    if "--bls-verifier" not in jax_argv:
        jax_argv += ["--bls-verifier", "tpu"]  # the JAX CLI's auto is native off a TPU
    jax_args = jcli.build_parser().parse_args(["dev", *jax_argv])
    xprof.CAPTURE = None
    port = cli.make_verifier(port_args, device="cpu")
    port_capture = xprof.CAPTURE
    jax = jcli._make_verifier(jax_args)
    xprof.CAPTURE = None
    return port, jax, port_capture


@pytest.mark.parametrize("argv", [
    [],
    ["--bls-verifier", "torch", "--bls-buckets", "4,16", "--bls-fused", "off",
     "--bls-warmup", "blocking", "--bls-point-cache-size", "7"],
    ["--bls-sharded", "on", "--bls-sharded-min-batch", "16", "--bls-devices", "2",
     "--bls-quarantine-threshold", "3", "--bls-quarantine-backoff-s", "0.5", "--bls-warmup", "off"],
    ["--bls-warmup-load-only", "--bls-sharded", "off", "--bls-fused", "on"],
    ["--torch-profile", "PROFILE"],
])
def test_make_verifier_passes_the_jax_clis_arguments(argv, monkeypatch, tmp_path):
    argv = [str(tmp_path / "p") if a == "PROFILE" else a for a in argv]
    from lodestar_tpu.observatory import xprof as jxprof

    monkeypatch.setattr(jxprof, "CAPTURE", None)
    port, jax, capture = _both(monkeypatch, argv, tmp_path)
    pk, jk = dict(port.kw), dict(jax.kw)
    assert pk.pop("device") == "cpu" and pk.pop("aot_store") is None
    # --bls-fused auto: the port's fused program, the JAX verifier's None
    if jk["fused"] is None:
        jk["fused"] = True
    pdev, jdev = pk.pop("devices"), jk.pop("devices")
    assert (pdev is None) == (jdev is None)
    if pdev is not None:
        assert pdev == ["cpu"] * len(jdev)
    assert pk == jk
    if "--torch-profile" in argv:
        # the warmup ran under one profile window (the JAX CLI's too)
        assert capture is not None and capture.windows == 1
        assert capture.last_window()["summary"]["label"] == "warmup"
    assert port.calls == jax.calls


def test_auto_and_torch_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for choice in ("auto", "torch"):
        args = cli.add_bls_flags(argparse.ArgumentParser()).parse_args(
            ["--bls-verifier", choice, "--bls-warmup", "off"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.make_verifier(args)
    args = cli.add_bls_flags(argparse.ArgumentParser()).parse_args(
        ["--bls-devices", "2", "--bls-warmup", "off"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError):
        cli.make_verifier(args)


def test_a_load_only_miss_raises(monkeypatch):
    class Missing(_Stub):
        def warmup(self, buckets=None, load_only=None):
            raise AotStoreMiss("no library in the store")

    monkeypatch.setattr(tv, "TorchBlsVerifier", lambda **kw: Missing(**kw))
    args = cli.add_bls_flags(argparse.ArgumentParser()).parse_args(["--bls-warmup-load-only"])
    with pytest.raises(AotStoreMiss):
        cli.make_verifier(args, device="cpu")


def test_native_and_python_are_explicit_choices():
    for choice, cls in (("native", FastBlsVerifier), ("python", pverifier.PyBlsVerifier)):
        args = cli.add_bls_flags(argparse.ArgumentParser()).parse_args(["--bls-verifier", choice])
        assert type(cli.make_verifier(args)) is cls


def _seeded_sets(pkg, verifier_mod, seed, n, corrupt=None):
    rng = np.random.default_rng(seed)
    sets = []
    for i in range(n):
        sk = pkg.interop_secret_key(int(rng.integers(0, 64)))
        msg = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        sig = sk.sign(msg).to_bytes()
        if corrupt == i:
            msg = bytes([msg[0] ^ 1]) + msg[1:]
        sets.append(verifier_mod.SingleSignatureSet(pubkey=sk.to_public_key(), signing_root=msg,
                                                    signature=sig))
    return sets


@pytest.mark.parametrize("corrupt", [None, 0, 2])
def test_fast_bls_verifier_gives_the_jax_verdicts(corrupt):
    port, jax = FastBlsVerifier(), jnative.FastBlsVerifier()
    assert jax.native
    got = port.verify_signature_sets(_seeded_sets(api, pverifier, 5, 3, corrupt))
    want = jax.verify_signature_sets(_seeded_sets(japi, jverifier, 5, 3, corrupt))
    assert got is want is (corrupt is None)
    assert (port.sets_verified, port.batch_retries) == (jax.sets_verified, jax.batch_retries)
    with pytest.raises(ValueError):
        port.verify_signature_sets([])


class _OneProgram:
    """The split program's stand-in: f = 1 and every lane live, so that
    the host final exponentiation (the C library) says True."""

    def run(self, packed):
        f = torch.zeros(6, 2, 50)
        f[0, 0, 0] = 1
        return (f, torch.tensor(True)), None


def test_the_observability_helpers_over_a_pool_on_the_cpu(tmp_path, monkeypatch):
    from lodestar_tpu_torch.forensics import RECORDER

    installs = []
    monkeypatch.setattr(RECORDER, "install", lambda **kw: installs.append(kw))
    saved = (RECORDER._dir, RECORDER.metrics, RECORDER.pool, RECORDER.verifier)
    args = cli.add_bls_flags(argparse.ArgumentParser()).parse_args([
        "--bls-buckets", "4", "--bls-warmup", "off", "--trace-dump", str(tmp_path / "t.json"),
        "--torch-profile", str(tmp_path / "prof"), "--profile-window", "1",
        "--telemetry-interval-s", "0.05", "--forensics-dir", str(tmp_path / "f"),
        "--watchdog-deadline-s", "0", "--log-format", "json"])
    tracing.TRACER.clear()
    try:
        cli.configure_tracing(args)
        assert tracing.TRACER.enabled
        pool = cli.make_pool(args, device="cpu")
        assert pool.flush_threshold == 128 and pool.overload_shed_threshold == 256
        pool.verifier._program = lambda card, bucket, load_only=None: _OneProgram()
        cli.configure_forensics(args, pool=pool)
        assert installs == [{"watchdog_deadline_s": None}]
        assert RECORDER.dir == str(tmp_path / "f")
        sampler = device_sampler.SAMPLER
        assert sampler.running and [r for r in sampler.tick()["devices"]] == ["cpu"]
        cap = xprof.get_capture()
        assert cap.snapshot()["state"] == "capturing"

        async def main():
            sk = api.interop_secret_key(1)
            msg = b"\x01" * 32
            s = pverifier.SingleSignatureSet(pubkey=sk.to_public_key(), signing_root=msg,
                                             signature=sk.sign(msg).to_bytes())
            assert await pool.verify_signature_sets([s])
            pool.close()

        asyncio.run(main())
        path = cli.finalize_profile(args)
        assert path == str(tmp_path / "prof" / "merged_trace.json")
        with open(path) as f:
            doc = json.load(f)
        assert check_trace.validate(doc) == []
        names = {e["name"] for e in doc["traceEvents"]}
        assert {"bls.pack", "bls.dispatch", "bls.final_exp", "bls.queue_wait",
                "pool.batch"} <= names
        cli.dump_trace(args.trace_dump)
        assert os.path.exists(args.trace_dump)
    finally:
        device_sampler.stop_sampler()
        xprof.CAPTURE = None
        tracing.TRACER.disable()
        tracing.TRACER.clear()
        RECORDER._dir, RECORDER.metrics, RECORDER.pool, RECORDER.verifier = saved
        import logging

        log = logging.getLogger("lodestar_tpu_torch")
        for h in [h for h in log.handlers if getattr(h, "_lodestar_stderr", False)]:
            log.removeHandler(h)
