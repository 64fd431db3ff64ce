"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, it imports with JAX blocked, and its entry points run on the card
unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "lodestar_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "lodestar_tpu"}


#: the beacon chain's modules and what they import, copies of the JAX
#: package's at the same relative paths
CHAIN_MODULES = (
    "params/__init__", "params/presets", "config/__init__", "config/chain_config",
    "config/fork_config", "ssz/__init__", "ssz/core", "native/hashtree", "types/__init__",
    "types/schemas", "utils/logger", *(f"state_transition/{m}" for m in (
        "__init__", "misc", "shuffle", "domain", "epoch_context", "validator_ops", "genesis",
        "block", "epoch", "altair", "bellatrix", "upgrade", "signature_sets",
        "state_transition")),
    "eth1/__init__", "eth1/tracker", "fork_choice/__init__", "fork_choice/proto_array",
    "fork_choice/fork_choice", "db/__init__", "db/schema", "db/controller", "db/repository",
    "db/beacon", *(f"chain/{m}" for m in (
        "emitter", "clock", "seen_cache", "op_pools", "regen", "beacon_proposer_cache",
        "validation", "sync_committee_pools", "prepare_next_slot", "beacon_chain")),
    "execution/__init__", "execution/engine", "metrics/validator_monitor", "node/__init__",
    "node/dev_chain",
)


#: the node's network face and its commands' closure (utils, network,
#: sync, api, the gossip handlers, the light-client server, the builder,
#: checkpoint sync), copies of the JAX package's at the same relative paths
NETWORK_MODULES = (
    "utils/bytes", "utils/retry", "utils/snappy", *(f"network/{m}" for m in (
        "__init__", "wire", "peer", "reqresp", "subnets", "gossip", "network", "discovery")),
    "chain/handlers", "chain/light_client", "sync/__init__", "sync/range_sync",
    "sync/unknown_block", "sync/backfill", "api/__init__", "api/serde", "api/rest", "api/client",
    "execution/builder", "state_transition/weak_subjectivity", "node/checkpoint_sync",
)


#: the validator client and what else remained: the validator client's
#: modules, the light client, flare, the eth1 provider and the spec-test
#: harness, copies of the JAX package's at the same relative paths
VALIDATOR_MODULES = (
    *(f"validator/{m}" for m in ("__init__", "slashing_protection", "keystore", "store",
                                 "remote_signer", "header_tracker", "client", "keymanager")),
    "light_client/__init__", "light_client/client", "flare", "eth1/provider",
    *(f"spec_test_util/{m}" for m in ("__init__", "runner", "deposits", "perf_state")),
)


#: the operations layer: the latency ladder, stage salvage and the
#: harnesses run as ``python -m lodestar_tpu_torch.tools.<name>``, the
#: port's copies of the JAX package's modules and of the repo's tools/
OPS_MODULES = (
    "observatory/latency", "forensics/salvage", *(f"tools/{m}" for m in (
        "__init__", "inspect_bundle", "firehose", "chaos_campaign", "prewarm", "meshscope")),
)


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _absolute_imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    for module in ("limbs", "tower", "tower_kernels", "points", "htc", "pairing", "batch_verify",
                   "ring_gather", "sharded_verify", "library_fuse"):
        assert os.path.join(PORT, "ops", f"{module}.py") in files
    for module in ("native/fastbls", "chain/bls_pool", "utils/queue", "utils/errors",
                   "crypto/bls/pairing", "crypto/bls/verifier", "tracing/__init__",
                   "tracing/tracer", "tracing/export", "forensics/__init__", "forensics/journal",
                   "forensics/watchdog", "forensics/bundle", "forensics/recorder",
                   "chaos/__init__", "chaos/plan", "metrics/__init__", "metrics/registry",
                   "aot/__init__", "aot/store", "observatory/__init__",
                   "observatory/compile_ledger", "crypto/bls/bucket_program",
                   "observatory/attribution", "observatory/device_sampler",
                   "observatory/xprof", "crypto/bls/native_verifier", "cli",
                   *CHAIN_MODULES, *NETWORK_MODULES, *VALIDATOR_MODULES, *OPS_MODULES):
        assert os.path.join(PORT, f"{module}.py") in files
    bad = [
        (os.path.relpath(f, REPO), name)
        for f in files
        for name in _absolute_imports(f)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_port_imports_with_jax_and_the_jax_package_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'lodestar_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import lodestar_tpu_torch.crypto.bls.torch_verifier\n"
        "import lodestar_tpu_torch.ops.fused_verify\n"
        "import lodestar_tpu_torch.ops.batch_verify\n"
        "import lodestar_tpu_torch.ops.tower_kernels\n"
        "import lodestar_tpu_torch.ops.ring_gather\n"
        "import lodestar_tpu_torch.ops.sharded_verify\n"
        "import lodestar_tpu_torch.ops.kernels._build\n"
        "import lodestar_tpu_torch.ops.library_fuse\n"
        "import lodestar_tpu_torch.native.fastbls\n"
        "import lodestar_tpu_torch.chain.bls_pool\n"
        "import lodestar_tpu_torch.utils.queue\n"
        "import lodestar_tpu_torch.crypto.bls.pairing\n"
        "import lodestar_tpu_torch.tracing\n"
        "import lodestar_tpu_torch.forensics\n"
        "import lodestar_tpu_torch.chaos\n"
        "import lodestar_tpu_torch.metrics\n"
        "import lodestar_tpu_torch.aot\n"
        "import lodestar_tpu_torch.observatory\n"
        "import lodestar_tpu_torch.observatory.xprof\n"
        "import lodestar_tpu_torch.observatory.device_sampler\n"
        "import lodestar_tpu_torch.observatory.attribution\n"
        "import lodestar_tpu_torch.crypto.bls.native_verifier\n"
        "import lodestar_tpu_torch.cli\n"
        "import lodestar_tpu_torch.chain.beacon_chain\n"
        "import lodestar_tpu_torch.node.dev_chain\n"
        + "".join(f"import lodestar_tpu_torch.{m.replace('/__init__', '').replace('/', '.')}\n"
                  for m in CHAIN_MODULES + NETWORK_MODULES + VALIDATOR_MODULES + OPS_MODULES)
        + "import chip_smoke\n"
        "assert not any(m.split('.')[0] in ('jax', 'jaxlib') and sys.modules[m] is not None"
        " for m in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


ANALYSIS = ("__init__", "__main__", "report", "ast_lint", "metrics_coverage", "lock_audit",
            "limb_interval", "graph_audit", "kernel_audit", "test_cost")


def test_analysis_modules_import_no_jax_and_nothing_of_the_jax_package():
    """The port's analysis layer is its own copy of the JAX package's: no
    module of lodestar_tpu_torch/analysis/ imports jax or lodestar_tpu, at
    the top or inside a function, and each imports with both blocked."""
    root = os.path.join(PORT, "analysis")
    files = sorted(f[:-3] for f in os.listdir(root) if f.endswith(".py"))
    assert files == sorted(ANALYSIS)
    bad = [(name, mod) for name in ANALYSIS
           for mod in _absolute_imports(os.path.join(root, f"{name}.py"))
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'lodestar_tpu'):\n"
            "    sys.modules[name] = None\n"
            + "".join(f"import lodestar_tpu_torch.analysis.{n}\n" for n in ANALYSIS
                      if n not in ("__init__", "__main__"))
            + "from lodestar_tpu_torch.analysis import run_all\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    from lodestar_tpu_torch import resolve_device
    from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
    from lodestar_tpu_torch.ops.fused_verify import from_packed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    packed = (np.zeros((4, 50), np.float32),) * 6 + (np.ones(4, bool),)
    with pytest.raises(RuntimeError):
        TorchBlsVerifier()
    with pytest.raises(RuntimeError):
        TorchBlsVerifier(fused=False)
    with pytest.raises(RuntimeError):
        TorchBlsVerifier(host_final_exp=False)
    with pytest.raises(RuntimeError):
        from_packed(packed)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert TorchBlsVerifier(device="cpu").device.type == "cpu"
    assert TorchBlsVerifier(device="cpu").host_final_exp is True  # the split default
    assert from_packed(packed, device="cpu")[6].dtype == torch.bool


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_port_builds_only_from_its_own_sources():
    """The C final exponentiation and the kernels build from files inside
    lodestar_tpu_torch/, into build/ of the checkout."""
    from lodestar_tpu_torch.native import fastbls
    from lodestar_tpu_torch.ops.kernels import _build

    native = os.path.dirname(fastbls.__file__)
    assert native.startswith(PORT) and _build._HERE.startswith(PORT)
    for name in fastbls.SOURCES:
        assert os.path.exists(os.path.join(native, name))
    assert fastbls.BUILD_DIR == _build.BUILD_DIR == os.path.join(REPO, "build", "lodestar_tpu_torch")
    # the copies are the JAX package's C sources, byte for byte
    for name in fastbls.SOURCES:
        with open(os.path.join(native, name), "rb") as a, \
                open(os.path.join(REPO, "csrc", name), "rb") as b:
            assert a.read() == b.read(), name
