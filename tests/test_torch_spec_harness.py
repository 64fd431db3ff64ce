"""The port's spec-test harness (``spec_test_util/``) against the JAX
package's: over a synthetic tree in the consensus-spec-tests layout and
over the repo's ``spec-tests/`` the same case lists and the same loaded
metadata and files (YAML, SSZ, snappy frames decoded); a runner over the
synthetic cases gives the same results; interop deposits (data, proofs)
are byte-equal; ``build_perf_state`` gives the JAX state's root and
epoch-transition root at 1,024 validators (mainnet preset, with and
without participation).  Exact bytes and roots.  About 10 s on one core."""

import importlib
import random
from pathlib import Path

import pytest

PKGS = {"jax": "lodestar_tpu", "port": "lodestar_tpu_torch"}
REPO = Path(__file__).resolve().parents[1]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def _tree(root: Path) -> None:
    """tests/minimal/phase0/ssz_static/Checkpoint/ssz_random/case_{n}/,
    written with the JAX package's snappy framing."""
    snappy = mod("jax", "utils.snappy")
    t = mod("jax", "types").get_types(mod("jax", "params").MINIMAL).phase0
    Fields = mod("jax", "ssz").Fields
    rng = random.Random(3)
    base = root / "tests" / "minimal" / "phase0" / "ssz_static" / "Checkpoint" / "ssz_random"
    for n in range(4):
        case = base / f"case_{n}"
        case.mkdir(parents=True)
        value = Fields(epoch=rng.randrange(2**32), root=bytes(rng.randrange(256) for _ in range(32)))
        (case / "serialized.ssz_snappy").write_bytes(
            snappy.frame_compress(t.Checkpoint.serialize(value)))
        (case / "value.ssz").write_bytes(t.Checkpoint.serialize(value))
        (case / "roots.yaml").write_text(f"{{root: '0x{t.Checkpoint.hash_tree_root(value).hex()}'}}\n")


def _cases(pkg: str, root: Path, queries) -> list:
    util = mod(pkg, "spec_test_util")
    out = []
    for args in queries:
        dirs = util.collect_spec_test_cases(*args, root=root)
        for d in dirs:
            case = util.load_spec_test_case(d)
            out.append((str(d.relative_to(root)), case.config, case.fork, case.runner,
                        case.handler, case.suite, case.name,
                        {k: v for k, v in sorted(case.files.items())}))
    return out


def test_synthetic_tree_cases_and_runner_results_equal_the_jax_harness(tmp_path):
    _tree(tmp_path)
    queries = [("ssz_static", "Checkpoint"), ("ssz_static", None), ("operations", "attestation")]
    got, want = _cases("port", tmp_path, queries), _cases("jax", tmp_path, queries)
    assert len(got) == 8 and got == want
    results = {}
    for pkg in PKGS:
        util = mod(pkg, "spec_test_util")
        t = mod(pkg, "types").get_types(mod(pkg, "params").MINIMAL).phase0
        dirs = util.collect_spec_test_cases("ssz_static", "Checkpoint", root=tmp_path)

        def run(case, t=t):
            return t.Checkpoint.hash_tree_root(
                t.Checkpoint.deserialize(case.bytes_of("serialized"))).hex()

        results[pkg] = [(c.name, ok, g, w) for c, ok, g, w in util.describe_directory_spec_test(
            dirs, run, lambda case: case.files["roots"]["root"][2:])]
    assert results["port"] == results["jax"] and all(ok for _, ok, _, _ in results["port"])
    with pytest.raises(TypeError):
        mod("port", "spec_test_util").load_spec_test_case(
            tmp_path / "tests/minimal/phase0/ssz_static/Checkpoint/ssz_random/case_0"
        ).bytes_of("roots")


def test_repo_vectors_list_and_load_as_in_the_jax_harness():
    queries = [("shuffling", None), ("ssz_static", "Checkpoint"), ("sanity", "blocks"),
               ("operations", "attestation"), ("epoch_processing", None)]
    got = _cases("port", REPO / "spec-tests", queries)
    assert got and got == _cases("jax", REPO / "spec-tests", queries)
    for pkg in PKGS:
        util = mod(pkg, "spec_test_util")
        assert util.collect_spec_test_cases("operations", "attestation",
                                            root=Path("/nonexistent")) == []
    assert mod("port", "spec_test_util").spec_tests_root() == REPO / "spec-tests"


def test_snappy_frames_equal_the_jax_codec():
    rng = random.Random(9)
    for size in (0, 1, 100, 70000):
        data = bytes(rng.randrange(8) for _ in range(size))
        frames = {pkg: mod(pkg, "utils.snappy").frame_compress(data) for pkg in PKGS}
        assert frames["port"] == frames["jax"]
        assert mod("port", "utils.snappy").frame_uncompress(frames["jax"]) == data


def test_interop_deposits_are_byte_equal():
    out = {}
    for pkg in PKGS:
        p = mod(pkg, "params").MINIMAL
        cfg = mod(pkg, "config.chain_config").ChainConfig(PRESET_BASE="minimal")
        t = mod(pkg, "types").get_types(p).phase0
        deposits = mod(pkg, "spec_test_util.deposits").build_deposits(p, cfg, 6, amounts={2: 10**9})
        out[pkg] = [t.Deposit.serialize(d) for d in deposits]
    assert len(out["port"]) == 6 and out["port"] == out["jax"]


@pytest.mark.parametrize("with_attestations", [True, False])
def test_build_perf_state_roots_equal_the_jax_states_at_1024_validators(with_attestations):
    out = {}
    for pkg in PKGS:
        p = mod(pkg, "params").MAINNET
        cfg = mod(pkg, "config.chain_config").ChainConfig(PRESET_BASE="mainnet")
        state, ctx = mod(pkg, "spec_test_util.perf_state").build_perf_state(
            p, cfg, 1024, with_attestations=with_attestations)
        t = mod(pkg, "types").get_types(p).phase0
        before = t.BeaconState.hash_tree_root(state)
        mod(pkg, "state_transition").process_slots(p, cfg, state, int(state.slot) + 1)
        out[pkg] = (before, t.BeaconState.hash_tree_root(state), int(state.slot))
    assert out["port"] == out["jax"]
