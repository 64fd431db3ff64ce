"""The verifier's health, quarantine and requeue, with the journal, in-flight
table, fault seams, bundles and metrics they report through, held against
the JAX package on the CPU.

- Parity of the health machine: one scripted fault plan and one sequence
  of clock steps go through the JAX ``TpuBlsVerifier`` with stub programs
  (``tools/chaos_campaign.stub_verifier``) and through
  ``TorchBlsVerifier(devices=["cpu"] * n)`` whose ``_program`` is stubbed
  the same way.  After every step each executor's (state, failures,
  quarantines, backoff_s), the executor every dispatch lands on and the
  ``bls.health`` / ``bls.requeue`` journal sequences are equal, executor
  names mapped to their index.  The clock is stepped, never slept: both
  modules read a fake ``time.monotonic``.
- Exactly-once release of the slot and the in-flight entry on an
  injected raise; the disarmed seams never reach the controller.
- A real requeue at bucket 4 (the fused split program's plain versions):
  a valid and a corrupted batch, each lost on executor 0, give True and
  False.
- The metrics' exposition lines for requeues and quarantines equal the
  JAX registry's; without ``prometheus_client`` every metric is a no-op.
- One quarantine bundle per cooldown; ``tools/inspect_bundle.py`` reads
  the port's bundle as it reads the JAX one.
- The pool hands the merged batch's tightest deadline to
  ``verify_signature_sets_async``.
"""

import asyncio
import json
import os
import re
import time

import numpy as np
import pytest
import torch

from lodestar_tpu.chaos import CHAOS as JCHAOS
from lodestar_tpu.chaos import FaultPlan as JFaultPlan
from lodestar_tpu.crypto.bls import tpu_verifier as jtv
from lodestar_tpu.forensics.journal import JOURNAL as JJOURNAL
from lodestar_tpu.forensics.recorder import RECORDER as JRECORDER
from lodestar_tpu.forensics.watchdog import INFLIGHT as JINFLIGHT
from lodestar_tpu.ops.sharded_verify import mesh_device_name as jax_mesh_device_name
from lodestar_tpu.tracing import TRACER as JTRACER
from lodestar_tpu_torch import tracing
from lodestar_tpu_torch.chain.bls_pool import BlsBatchPool
from lodestar_tpu_torch.chaos import CHAOS, DeviceLostError, FaultPlan, InjectedCompileError
from lodestar_tpu_torch.crypto.bls import PublicKey, SingleSignatureSet, interop_secret_key
from lodestar_tpu_torch.crypto.bls import torch_verifier as tv
from lodestar_tpu_torch.crypto.bls.bucket_program import input_specs
from lodestar_tpu_torch.crypto.bls.torch_verifier import (
    HEALTHY,
    PROBING,
    QUARANTINED,
    SUSPECT,
    PendingVerdict,
    TorchBlsVerifier,
)
from lodestar_tpu_torch.forensics import INFLIGHT, JOURNAL, RECORDER, Watchdog
from lodestar_tpu_torch.metrics import registry as mreg
from lodestar_tpu_torch.tracing import TRACER

from tools.chaos_campaign import load_tool, stub_verifier

BUCKET = 4


@pytest.fixture(autouse=True)
def _clean(tmp_path, monkeypatch):
    """Both packages' fault planes, tracers, in-flight tables and
    recorders start clean and are restored; bundles go to tmp_path."""
    monkeypatch.delenv("LODESTAR_TPU_SHARDED", raising=False)
    saved = [(r, r._dir, r.verifier, r.metrics) for r in (RECORDER, JRECORDER)]
    for chaos, tracer, inflight in ((CHAOS, TRACER, INFLIGHT), (JCHAOS, JTRACER, JINFLIGHT)):
        chaos.disarm()
        tracer.disable()
        tracer.clear()
        inflight.clear()
    RECORDER.configure(forensics_dir=str(tmp_path / "port"))
    JRECORDER.configure(forensics_dir=str(tmp_path / "jax"))
    yield
    for chaos, tracer, inflight in ((CHAOS, TRACER, INFLIGHT), (JCHAOS, JTRACER, JINFLIGHT)):
        chaos.disarm()
        tracer.disable()
        tracer.clear()
        inflight.clear()
    for r, d, v, m in saved:
        r._dir, r.verifier, r.metrics = d, v, m


def fake_packed(live=BUCKET):
    digits = tuple(np.zeros(shape, np.float32) for shape, _ in input_specs(BUCKET)[:6])
    return digits + (np.arange(BUCKET) < live,)


class _StubProgram:
    """A card program's stand-in: the verdict True, no device work."""

    def run(self, packed):
        return (torch.tensor(True),), None


def port_verifier(n, threshold=2, backoff=1.0, backoff_max=60.0, sharded=False, metrics=None):
    v = TorchBlsVerifier(devices=["cpu"] * n, fused=False, host_final_exp=False,
                         buckets=(BUCKET,), sharded=sharded,
                         sharded_min_batch=BUCKET if sharded else None,
                         quarantine_threshold=threshold, quarantine_backoff_s=backoff,
                         quarantine_backoff_max_s=backoff_max, metrics=metrics)
    stub = _StubProgram()
    v._program = lambda card, bucket: stub
    if sharded:
        v._mesh_program_for = lambda bucket: stub
    return v


def jax_verifier(n, threshold=2, backoff=1.0, backoff_max=60.0, sharded=False, metrics=None):
    v = stub_verifier(n_devices=n, device_s=0.0, backoff_s=backoff, threshold=threshold,
                      sharded=sharded, bucket=BUCKET)
    v.quarantine_backoff_max_s = backoff_max
    v.metrics = metrics
    return v


class Clock:
    """A ``time`` module whose ``monotonic`` is stepped by the test."""

    def __init__(self):
        self.now = 1000.0
        self.perf_counter = time.perf_counter
        self.sleep = time.sleep
        self.monotonic_ns = time.monotonic_ns
        self.time = time.time

    def monotonic(self):
        return self.now


_NAMES = {"port": re.compile(r"\bcpu(?:#(\d+))?"),
          "jax": re.compile(r"\bcpu:(\d+)")}


def norm(side, text):
    """Card executor names -> 'ex<index>' (the port names a repeated card
    ``cpu``, ``cpu#1``, ...; the JAX verifier its CPU devices ``cpu:0``,
    ``cpu:1``, ...); the mesh's name, ``mesh{n}`` in both, stays as it is."""
    return _NAMES[side].sub(lambda m: f"ex{int(m.group(1) or 0)}", str(text))


HEALTH_KEYS = ("state", "failures", "quarantines", "backoff_s")
EVENT_KEYS = ("kind", "level", "device", "from_device", "state", "failures", "backoff_s",
              "readmitted", "attempt", "error")


class Side:
    """One package's verifier, fault plane and journal under one script."""

    def __init__(self, name, verifier, chaos, plan_cls, journal):
        self.name, self.v, self.chaos, self.plan_cls, self.journal = (
            name, verifier, chaos, plan_cls, journal)
        self.seq0 = journal.seq
        self.verdicts = []

    def exname(self, index):
        if index == "mesh":
            return self.v._mesh_ex.name
        return self.v._executors[index].name

    def arm(self, count, index=None, seam="device.loss"):
        match = None if index is None else {"device": self.exname(index)}
        self.chaos.install(self.plan_cls(0).add(seam, match=match, count=count))

    def dispatch(self):
        try:
            self.verdicts.append(self.v.dispatch(fake_packed()).result())
        except DeviceLostError as e:
            self.verdicts.append(type(e).__name__)

    def health(self):
        return {norm(self.name, k): tuple(h[key] for key in HEALTH_KEYS)
                for k, h in self.v.executor_health().items()}

    def events(self, kinds):
        return [e for e in self.journal.events()
                if e["seq"] >= self.seq0 and e["kind"] in kinds]

    def placements(self):
        return [norm(self.name, e["device"]) for e in self.events(("bls.dispatch",))]

    def transitions(self):
        return [tuple((k, norm(self.name, e[k])) for k in EVENT_KEYS if k in e)
                for e in self.events(("bls.health", "bls.requeue"))]


def run_script(monkeypatch, steps, n, metrics=(None, None), **kw):
    """Run ``steps`` through both verifiers (``metrics``: the port's and
    the JAX registry); after each step the health records, placements,
    verdicts and journal transitions must agree.  Returns the two sides."""
    from lodestar_tpu.chaos import DeviceLostError as JDeviceLostError

    clock = Clock()
    monkeypatch.setattr(jtv, "time", clock)
    monkeypatch.setattr(tv, "time", clock)
    port = Side("port", port_verifier(n, metrics=metrics[0], **kw), CHAOS, FaultPlan, JOURNAL)
    jax = Side("jax", jax_verifier(n, metrics=metrics[1], **kw), JCHAOS, JFaultPlan, JJOURNAL)
    for i, step in enumerate(steps):
        op, *args = step
        for side in (port, jax):
            if op == "dispatch":
                try:
                    side.dispatch()
                except JDeviceLostError as e:  # the JAX package's own type
                    side.verdicts.append(type(e).__name__)
            elif op == "arm":
                side.arm(*args)
            elif op == "disarm":
                side.chaos.disarm()
            elif op == "mesh_eligible":
                elig = (side.v.sharded_eligible(BUCKET) if side is port
                        else side.v._sharded_eligible(BUCKET))
                side.verdicts.append(("mesh_eligible", elig))
        if op == "clock":
            clock.now += args[0]
        where = f"after step {i} {step}"
        assert port.health() == jax.health(), where
        assert port.placements() == jax.placements(), where
        assert port.verdicts == jax.verdicts, where
        assert port.transitions() == jax.transitions(), where
    return port, jax


@pytest.mark.parametrize("n", [2, 4])
def test_executor_names_are_the_jax_verifiers(n):
    """The keys of ``executor_health()`` and ``device_inflight()`` are the
    JAX verifier's for the same devices: the cards by executor index, the
    mesh pseudo-executor by name, ``mesh{n}``, letter for letter."""
    port, jax = port_verifier(n, sharded=True), jax_verifier(n, sharded=True)
    assert port._mesh_ex.name == jax._mesh_ex.name == jax_mesh_device_name(n)
    assert ({norm("port", k) for k in port.executor_health()}
            == {norm("jax", k) for k in jax.executor_health()})
    assert jax_mesh_device_name(n) in port.executor_health()
    # a mesh batch in flight: the port's key is the name the JAX verifier
    # files the same batch under in its in-flight table
    pending = (port.dispatch(fake_packed()), jax.dispatch(fake_packed()))
    assert set(port.device_inflight()) == {e["device"] for e in JINFLIGHT.snapshot()} == {
        jax_mesh_device_name(n)}
    assert [p.result() for p in pending] == [True, True]
    # per-card batches on every executor
    port, jax = port_verifier(n), jax_verifier(n)
    pending = [v.dispatch(fake_packed()) for v in (port, jax) for _ in range(n)]
    assert ({norm("port", k) for k in port.device_inflight()}
            == {norm("jax", k) for k in jax.device_inflight()} == {f"ex{i}" for i in range(n)})
    assert [p.result() for p in pending] == [True] * (2 * n)


PARITY_CASES = {
    # a loss on executor 0: the batch is requeued to a survivor
    "requeue_to_a_survivor": (dict(n=3), [
        ("arm", 1, 0), ("dispatch",), ("disarm",), ("dispatch",), ("dispatch",),
        ("dispatch",),
    ]),
    # quarantine at the first failure, no placement on it during the
    # backoff, then one probe batch re-admits it
    "quarantine_backoff_probe": (dict(n=3, threshold=1, backoff=0.5), [
        ("arm", 1, 1), ("dispatch",), ("dispatch",), ("dispatch",), ("disarm",),
        ("dispatch",), ("dispatch",), ("dispatch",), ("dispatch",), ("clock", 0.3),
        ("dispatch",), ("clock", 0.25), ("dispatch",), ("dispatch",), ("dispatch",),
        ("dispatch",),
    ]),
    # every probe fails: the backoff doubles up to its cap, then a probe
    # passes and resets it
    "failed_probe_doubles_the_backoff_to_its_cap": (
        dict(n=2, threshold=1, backoff=0.05, backoff_max=0.15), [
            ("arm", 0, 0), ("dispatch",), ("dispatch",), ("clock", 0.06), ("dispatch",),
            ("dispatch",), ("clock", 0.11), ("dispatch",), ("dispatch",), ("clock", 0.16),
            ("dispatch",), ("dispatch",), ("disarm",), ("clock", 0.16), ("dispatch",),
            ("dispatch",), ("dispatch",),
        ]),
    # both executors lost: the batch raises (no survivor, no native rung),
    # both quarantined, and the pool still places on the soonest
    "fully_quarantined_pool_still_places": (dict(n=2, threshold=1, backoff=30.0), [
        ("arm", 2), ("dispatch",), ("disarm",), ("dispatch",), ("dispatch",),
        ("clock", 31.0), ("dispatch",), ("dispatch",), ("dispatch",),
    ]),
    # a lost mesh batch is requeued to one executor; the quarantined mesh
    # is not eligible until its backoff ends, then one probe re-admits it
    "mesh_record_gates_sharded_eligible": (dict(n=2, threshold=1, backoff=1.0, sharded=True), [
        ("mesh_eligible",), ("arm", 1, "mesh"), ("dispatch",), ("disarm",),
        ("mesh_eligible",), ("dispatch",), ("dispatch",), ("clock", 1.1),
        ("mesh_eligible",), ("dispatch",), ("mesh_eligible",), ("dispatch",),
    ]),
}


@pytest.mark.parametrize("case", list(PARITY_CASES))
def test_health_machine_equals_the_jax_verifiers(case, monkeypatch):
    kw, steps = PARITY_CASES[case]
    port, jax = run_script(monkeypatch, steps, **kw)
    assert port.v.batches_requeued == jax.v.batches_requeued
    # every case exercises the machine: a failure, then the state it leads to
    states = {s for t in port.transitions() for k, s in t if k == "state"}
    assert SUSPECT in states or QUARANTINED in states
    if case != "requeue_to_a_survivor":
        assert QUARANTINED in states
    if case in ("quarantine_backoff_probe", "failed_probe_doubles_the_backoff_to_its_cap",
                "mesh_record_gates_sharded_eligible"):
        assert PROBING in states and HEALTHY in states


def test_failed_probe_backoff_reaches_its_cap(monkeypatch):
    kw, steps = PARITY_CASES["failed_probe_doubles_the_backoff_to_its_cap"]
    port, _ = run_script(monkeypatch, steps[:12], **kw)
    ex = port.v._executors[0].health
    # 0.05, then doubled by each failed probe: 0.1, 0.15 (capped), 0.15
    assert ex.state == QUARANTINED and ex.quarantines == 4
    assert ex.backoff_s == pytest.approx(0.15)


# -- exactly-once release, the seams -------------------------------------------


def test_raise_frees_the_slot_once_and_resolves_the_inflight_entry():
    v = port_verifier(1)
    CHAOS.install(FaultPlan(0).add("device.loss"))
    pend = v.dispatch(fake_packed())
    assert len(INFLIGHT) == 1 and INFLIGHT.snapshot()[0]["device"] == "cpu"
    with pytest.raises(DeviceLostError):
        pend.result()
    assert len(INFLIGHT) == 0, "in-flight entry not resolved on raise"
    assert v.device_inflight() == {"cpu": 0}, "slot not freed exactly once"
    with pytest.raises(DeviceLostError):
        pend.result()  # the same failure; no second sync, no second release
    assert v.device_inflight() == {"cpu": 0} and len(INFLIGHT) == 0
    assert v.batches_requeued == 0 and v.executor_health()["cpu"]["state"] == SUSPECT
    CHAOS.disarm()
    assert v.dispatch(fake_packed()).result() is True
    assert v.executor_health()["cpu"]["state"] == HEALTHY


def test_success_path_release_is_exactly_once():
    v = port_verifier(2)
    pend = v.dispatch(fake_packed(), deadline=time.monotonic() + 5.0)
    entry = INFLIGHT.snapshot()[0]
    assert 4.0 < entry["deadline_s"] <= 5.0 and pend.deadline is not None
    assert not pend.done_hint()
    assert pend.result() is True and pend.result() is True and pend.done_hint()
    assert v.device_inflight() == {"cpu": 0} and len(INFLIGHT) == 0
    dispatch = [e for e in JOURNAL.tail(8) if e["kind"] == "bls.dispatch"][-1]
    assert dispatch["device"] == "cpu" and 4.0 < dispatch["deadline_headroom_s"] <= 5.0


def test_disarmed_seams_never_reach_the_controller(monkeypatch, tmp_path):
    def poisoned(*a, **k):
        raise AssertionError("disarmed seam called into the controller")

    monkeypatch.setattr(CHAOS, "fire", poisoned)
    monkeypatch.setattr(CHAOS, "maybe_raise", poisoned)
    v = port_verifier(2)
    assert v.dispatch(fake_packed()).result() is True
    from lodestar_tpu_torch.forensics.bundle import write_bundle

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("LODESTAR_TPU_PROBE", "1")
    path = write_bundle(str(tmp_path), "probe", verifier=v)
    with open(os.path.join(path, "manifest.json")) as f:
        assert "errors" not in json.load(f)
    with open(os.path.join(path, "topology.json")) as f:
        topology = json.load(f)
    # the card's topology only once CUDA is up: a bundle never initializes it
    assert topology["cuda_initialized"] is torch.cuda.is_initialized() is False
    assert "devices" not in topology
    with open(os.path.join(path, "config.json")) as f:
        env = json.load(f)["env"]
    assert env["LODESTAR_TPU_PROBE"] == "1" and "JAX_PLATFORMS" not in env
    with open(os.path.join(path, "inflight.json")) as f:
        stats = json.load(f)["verifier"]
    assert set(stats["health"]) == {"cpu", "cpu#1"} and stats["batches_requeued"] == 0


@pytest.mark.parametrize("devices", [["cuda:0", "cpu"], ["cpu", "cuda:0"],
                                     ["cuda:0", "cuda:0", "meta"]])
def test_cards_beside_other_devices_are_refused(devices, monkeypatch):
    # a requeue must never move a card's failed batch off the cards
    monkeypatch.setattr(tv, "resolve_device", torch.device)
    with pytest.raises(ValueError, match="cards beside other devices"):
        TorchBlsVerifier(devices=devices)
    assert TorchBlsVerifier(devices=["cpu", "meta"]).n_executors == 2


def test_an_enqueue_failure_raises_frees_the_slot_and_is_not_requeued():
    v = port_verifier(2, threshold=1)
    CHAOS.install(FaultPlan(0).add("bls.compile", match={"device": "cpu"}))
    with pytest.raises(InjectedCompileError):
        v.dispatch(fake_packed())
    assert v.device_inflight() == {"cpu": 0} and len(INFLIGHT) == 0
    assert v.batches_requeued == 0
    assert v.executor_health()["cpu"]["state"] == QUARANTINED
    CHAOS.disarm()
    assert v.dispatch(fake_packed()).result() is True  # cpu#1 takes it
    # a mesh enqueue failure is the tier's: recorded against nothing
    mesh = port_verifier(2, sharded=True)
    CHAOS.install(FaultPlan(0).add("bls.compile", match={"sharded": True}))
    with pytest.raises(InjectedCompileError):
        mesh.dispatch(fake_packed())
    assert mesh.device_inflight() == {jax_mesh_device_name(2): 0} and mesh.dispatches == 0
    assert {h["state"] for h in mesh.executor_health().values()} == {HEALTHY}


def test_requeue_span_and_wedge_leave_their_evidence(tmp_path):
    """The requeue span names both ends; a wedged batch ages in the
    in-flight table, where the watchdog flags it and dumps a bundle."""
    tracing.enable(1024)
    v = port_verifier(2)
    CHAOS.install(FaultPlan(0).add("device.loss", match={"device": "cpu"}, count=1))
    assert v.dispatch(fake_packed()).result() is True
    span = [s for s in TRACER.spans() if s.name == "bls.requeue"][0]
    assert span.args == {"from_device": "cpu", "to_device": "cpu#1"}
    assert [s.args["device"] for s in TRACER.spans() if s.name == "bls.dispatch"] == [
        "cpu", "cpu#1"]
    RECORDER.configure(verifier=v)
    CHAOS.install(FaultPlan(0).add("device.wedge", wedge_s=0.0, count=1))
    pend = v.dispatch(fake_packed())
    dog = Watchdog(deadline_s=0.0, on_stall=lambda e: RECORDER.dump("watchdog"))
    stalled = dog.check_once()
    assert [e["device"] for e in stalled] == [pend.device]
    assert pend.result() is True  # the wedge turned loss was requeued
    bundle = [n for n in os.listdir(RECORDER.dir) if n.startswith("bundle-watchdog")]
    assert bundle
    inspect_bundle = load_tool("inspect_bundle")
    path = os.path.join(RECORDER.dir, bundle[0])
    assert inspect_bundle.validate(path) == []
    health = inspect_bundle.summarize(path)["chaos"]["executor_health"]
    assert set(health) == {"cpu", "cpu#1"}


# -- a real requeue at bucket 4 ------------------------------------------------


def _sets(n, tag):
    out = []
    for i in range(n):
        sk = interop_secret_key(i)
        msg = b"health %s %d" % (tag, i)
        out.append(SingleSignatureSet(PublicKey.from_bytes(sk.to_public_key().to_bytes()),
                                      msg, sk.sign(msg).to_bytes()))
    return out


def test_a_lost_batch_is_requeued_and_verified_on_the_other_executor():
    """The fused split program's plain versions at bucket 4: a valid and a
    corrupted batch, each lost on executor 0, are replayed on executor 1
    from their packed payload (no second pack) and give True, False."""
    v = TorchBlsVerifier(devices=["cpu", "cpu"], buckets=(BUCKET,),
                         rng=np.random.default_rng(14))
    sets = _sets(BUCKET, b"valid")
    bad = list(sets)
    bad[2] = SingleSignatureSet(bad[2].pubkey, bad[2].signing_root, sets[3].signature)
    for batch, want in ((sets, True), (bad, False)):
        CHAOS.install(FaultPlan(0).add("device.loss", match={"device": "cpu"}, count=1))
        v._rr = 0  # the first placement goes to executor 0
        packs = v.pack_cache_hits + v.pack_cache_misses
        pend = v.verify_signature_sets_async(batch)
        assert pend.device == "cpu"
        assert pend.result() is want
        assert v.pack_cache_hits + v.pack_cache_misses - packs == 2 * BUCKET  # one pack
        v.executor_health()  # readable after each batch
        v._executors[0].health.state = HEALTHY  # back in the rotation for the next
    assert v.batches_requeued == 2 and v.dispatches == 4
    assert v.host_final_exps == 2  # a swapped signature passes the ok bits
    assert v.device_inflight() == {"cpu": 0, "cpu#1": 0} and len(INFLIGHT) == 0
    requeues = [e for e in JOURNAL.tail(64) if e["kind"] == "bls.requeue"][-2:]
    assert [e["from_device"] for e in requeues] == ["cpu", "cpu"]


# -- metrics -------------------------------------------------------------------


def _sample_lines(text, side):
    keep = ("lodestar_bls_batch_requeues_total", "lodestar_bls_device_quarantines_total",
            "lodestar_bls_device_health")
    return sorted(norm(side, line) for line in text.decode().splitlines()
                  if line.startswith(keep))


def test_metrics_text_equals_the_jax_registrys(monkeypatch):
    pytest.importorskip("prometheus_client")
    from lodestar_tpu.metrics import create_metrics as jax_metrics

    from lodestar_tpu_torch.metrics import create_metrics

    kw, steps = PARITY_CASES["quarantine_backoff_probe"]
    pm, jm = create_metrics(), jax_metrics()
    run_script(monkeypatch, steps + [("arm", 1), ("dispatch",), ("disarm",)],
               metrics=(pm, jm), **kw)
    got, want = _sample_lines(pm.reg.expose(), "port"), _sample_lines(jm.reg.expose(), "jax")
    assert got == want
    assert "lodestar_bls_batch_requeues_total 2.0" in got
    assert any(line.startswith('lodestar_bls_device_quarantines_total{device="ex1"}')
               for line in got)


def test_without_prometheus_client_every_metric_is_a_no_op(monkeypatch):
    monkeypatch.setattr(mreg, "HAVE_PROM", False)
    m = mreg.create_metrics()
    assert isinstance(m.bls_batch_requeues_total, mreg._NoopMetric)
    assert isinstance(m.bls_device_health, mreg._NoopMetric)
    v = port_verifier(2, threshold=1, metrics=m)
    CHAOS.install(FaultPlan(0).add("device.loss", count=1))
    assert v.dispatch(fake_packed()).result() is True
    assert v.batches_requeued == 1 and m.reg.expose() == b""


# -- bundles -------------------------------------------------------------------


def test_one_quarantine_bundle_per_cooldown(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(tv, "time", clock)
    v = port_verifier(2, threshold=1, backoff=0.05)
    CHAOS.install(FaultPlan(0).add("device.loss", match={"device": "cpu"}, count=0))
    for _ in range(4):  # quarantined, then every probe fails again
        assert v.dispatch(fake_packed()).result() is True
        clock.now += 1.0
    assert v._executors[0].health.quarantines >= 2
    bundles = [n for n in os.listdir(RECORDER.dir) if n.startswith("bundle-quarantine-cpu-")]
    assert len(bundles) == 1
    clock.now += v._dump_cooldown_s
    assert v.dispatch(fake_packed()).result() is True
    assert v.dispatch(fake_packed()).result() is True
    bundles = [n for n in os.listdir(RECORDER.dir) if n.startswith("bundle-quarantine-cpu-")]
    assert len(bundles) == 2


@pytest.mark.parametrize("side", ["port", "jax"])
def test_inspect_bundle_reads_the_ports_bundle_as_the_jax_one(side):
    """As the JAX package's chaos triage test: the summary names the
    fault, the requeues and the quarantined executor, for either
    package's bundle."""
    inspect_bundle = load_tool("inspect_bundle")
    if side == "port":
        v, recorder, chaos, plan = port_verifier(2, threshold=1, backoff=5.0), RECORDER, CHAOS, \
            FaultPlan
    else:
        v, recorder, chaos, plan = jax_verifier(2, threshold=1, backoff=5.0), JRECORDER, \
            JCHAOS, JFaultPlan
    recorder.configure(verifier=v)
    target = v._executors[1].name
    chaos.install(plan(11).add("device.loss", match={"device": target}, count=1))
    for _ in range(4):
        assert v.dispatch(fake_packed()).result() is True
        if v.executor_health()[target]["state"] == QUARANTINED:
            break
    path = recorder.dump("chaos-triage-probe")
    chaos.disarm()
    assert inspect_bundle.validate(path) == []
    ch = inspect_bundle.summarize(path)["chaos"]
    assert ch["armed"] is True and ch["seed"] == 11
    assert ch["last_fault"]["seam"] == "device.loss"
    assert ch["requeued_batches"] >= 1
    assert ch["executor_health"][target]["state"] == QUARANTINED
    assert QUARANTINED in [e["state"] for e in ch["health_timeline"]]
    inspect_bundle._print_text(inspect_bundle.summarize(path))


# -- the pool's deadline -------------------------------------------------------


class _DeadlineVerifier:
    """Records the deadline each merged batch is handed."""

    n_devices = 1

    def __init__(self):
        self.seen = []

    def verify_signature_sets_async(self, sets, deadline=None):
        self.seen.append((len(sets), deadline))
        return PendingVerdict(value=True)

    def verify_signature_sets(self, sets):
        return True


def test_the_merged_batchs_tightest_deadline_reaches_the_verifier():
    v = _DeadlineVerifier()

    async def main():
        pool = BlsBatchPool(v, max_buffer_wait=0.01, flush_threshold=64)
        now = time.monotonic()
        jobs = [pool.verify_signature_sets([object()] * 2, deadline=now + 30.0),
                pool.verify_signature_sets([object()] * 3, deadline=now + 20.0),
                pool.verify_signature_sets([object()])]
        results = await asyncio.gather(*jobs)
        pool.close()
        return now, results

    now, results = asyncio.run(main())
    assert results == [True] * 3
    assert len(v.seen) == 1 and v.seen[0][0] == 6
    assert v.seen[0][1] == pytest.approx(now + 20.0)


def test_the_pool_passes_no_deadline_to_a_verifier_that_takes_none():
    class NoDeadline(_DeadlineVerifier):
        def verify_signature_sets_async(self, sets):
            self.seen.append((len(sets), None))
            return PendingVerdict(value=True)

    v = NoDeadline()

    async def main():
        pool = BlsBatchPool(v, max_buffer_wait=0.01)
        out = await pool.verify_signature_sets([object()], deadline=time.monotonic() + 5)
        pool.close()
        return out

    assert asyncio.run(main()) is True and v.seen == [(1, None)]
