"""The port's device sampler (``observatory/device_sampler.py``) held
against the JAX package's on the CPU.

The cases of ``tests/test_observatory.py``'s sampler section run through
both modules over the same fake devices, in-flight registrations and
journal cadence, and give equal samples, gauge lines and journal events.
The JAX sampler is given the fake devices; the port's sampler is given
executors (a name and a device, as the verifier's ``DeviceExecutor``)
named as the JAX sampler names the devices, and a reader that calls the
same fake's ``memory_stats()``.  The port's own differences each have a
case: rows by executor, two executors of one card sharing one reading a
tick, the default reader's mapping of ``torch.cuda.memory_stats`` onto the
JAX kinds, and no memory row for a CPU executor.
"""

import types

import pytest
import torch

from lodestar_tpu.forensics.journal import EventJournal as JEventJournal
from lodestar_tpu.forensics.watchdog import InflightTable as JInflightTable
from lodestar_tpu.metrics import create_metrics as jax_create_metrics
from lodestar_tpu.observatory.device_sampler import DeviceSampler as JDeviceSampler
from lodestar_tpu.observatory.device_sampler import device_name
from lodestar_tpu_torch.crypto.bls.torch_verifier import TorchBlsVerifier
from lodestar_tpu_torch.forensics.journal import EventJournal
from lodestar_tpu_torch.forensics.watchdog import InflightTable
from lodestar_tpu_torch.metrics import create_metrics
from lodestar_tpu_torch.observatory import device_sampler as ds

from test_observatory import FakeDevice


def executors(devices):
    return [types.SimpleNamespace(name=device_name(d), device=d) for d in devices]


def fake_reader(device):
    return device.memory_stats()


def pair(devices, **kw):
    """(port sampler, its in-flight table, journal, metrics; the same for
    the JAX sampler) over ``devices``."""
    port = (InflightTable(), EventJournal(64), create_metrics())
    jax = (JInflightTable(), JEventJournal(64), jax_create_metrics())
    ps = ds.DeviceSampler(executors=executors(devices), inflight=port[0], journal=port[1],
                          metrics=port[2], reader=fake_reader, **kw)
    js = JDeviceSampler(devices=devices, inflight=jax[0], journal=jax[1], metrics=jax[2], **kw)
    return (ps,) + port, (js,) + jax


def gauges(metrics):
    return sorted(line for line in metrics.reg.expose().decode().splitlines()
                  if line.startswith(("lodestar_bls_device_hbm_bytes{",
                                      "lodestar_bls_device_busy_ratio{")))


def events(journal):
    return [{k: v for k, v in e.items() if k not in ("ts_ns", "wall", "seq", "thread")}
            for e in journal.events()]


def test_hbm_and_busy_metrics():
    devs = [
        FakeDevice(0, stats={"bytes_in_use": 1 << 30, "bytes_limit": 16 << 30,
                             "peak_bytes_in_use": 2 << 30, "ignored_key": "x"}),
        FakeDevice(1, stats=None),  # CPU-style: no stats, no error
    ]
    port, jax = pair(devs, interval_s=0.05, window=4, journal_every=2)
    samples = {}
    for side in (port, jax):
        s, inflight = side[0], side[1]
        tok = inflight.register(cid=7, device="tpu:0", bucket=128, sets=100)
        out = [s.tick()]  # tpu:0 busy, tpu:1 idle
        inflight.resolve(tok)
        out += [s.tick(), s.tick()]
        samples[side is port] = out
    assert samples[True] == samples[False]
    sample = samples[True][-1]
    assert sample["devices"]["tpu:0"]["busy_ratio"] == pytest.approx(1 / 3, abs=1e-3)
    assert sample["devices"]["tpu:1"]["busy_ratio"] == 0.0
    assert sample["devices"]["tpu:0"]["hbm"]["bytes_in_use"] == 1 << 30
    assert "ignored_key" not in sample["devices"]["tpu:0"]["hbm"]
    assert "hbm" not in sample["devices"]["tpu:1"]
    assert gauges(port[3]) == gauges(jax[3])
    assert 'lodestar_bls_device_busy_ratio{device="tpu:1"} 0.0' in gauges(port[3])
    assert events(port[2]) == events(jax[2])
    assert "telemetry.sample" in [e["kind"] for e in events(port[2])]


def test_memory_stats_failure_is_not_fatal():
    port, jax = pair([FakeDevice(0, raise_stats=True)])
    assert port[0].tick() == jax[0].tick()
    assert "hbm" not in port[0].tick()["devices"]["tpu:0"]


def test_default_executor_load_lands_on_first_device():
    port, jax = pair([FakeDevice(0), FakeDevice(1)])
    out = []
    for side in (port, jax):
        tok = side[1].register(device="default")
        out.append(side[0].tick())
        side[1].resolve(tok)
    assert out[0] == out[1]
    assert "default" not in out[0]["devices"]
    assert out[0]["devices"]["tpu:0"]["busy"] is True and out[0]["devices"]["tpu:0"]["inflight"] == 1
    assert out[0]["devices"]["tpu:1"]["busy"] is False


def test_inflight_only_device_gets_a_row():
    port, jax = pair([])
    out = []
    for side in (port, jax):
        tok = side[1].register(device="stub:0")
        out.append(side[0].tick())
        side[1].resolve(tok)
    assert out[0] == out[1] and out[0]["devices"]["stub:0"]["busy"] is True


def test_overhead_self_accounting():
    """Measured, not promised: work_seconds accumulates per tick and
    overhead_ratio() divides by the elapsed wall (loose bounds: a shared
    machine stalls threads)."""
    import time

    port, jax = pair([FakeDevice(0), FakeDevice(1)], interval_s=0.05)
    for side in (port, jax):
        s = side[0]
        assert s.overhead_ratio() is None
        s.start()
        try:
            time.sleep(0.3)
        finally:
            s.stop()
        assert not s.running and s.ticks >= 2
        assert s.work_seconds / s.ticks < 0.02
        ratio = s.overhead_ratio()
        assert ratio is not None and ratio < 0.5
        snap = s.snapshot()
        # the ratio's denominator grows with the wall between the reads
        assert snap["overhead_ratio"] == pytest.approx(ratio, rel=0.05)
        assert "tpu:0" in snap["devices"]
    assert set(port[0].snapshot()) == set(jax[0].snapshot())
    assert ([e["kind"] for e in events(port[2])][:1] == [e["kind"] for e in events(jax[2])][:1]
            == ["telemetry.start"])


class CountingReader:
    def __init__(self, stats):
        self.stats, self.calls = stats, []

    def __call__(self, device):
        self.calls.append(device)
        return self.stats if getattr(device, "type", None) == "cuda" else None


def test_rows_are_the_verifiers_executors_sharing_a_cards_reading():
    """The port's rows: one per executor of the verifier, named as the
    verifier registers its batches in the in-flight table; two executors
    of one card share one reading a tick; a CPU executor has no memory
    row."""
    card = torch.device("cuda", 0)
    exs = [types.SimpleNamespace(name="cuda:0", device=card),
           types.SimpleNamespace(name="cuda:0#1", device=card),
           types.SimpleNamespace(name="cpu", device=torch.device("cpu"))]
    reader = CountingReader({"bytes_in_use": 5, "bytes_limit": 80})
    inflight = InflightTable()
    s = ds.DeviceSampler(executors=exs, inflight=inflight, journal=EventJournal(8), reader=reader)
    tok = inflight.register(device="cuda:0#1")
    sample = s.tick()
    inflight.resolve(tok)
    assert list(sample["devices"]) == ["cuda:0", "cuda:0#1", "cpu"]
    assert sample["devices"]["cuda:0"]["hbm"] == sample["devices"]["cuda:0#1"]["hbm"] == {
        "bytes_in_use": 5, "bytes_limit": 80}
    assert "hbm" not in sample["devices"]["cpu"]
    assert [r["busy"] for r in sample["devices"].values()] == [False, True, False]
    assert reader.calls == [card, torch.device("cpu")]  # the card read once a tick
    # the verifier's own executors give the rows
    v = TorchBlsVerifier(devices=["cpu"] * 2)
    rows = ds.DeviceSampler(executors=v._executors, inflight=InflightTable()).tick()["devices"]
    assert list(rows) == ["cpu", "cpu#1"] and all("hbm" not in r for r in rows.values())


def test_the_default_reader_maps_the_allocators_counters(monkeypatch):
    """``torch.cuda.memory_stats`` -> the JAX kinds, the total memory read
    once a card, nothing for a device that is not a card; a tick takes no
    other CUDA call (no sync, no allocation)."""
    stats = {"allocated_bytes.all.current": 10, "allocated_bytes.all.peak": 30,
             "reserved_bytes.all.current": 64, "num_alloc_retries": 0}
    calls = []
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: calls.append(("stats", d)) or stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: calls.append(("props", d)) or types.SimpleNamespace(
                            total_memory=80 << 30))
    for name in ("synchronize", "empty_cache", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: pytest.fail(f"tick called {name}"))
    card = torch.device("cuda", 0)
    reader = ds.CudaMemoryReader()
    want = {"bytes_in_use": 10, "peak_bytes_in_use": 30, "bytes_reserved": 64,
            "bytes_limit": 80 << 30}
    assert reader(card) == want and reader(card) == want
    assert reader(torch.device("cpu")) is None
    assert calls == [("stats", card), ("props", card), ("stats", card)]
    metrics = create_metrics()
    s = ds.DeviceSampler(executors=[types.SimpleNamespace(name="cuda:0", device=card)],
                         inflight=InflightTable(), metrics=metrics, reader=reader)
    assert s.tick()["devices"]["cuda:0"]["hbm"] == {
        k: want[k] for k in ds.HBM_KINDS if k in want}
    assert 'lodestar_bls_device_hbm_bytes{device="cuda:0",kind="bytes_limit"}' in "\n".join(
        gauges(metrics))


def test_the_process_wide_sampler_slot():
    from lodestar_tpu_torch.observatory import get_sampler

    assert get_sampler() is None
    s = ds.start_sampler(interval_s=0.05, executors=[], inflight=InflightTable())
    try:
        assert get_sampler() is s and s.running
        t = ds.start_sampler(interval_s=0.05, executors=[], inflight=InflightTable())
        assert not s.running and get_sampler() is t
    finally:
        ds.stop_sampler()
    assert get_sampler() is None
