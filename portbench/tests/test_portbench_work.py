"""The frozen work table: each bucket's multiply-adds and bytes, and the
bound they give at the card's peaks."""

import pytest

from portbench import devtrace, work


def test_macs_per_row_is_chip_smokes_arithmetic():
    assert work.MACS_PER_ROW["mul"] == 2 * work._LOADF + work._MUL
    assert work._MUL == 2500 + (99 + 2 - 49) * 50
    assert work._LOADF == (50 + 2 - 49) * 50
    assert work._SMALL == (50 + 1 - 49) * 50


def test_census_work():
    got = work.census_work({"mul": {"128": 2, "256": 1}, "lad1": {"4": 1}})
    macs = work.MACS_PER_ROW["mul"] * 512 + work.MACS_PER_ROW["lad1"] * 4
    nbytes = 4 * 512 * 50 * 3 + 4 * 4 * 100 * 14
    assert got == {"macs": macs, "bytes": nbytes}
    assert work.bound_seconds(got) == max(2 * macs / 33.5e12, nbytes / 3.35e12)


def test_table_totals():
    table = work.load_table()
    assert sorted(table) == [4, 16, 64, 128, 256]
    for b in table:
        assert table[b]["macs"] > 0 and table[b]["bytes"] > 0
    # more lanes, more work
    assert [table[b]["macs"] for b in sorted(table)] == sorted(table[b]["macs"] for b in table)
    assert table == EXPECTED
    # bound by operations at every bucket: 2.39 ms at 128
    assert work.bound_seconds(table[128]) == pytest.approx(2 * 39991206032 / 33.5e12)


EXPECTED = {
    4: {"macs": 1296654864, "bytes": 84964800},
    16: {"macs": 5041288848, "bytes": 329395200},
    64: {"macs": 20019824784, "bytes": 1307116800},
    128: {"macs": 39991206032, "bytes": 2610745600},
    256: {"macs": 79933968528, "bytes": 5218003200},
}


def test_batch_work_is_priced_by_its_sets():
    """A bucket's census is a fixed part plus a part per lane, exactly; a
    batch pays the fixed part and its own sets, its inputs and outputs
    once."""
    table = work.load_table()
    linear = work.linear_work(table)
    assert linear == {"batch": 48443536, "set": 312052832}
    for b in table:
        assert work.batch_work(b, linear)["macs"] == table[b]["macs"]
    five = work.batch_work(5, linear)
    assert five["macs"] == 48443536 + 5 * 312052832
    assert five["bytes"] == 5 * (4 * (10 * 50 + 64) + 1) + 4 * 12 * 50 + 1
    # bound by operations: 0.096 ms, a third of bucket 16's
    assert work.bound_seconds(five) == pytest.approx(2 * five["macs"] / 33.5e12)
    with pytest.raises(ValueError):
        work.linear_work({4: {"macs": 10}, 16: {"macs": 40}, 64: {"macs": 99}})


class _Span:
    def __init__(self, name, ts, dur, tid, **args):
        self.name, self.ts_ns, self.dur_ns, self.tid, self.args = name, ts, dur, tid, args


def test_each_dispatch_takes_the_sets_its_thread_packed_last():
    spans = [
        _Span("bls.pack", 100, 50, 1, sets=5), _Span("bls.dispatch", 160, 10, 1, bucket=16),
        _Span("bls.pack", 120, 60, 2, sets=131), _Span("bls.dispatch", 185, 5, 2, bucket=256),
        _Span("bls.pack", 200, 30, 1, sets=3), _Span("bls.dispatch", 240, 10, 1, bucket=4),
        _Span("bls.dispatch", 300, 10, 3, bucket=4),
    ]
    assert devtrace.dispatch_spans(spans) == [
        (160, 170, 16, 5), (185, 190, 256, 131), (240, 250, 4, 3), (300, 310, 4, None)]
