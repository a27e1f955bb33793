"""CPU tests of the meeting's per-layer metrics (``meet_lock_ms``,
``meet_wake_ms``, ``body_gap_ms``) and of ``meetspans``, which reads
them from the port's trace dumps.  Run with ``python -m pytest
portbench/tests -q``."""

import json
import os
import time
from types import SimpleNamespace

import pytest

from portbench import harness, meetspans, spec
from portbench.spec import ROOT

MS = 1_000_000
NEW = ("meet_lock_ms", "meet_wake_ms", "body_gap_ms")
WALL = 1000.0       # the stand-in dumps' anchor: wall s at perf ns 0


def _dump(path, rows, capacity=100, dropped=0):
    """A rank's dump as the port writes it, holding ``rows``: name ->
    (start ns, end ns, cid, seq, nbytes or the card)."""
    events = []
    for name, spans in rows.items():
        third = "card" if name == "meet_device" else "nbytes"
        for s, e, cid, seq, x in spans:
            events.append({"name": name, "cat": "meet", "ph": "X",
                           "ts": WALL + s * 1e-9, "dur": (e - s) * 1e-9,
                           "args": {"cid": cid, "seq": seq, third: x}})
    doc = {"rank": 0, "capacity": capacity,
           "anchor": {"wall_s": WALL, "perf_ns": 0},
           "dropped_by_cat": {"meet": dropped}, "events": events}
    with open(path, "w") as fh:
        json.dump(doc, fh)


@pytest.fixture
def dumps(monkeypatch, tmp_path):
    """Point meetspans at a fresh template; returns a writer of rank
    ``r``'s stand-in dump."""
    monkeypatch.setattr(meetspans, "DUMPS", str(tmp_path / "t-r%r.json"))
    meetspans._read.cache_clear()

    def write(r, rows, **kw):
        _dump(meetspans.paths(r + 1)[r], rows, **kw)
    yield write
    meetspans._read.cache_clear()


def _run(nranks=2, window=(0, 100 * MS), ops=2):
    return SimpleNamespace(nranks=nranks, window_ns=window, ops=ops,
                           dev=None)


def _world(write):
    """Two ranks, two ops a = (1, 0) and b = (1, 1).  Op a: rank 1
    triggers and posts at 10 ms; rank 0 waited 4..12 in finish.  Op b:
    rank 0 triggers and posts at 30 ms; rank 1 waited 25..31.  Bodies
    on card 0: 10..16 and 31..37 (a 15 ms gap), then one that queued
    behind b (starts at 37)."""
    write(0, {
        "meet_lock": [(1 * MS, 2 * MS, 1, 0, 8), (3 * MS, 4 * MS, 1, 0, 8),
                      (20 * MS, 21 * MS, 1, 1, 8),
                      (30 * MS, 33 * MS, 1, 1, 8)],
        # op a: begin's wait, then finish's (the later one counts)
        "meet_wait": [(2 * MS, 2 * MS, 1, 0, 8), (4 * MS, 12 * MS, 1, 0, 8),
                      (21 * MS, 22 * MS, 1, 1, 8),
                      (33 * MS, 34 * MS, 1, 1, 8)],
        "meet_post": [(30 * MS, 30 * MS, 1, 1, 8)],
        "meet_device": [(31 * MS, 37 * MS, 1, 1, 0),
                        (37 * MS, 40 * MS, 1, 2, 0)],
    })
    write(1, {
        "meet_lock": [(5 * MS, 7 * MS, 1, 0, 8), (11 * MS, 12 * MS, 1, 0, 8),
                      (24 * MS, 25 * MS, 1, 1, 8),
                      (25 * MS, 25 * MS, 1, 1, 8)],
        # op b's waits as the phase ctx writes them
        "ph_rdv_wait": [(24 * MS, 24 * MS, 1, 1, 8),
                        (25 * MS, 31 * MS, 1, 1, 8)],
        "meet_wait": [(7 * MS, 8 * MS, 1, 0, 8), (12 * MS, 13 * MS, 1, 0, 8)],
        "meet_post": [(10 * MS, 10 * MS, 1, 0, 8)],
        "meet_device": [(10 * MS, 16 * MS, 1, 0, 0)],
    })


def test_meet_lock_is_a_mean_an_op_a_rank(dumps):
    _world(dumps)
    read = spec.load_reader("meet_lock_ms")
    # rank 0: a 1 + 1, b 1 + 3; rank 1: a 2 + 1, b 1 + 0
    assert read(_run()) == pytest.approx((2 + 4 + 3 + 1) / 4)


def test_meet_wake_counts_the_waits_that_began_before_the_post(dumps):
    _world(dumps)
    read = spec.load_reader("meet_wake_ms")
    # op a: rank 0's finish wait (4..12) ends 2 ms after the post at 10;
    # rank 1 posted a and its wait began after.  Op b: rank 1's finish
    # wait (25..31, a ph_rdv_wait) ends 1 ms after the post at 30
    assert read(_run()) == pytest.approx((2 + 1) / 2)


def test_body_gap_is_the_idle_before_each_body_on_its_card(dumps):
    _world(dumps)
    read = spec.load_reader("body_gap_ms")
    # 16 -> 31: 15 ms idle; 37 -> 37: queued (0)
    assert read(_run()) == pytest.approx((15 + 0) / 2)
    # a body outside the window is left out (another run: new dumps)
    _world(dumps)
    assert read(_run(window=(0, 38 * MS))) == pytest.approx(15.0)


def test_readers_report_nothing_without_the_programs_spans(dumps):
    """No dumps (a checkout before the meeting's spans, or an untraced
    run), a world of another size, a full ring, a dropped device pair
    or a window with no span: every new reader returns None and none
    raises."""
    reads = [spec.load_reader(n) for n in NEW]
    assert [r(_run()) for r in reads] == [None] * 3
    for run in (_run(nranks=3), _run(window=(90 * MS, 95 * MS))):
        _world(dumps)
        meetspans._read.cache_clear()
        assert [r(run) for r in reads] == [None] * 3
    for kw in ({"capacity": 4}, {"dropped": 1}):
        _world(dumps)
        dumps(1, {"meet_lock": [(1 * MS, 2 * MS, 1, 0, 8)] * 4}, **kw)
        meetspans._read.cache_clear()
        assert [r(_run()) for r in reads] == [None] * 3


def test_the_first_read_takes_the_dumps_away(dumps):
    """A run's first read removes its dumps; the other readers of the
    run get the same spans; the next run's dumps are read anew."""
    _world(dumps)
    got = meetspans.spans(_run())
    assert not any(os.path.exists(p) for p in meetspans.paths(2))
    assert meetspans.spans(_run()) is got
    assert [len(per["meet_lock"]) for per in got] == [4, 4]
    assert got[0]["meet_device"][0] == (31 * MS, 37 * MS, (1, 1), 0)
    dumps(0, {"meet_lock": [(1 * MS, 3 * MS, 2, 0, 8)]})
    dumps(1, {"meet_lock": [(1 * MS, 5 * MS, 2, 0, 8)]})
    assert spec.load_reader("meet_lock_ms")(_run(window=(0, 99 * MS))) \
        == pytest.approx(3.0)


def test_loading_points_the_port_dump_at_this_process():
    """Loading the readers sets the port's ``trace_dump_path`` to a
    template of this process's own in the temporary directory."""
    from ompi_tpu_torch.mca.params import registry
    spec.resolve("colo8.allreduce-1g")
    got = registry.get("trace_dump_path")
    assert got == meetspans.DUMPS and "%r" in got
    assert str(os.getpid()) in got and os.path.dirname(got) == \
        os.path.dirname(meetspans.paths(1)[0])


def test_the_new_metrics_are_declared_for_the_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    got = {m["name"]: m for m in bench["per_layer"]}
    old = [m["name"] for m in bench["per_layer"]][:4]
    assert old == ["rdv_wait_ms", "kernel_roofline_pct", "device_idle_pct",
                   "busbw_traced_GBps"]
    for name in NEW:
        m = got[name]
        assert (m["source"], m["moves"], m["workloads"], m["unit"]) == (
            "program_span", "busbw_GBps", ["colo8.allreduce-1g"], "ms")
    layers = {m["layer"] for m in bench["per_layer"]}
    assert got["meet_lock_ms"]["layer"] == got["meet_wake_ms"]["layer"] \
        == got["rdv_wait_ms"]["layer"]
    assert got["body_gap_ms"]["layer"] in layers
    cell = spec.resolve("colo8.allreduce-1g")
    assert set(NEW) <= set(cell.readers)


def test_a_cpu_run_reads_the_meeting_from_the_port():
    """A short traced rehearsal of the cell on the CPU, in this
    process: the ranks' dumps give ``meet_lock_ms`` and
    ``meet_wake_ms``; ``body_gap_ms`` needs a card's events."""
    cell = spec.resolve("colo8.allreduce-1g")
    meetspans._read.cache_clear()
    run, _, numbers, _ = harness.execute(cell, 2**31 + 5, 0.5, True, True,
                                         16384, time.perf_counter())
    assert all(os.path.exists(p) for p in meetspans.paths(8))
    assert numbers["bad"] == 0 and not run.phase_lost
    got = meetspans.spans(run)
    assert len(got) == 8
    posts = sum(len(per["meet_post"]) for per in got)
    assert posts == len({op for per in got for _, _, op, _ in
                         per["meet_lock"]})
    lock = cell.readers["meet_lock_ms"](run)
    wake = cell.readers["meet_wake_ms"](run)
    assert lock is not None and lock >= 0
    assert wake is not None and wake >= 0
    assert cell.readers["body_gap_ms"](run) is None
