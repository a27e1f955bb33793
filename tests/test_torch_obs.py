"""The telemetry plane through both packages: ompi_tpu.obs and its port,
ompi_tpu_torch.obs — the session-banded counters and histograms
(``ScopedPvar`` / ``ScopedHist``), the flight recorder (event table,
ring, snapshot, trace dump, the plain-file persist), the rank-local
scraper, the percentile math and the Prometheus text.  The recorder's
events come from the same injected silent-data-corruption run in both
packages (the integrity plane and the ft_inject ``device_sdc``
injector; the port's coll/hbm and mesh on the CPU with the kernels'
plain versions).  The local metrics document over the MPI_T pvar
snapshot, and a node daemon's ``metrics`` request that answers with
it; the memchecker hooks in ob1 (a posted receive poisoned, a send
buffer changed in flight caught); the MPI-IO persist writes the plain
persist's bytes.

Tolerance: exact — counters, bands, buckets, percentiles, event fields
and text; timestamps are compared only for their order.
"""

import json

import jax
import numpy as np
import pytest
import torch

import ompi_tpu.ft_inject  # noqa: F401  (registers the injector knobs)
import ompi_tpu.obs as ref_obs
from ompi_tpu import memchecker as ref_memchecker
from ompi_tpu.datatype import engine as ref_dtmod
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.obs import integrity as ref_ig
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
import ompi_tpu_torch.datatype.engine
import ompi_tpu_torch.ft_inject  # noqa: F401
import ompi_tpu_torch.memchecker
from ompi_tpu_torch import convert
from ompi_tpu_torch import obs
from ompi_tpu_torch import trace as port_trace
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.obs import integrity as ig
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

CPU = torch.device("cpu")
PKGS = ((ref_obs, ref_registry), (obs, port_registry))


# -- per-session attribution -------------------------------------------------

def test_scoped_pvar_matches_reference():
    """The same adds in both packages: the global value, each band, the
    nonzero bands, the snapshot row; bands wrap at MAX_BANDS; the
    factory is idempotent (one wrapper a full name)."""
    assert obs.MAX_BANDS == ref_obs.MAX_BANDS
    adds = [(1, 0), (5, 1), (2, 2), (7, 1), (3, obs.MAX_BANDS + 2), (4, 9)]
    rows = []
    for mod, reg in PKGS:
        sp = mod.scoped_pvar("obstest", "", "adds", help="test counter")
        assert mod.scoped_pvar("obstest", "", "adds") is sp
        g0 = sp.read()
        b0 = {b: sp.read_band(b) for b in range(12)}
        for n, band in adds:
            sp.add(n, band)
        assert sp.full_name == "obstest_adds"
        assert reg._pvars["obstest_adds"] is sp.pvar
        rows.append((sp.read() - g0,
                     {b: sp.read_band(b) - b0[b] for b in range(12)},
                     {b: v for b, v in sp.nonzero_bands().items()
                      if b < 12},
                     mod.scoped_snapshot()["obstest_adds"]["global"] - g0))
    assert rows[0] == rows[1]
    assert rows[1][0] == 22
    assert rows[1][1][2] == 5 and rows[1][1][1] == 12


def test_scoped_hist_matches_reference():
    """Log2 buckets, the lazy band rows, band percentiles and the
    snapshot in both packages."""
    us = [0, 1, 3, 900, 70000, 10 ** 9, 12, 12, 5000]
    snaps = []
    for mod, _ in PKGS:
        h = mod.scoped_hist("obstest_wait_us")
        assert mod.scoped_hist("obstest_wait_us") is h
        for i, u in enumerate(us):
            h.add_us(u, 1 + i % 3)
        snaps.append((list(h.total), h.band_hist(2), h.band_hist(7),
                      [h.band_percentile(b, t) for b in (1, 2, 3)
                       for t in ("p50", "p90", "p99")],
                      mod.scoped_hist_snapshot()["obstest_wait_us"]))
    assert snaps[0] == snaps[1]


def test_current_band_reads_the_rank_state():
    """``current_band`` is the calling rank's cid band (0 outside a
    rank); a band-3 world's flushes land in band 3."""
    assert obs.current_band() == 0
    res = port_run_ranks(2, lambda c: obs.current_band(), cid_band=3)
    assert res == [3, 3]


# -- the flight recorder -----------------------------------------------------

def test_event_table_matches_reference():
    """Every EV_* number, EVENT_NAMES and EVENT_FIELDS."""
    ref = {k: v for k, v in vars(ref_obs).items() if k.startswith("EV_")}
    port = {k: v for k, v in vars(obs).items() if k.startswith("EV_")}
    assert port == ref
    assert obs.EVENT_NAMES == ref_obs.EVENT_NAMES
    assert obs.EVENT_FIELDS == ref_obs.EVENT_FIELDS
    assert len(obs.EVENT_NAMES) == len(obs.EVENT_FIELDS) == 38


def _strip(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


@pytest.mark.parametrize("cap,count", ((8, 5), (8, 8), (8, 21), (3, 10)))
def test_ring_wraps_and_counts_drops(cap, count, monkeypatch):
    """A ring of ``cap`` (at least 8) after ``count`` records: recorded,
    dropped, the live window oldest first and ``last``, as the
    reference's.  Both packages decode '$' fields against empty string
    tables here: the tables are process-global, and what earlier tests
    in the process interned differs between the packages."""
    docs = []
    for mod, _ in PKGS:
        monkeypatch.setattr(mod, "_strings", [])
        monkeypatch.setattr(mod, "_string_ids", {})
        r = mod.FlightRecorder(cap, anchor=(1000.0, 0))
        for i in range(count):
            r.record(i % len(mod.EVENT_NAMES), i, 2 * i, 3, 4, rank=i % 4)
        d = r.trace_dump()
        ts = [e["ts"] for e in d["events"]]
        assert ts == sorted(ts)
        docs.append((r.recorded, r.dropped, d["capacity"], d["rank"],
                     _strip(d["events"]), _strip(r.snapshot(last=3))))
    assert docs[0] == docs[1]
    assert docs[1][1] == max(0, count - max(8, cap))


def test_interned_fields_decode():
    """A '$' field is an interned string, decoded at snapshot."""
    for mod, _ in PKGS:
        r = mod.FlightRecorder(8)
        r.record(mod.EV_FT_INJECT, mod.intern("delay"), mod.intern("coll"))
        (e,) = r.snapshot()
        assert e["name"] == "ft_inject" and e["cat"] == "flight"
        assert e["args"] == {"cls": "delay", "scope": "coll"}


ARM = {"integrity_enable": 1, "integrity_sample": 1,
       "integrity_sample_auto": 0}
INJECT = dict(ARM, **{"ft_inject_plan": "device_sdc:1",
                      "ft_inject_victim_rank": "1",
                      "ft_inject_sdc_period": 1})
PVARS = ("integrity_mismatches", "integrity_convictions",
         "integrity_retry_ops")


class armed:
    """Knobs in both registries, both planes refreshed and cleared;
    restored on exit."""

    def __init__(self, vals) -> None:
        self.vals = vals

    def __enter__(self):
        self.saved = [(reg, {k: reg.get(k) for k in self.vals})
                      for reg in (ref_registry, port_registry)]
        for reg, _ in self.saved:
            for k, v in self.vals.items():
                reg.set(k, v)
        for plane in (ref_ig, ig):
            plane.refresh()
            plane.reset()
        return self

    def __exit__(self, *exc):
        for reg, saved in self.saved:
            for k, v in saved.items():
                reg.set(k, v)
        for plane in (ref_ig, ig):
            plane.refresh()
            plane.reset()


def _mix(comm, put, op):
    r = comm.rank
    out = [comm.allreduce_arr(put(np.full(32, r + 1, np.float32)), op.SUM),
           comm.allreduce_arr(put(np.full(8, (r + 1) * 100, np.int32)),
                              op.MAX)]
    qs = [comm.iallreduce_arr(put(np.full(16, r + 1, np.float32)), op.SUM),
          comm.ibcast_arr(put(np.full(8, r * 2 + 3, np.int32)), 1)]
    for q in qs:
        q.wait()
    return [np.asarray(convert.to_numpy(x) if isinstance(x, torch.Tensor)
                       else x).tobytes() for x in out + [q.result for q in qs]]


RUNS = {
    "hbm": (lambda fn: ref_run_ranks(
                4, lambda c: fn(c, lambda a: jax.device_put(a, c.device),
                                ref_op),
                device_map=lambda r: jax.devices()[0]),
            lambda fn: port_run_ranks(
                4, lambda c: fn(c, lambda a: convert.to_torch(a, c.device),
                                port_op),
                device_map=lambda r: CPU)),
    "mesh": (lambda fn: ref_run_ranks(
                 4, lambda c: fn(c, lambda a: jax.device_put(a, c.device),
                                 ref_op),
                 devices=True),
             lambda fn: port_run_ranks(
                 4, lambda c: fn(c, lambda a: convert.to_torch(a, c.device),
                                 port_op),
                 device_map=logical_devices("cpu"))),
}


def _key(e):
    """An event without its time and, for the events the executing
    rank records (the meeting's last arriver, whichever thread that
    was), without its recording rank."""
    rank = e["rank"] if e["name"] == "ft_inject" else None
    return (e["name"], str(rank), json.dumps(e["args"], sort_keys=True))


@pytest.mark.parametrize("tier", ["hbm", "mesh"])
def test_injected_sdc_events_match_reference(tier):
    """One injected run a package: the flight events it records (each
    kind and field; timestamps aside) are the same in both, and
    their counts equal the integrity pvars' moves: an sdc_mismatch,
    sdc_convict and sdc_retry each a mismatch, an ft_inject each flip."""
    got = {}
    for (mod, reg), run in zip(PKGS, RUNS[tier]):
        rec = mod.recorder()
        with armed(INJECT):
            base = {k: reg._pvars[k].read() for k in PVARS}
            h0 = rec.recorded
            run(_mix)
            n = rec.recorded - h0
            moves = {k: reg._pvars[k].read() - base[k] for k in PVARS}
        evs = _strip(rec.snapshot(last=n))
        counts = {nm: sum(e["name"] == nm for e in evs)
                  for nm in ("sdc_mismatch", "sdc_convict", "sdc_retry",
                             "ft_inject")}
        assert counts["sdc_mismatch"] == moves["integrity_mismatches"]
        assert counts["sdc_convict"] == moves["integrity_convictions"]
        assert counts["sdc_retry"] == moves["integrity_retry_ops"]
        assert counts["sdc_mismatch"] > 0
        assert counts["ft_inject"] >= counts["sdc_mismatch"]
        for e in evs:
            i = mod.EVENT_NAMES.index(e["name"])
            assert tuple(e["args"]) == tuple(
                f.rstrip("$") for f in mod.EVENT_FIELDS[i])
        got[mod.__name__] = sorted((_key(e) for e in evs))
    assert got["ompi_tpu_torch.obs"] == got["ompi_tpu.obs"]


def test_trace_dump_loads_in_traceview(tmp_path):
    """The ring's trace dump, persisted as a plain file, loads in the
    port's traceview as a flight document; persist(comm=...) writes
    the same bytes through MPI-IO (rank 0 lays them down); the local
    metrics document carries the pvar snapshot, in both packages."""
    from ompi_tpu_torch.tools import traceview
    r = obs.FlightRecorder(16)
    r.record(obs.EV_SDC_MISMATCH, 4, 7, obs.intern("allreduce"), rank=2)
    r.record(obs.EV_FT_INJECT, obs.intern("device_sdc"), obs.intern("coll"),
             rank=1)
    path = str(tmp_path / "flight.json")
    assert r.persist(path) == path
    doc = json.load(open(path))
    assert doc["flight"] and doc["recorded"] == 2
    dumps = traceview.load_dumps([path])
    names = [e.get("name")
             for e in traceview.chrome_trace(dumps, [])["traceEvents"]]
    assert "sdc_mismatch" in names and "ft_inject" in names
    cpath = str(tmp_path / "flight_io.json")
    assert port_run_ranks(2, lambda comm: r.persist(cpath, comm=comm)) \
        == [cpath, cpath]
    with open(cpath, "rb") as a, open(path, "rb") as b:
        assert a.read() == b.read()
    for mod, _ in PKGS:
        m = mod.local_metrics(events=4)
        assert set(m) >= {"ts", "pvars", "hists", "percentiles",
                          "scoped", "events"}
        assert isinstance(m["pvars"], dict) and m["pvars"]
        assert "obs_events_recorded" in m["pvars"]


# -- scrape, percentiles, Prometheus ------------------------------------------

class _FakeTracer:
    def __init__(self, hists) -> None:
        self.hists = hists


def test_scraper_tick_matches_reference():
    """The same ticks over the same histograms leave the same buffer:
    the first refresh copies every histogram, later ones one
    round-robin, none before the interval elapses."""
    rng = np.random.default_rng(3)
    nh, nb = len(port_trace.HIST_NAMES), port_trace.N_BUCKETS
    hists = [[int(v) for v in rng.integers(0, 50, nb)] for _ in range(nh)]
    bufs = []
    for mod, _ in PKGS:
        sc = mod.Scraper(_FakeTracer(hists), 1)
        assert sc.read_hists() is None
        fired = [sc.tick(t) for t in (5, 10, 1_000_010, 1_500_000,
                                      2_000_011, 9_000_000)]
        hists[2][3] += 1
        fired.append(sc.tick(20_000_000))
        bufs.append((fired, list(sc.buf), sc.read_hists(), sc.ticks))
        hists[2][3] -= 1
    assert bufs[0] == bufs[1]


def test_scraper_rides_the_progress_tick():
    """With tracing on, ``mpi_init``'s obs.attach hangs a Scraper off
    the rank's progress engine; finalize's detach takes it off."""
    saved = port_registry.get("trace_enable")
    port_registry.set("trace_enable", 1)
    try:
        def fn(comm):
            st = comm.state
            sc = st.progress.obs
            for _ in range(600):
                st.progress.progress()
            return type(sc).__name__, sc is st.extra.get("obs_scraper")
        states = []
        res = port_run_ranks(
            2, lambda c: states.append(c.state) or fn(c))
    finally:
        port_registry.set("trace_enable", saved)
    assert res == [("Scraper", True)] * 2
    assert all(st.progress.obs is None for st in states)


def test_hist_percentiles_match_reference():
    rng = np.random.default_rng(4)
    for _ in range(20):
        h = [int(v) for v in rng.integers(0, 9, port_trace.N_BUCKETS)]
        assert obs.hist_percentiles(h) == ref_obs.hist_percentiles(h)
    assert obs.hist_percentiles([0] * 5) == ref_obs.hist_percentiles([0] * 5)


def test_prometheus_text_matches_reference():
    """The same metrics document renders the same text: scalar pvars
    (counters registered in both packages, and an unknown name as a
    gauge), scoped families with their session series, scoped
    histograms, host health and the latency gauges."""
    metrics = {
        "pvars": {"coll_device_fused_batches": 12,
                  "dvm_xsession_batches": 3, "obstest_level": 2.5,
                  "obstest_flag": True, "obstest_name": "x"},
        "scoped": {"coll_device_fused_batches": {
            "global": 12, "bands": {"2": 4, "1": 8}}},
        "scoped_hists": {"obstest_q_us": {
            "total": [0, 3, 1] + [0] * 18,
            "bands": {"1": [0, 1, 1] + [0] * 18}}},
        "host_health": [{"host": 0, "state": "degraded", "score": 3}],
        "percentiles": {"coll_dispatch": {"p50": 4.0, "p90": 8.0,
                                          "p99": 16.0}},
    }
    ref_obs.scoped_pvar("coll", "device", "fused_batches")
    assert obs.prometheus_text(metrics) == ref_obs.prometheus_text(metrics)
    assert obs.prometheus_text(metrics, prefix="p") == \
        ref_obs.prometheus_text(metrics, prefix="p")


def test_register_pvars_once():
    """The gauges register once a process: the events counters read
    the recorder."""
    obs.register_pvars()
    obs.register_pvars()
    pv = port_registry._pvars["obs_events_recorded"]
    assert pv.read() == obs.recorder().recorded
    assert port_registry._pvars["obs_events_dropped"].read() == \
        obs.recorder().dropped


# -- memchecker hooks in ob1 --------------------------------------------------

def _memchecked(reg, run):
    reg.set("opal_memchecker_enable", True)
    try:
        return run()
    finally:
        reg.set("opal_memchecker_enable", False)


@pytest.mark.parametrize("which", ["port", "ref"])
def test_memchecker_poisons_recv_buffer(which):
    """A posted, unmatched receive buffer holds the poison pattern
    until the message lands."""
    mc = ompi_tpu_torch.memchecker if which == "port" else ref_memchecker
    reg, run = ((port_registry, port_run_ranks) if which == "port"
                else (ref_registry, ref_run_ranks))
    payload = np.random.default_rng(11).integers(0, 256, 4, np.uint8)

    def fn(comm):
        if comm.rank == 0:
            y = np.zeros(4, np.uint8)
            rq = comm.Irecv(y, 1, tag=9)
            poisoned = bytes(y)
            comm.Send(np.zeros(1, np.uint8), 1, tag=8)  # release peer
            rq.wait()
            return poisoned, bytes(y)
        comm.Recv(np.empty(1, np.uint8), 0, tag=8)
        comm.Send(payload, 0, tag=9)
        return None

    res = _memchecked(reg, lambda: run(2, fn))
    assert res[0] == (bytes([mc.POISON] * 4), payload.tobytes())


@pytest.mark.parametrize("which", ["port", "ref"])
def test_memchecker_catches_modified_send_buffer(which):
    """A rendezvous send whose buffer changes while the request is in
    flight raises at completion, naming the request."""
    reg, run = ((port_registry, port_run_ranks) if which == "port"
                else (ref_registry, ref_run_ranks))
    dt = (ompi_tpu_torch.datatype.engine if which == "port"
          else ref_dtmod)
    big = 1024 * 1024  # above the inproc eager limit: rendezvous

    def fn(comm):
        if comm.rank == 0:
            x = np.zeros(big, np.uint8)
            rq = comm.state.pml.isend(x, big, dt.BYTE, 1, 11, comm)
            x[0] = 99  # illegal: buffer owned by an active request
            try:
                while not rq.complete:
                    comm.state.progress.progress()
                return "not caught"
            except RuntimeError as e:
                return str(e).split(" was ")[0]
        y = np.empty(big, np.uint8)
        comm.Recv(y, 0, tag=11)
        return int(y[0])

    res = _memchecked(reg, lambda: run(2, fn))
    assert res[0].startswith("memchecker: send buffer of rendezvous "
                             "send req ")
    assert res[1] in (0, 99)


def test_memchecker_leaves_tensor_transfers_alone():
    """With the checker on, a tensor's send_arr / recv_arr (btl/tpu,
    not ob1's host convertor) carries its bytes unchanged."""
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        1 << 16).astype(np.float32))

    def fn(comm):
        if comm.rank == 0:
            comm.send_arr(x, 1, tag=4)
            return None
        return comm.recv_arr(0, tag=4).numpy().tobytes()

    res = _memchecked(port_registry, lambda: port_run_ranks(
        2, fn, device_map=lambda r: CPU))
    assert res[1] == x.numpy().tobytes()


# -- a node daemon's metrics request -----------------------------------------

def test_tpud_metrics_request_answers_with_pvars():
    """tpud's ``metrics`` op (the HNP asking a node for its telemetry)
    replies with the local metrics document, pvars included."""
    import queue
    import socket
    import subprocess
    import sys

    from ompi_tpu_torch.runtime import oob

    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    addr = f"127.0.0.1:{lst.getsockname()[1]}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpud", "--hnp", addr,
         "--name", "n1", "--node", "1"], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    got = queue.Queue()
    try:
        lst.settimeout(60)
        sock, _ = lst.accept()
        chan = oob.Channel(sock, got.put)
        assert got.get(timeout=60)["op"] == "register"
        chan.send({"op": "metrics", "events": 2, "prefix": "trace_hist_"})
        msg = got.get(timeout=60)
        while msg["op"] != "metrics":
            msg = got.get(timeout=60)
        m = msg["metrics"]
        assert "error" not in m, m
        assert (msg["node"], msg["name"]) == (1, "n1")
        assert m["pvars"] and all(k.startswith("trace_hist_")
                                  for k in m["pvars"])
        assert m["pvars"]["trace_hist_bucket_bounds_us"] == \
            port_registry._pvars["trace_hist_bucket_bounds_us"].read()
        chan.send({"op": "exit"})
        assert proc.wait(timeout=60) == 0, proc.stderr.read()[-2000:]
        chan.close()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        lst.close()
