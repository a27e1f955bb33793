"""The resident pool's gray-failure health plane on the CPU
(ompi_tpu_torch/tools/dvm.py ``hosts > 1`` wiring obs/health and the
integrity plane's convict hook): analogs of the reference's pool tests
of tests/test_grayfail.py (the quarantine drain and its placement,
stats and metrics exposing health, a dead host leaving the plane, the
host_slow x rank_kill chaos matrix) and of tests/test_integrity.py's
device_sdc x host_slow x rank_kill matrix, on ``DVMServer(4,
devices=[cpu], hosts=2)``.

Parity with the reference's own output: the survivors' DIGEST of each
chaos matrix equals the reference's ``tests/_fleet_host_prog.py`` run
unkilled on three ranks (the survivors redo the whole accumulation on
the shrunk world), and the quarantine drain's two runs print the
reference pool's ``_dvm_session_prog`` DIGEST.  Tolerance: exact.

Pinned divergence (``test_divergence_*``): the host_slow x rank_kill
matrix kills rank 1 at a step boundary (``fleet_host.py``'s
``KILL_RANK:KILL_STEP``) where the reference arms the wall-clock
``rank_kill`` timer, whose firing can land in the victim's init window
and makes the reference's matrix depend on the order its tests run in
(ROADMAP.md lists it among the reference's unsteady tests).
"""

import os
import threading
import time

import pytest
import torch

# knob registration happens at import: _restore of an unregistered knob
# would write None back
import ompi_tpu_torch.ft_inject  # noqa: F401
import ompi_tpu_torch.runtime.oob  # noqa: F401
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.obs import integrity as ig
from ompi_tpu_torch.obs.health import DEGRADED, HEALTHY, QUARANTINED
from ompi_tpu_torch.tools.dvm import DVMServer, DvmClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "ompi_tpu_torch", "examples")
PROG = os.path.join(EX, "dvm_session.py")
HOST_PROG = os.path.join(EX, "fleet_host.py")
REF_PROG = os.path.join(REPO, "tests", "_dvm_session_prog.py")
REF_HOST_PROG = os.path.join(REPO, "tests", "_fleet_host_prog.py")
CPU = [torch.device("cpu")]
T = 60  # seconds: every run / attach RPC and join of this file

# A stepped device allreduce whose analytic result every rank knows, so
# each step self-verifies: with device_sdc armed and the integrity
# plane sampling every op, every flip is caught and retried and the
# program prints ``SDC {tag} {rank} ok`` (the port's copy of the
# reference's tests/_sdc_prog.py).  argv: tag steps
SDC_SRC = '''\
import sys
import torch
import ompi_tpu_torch
from ompi_tpu_torch.op import op as mpi_op
tag, steps = sys.argv[1], int(sys.argv[2])
comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
expect = torch.full((32,), float(size * (size + 1) // 2))
ok = True
for _ in range(steps):
    x = torch.full((32,), float(rank + 1), device=comm.device)
    got = comm.allreduce_arr(x, mpi_op.SUM)
    ok = ok and bool(torch.equal(got.cpu(), expect))
sys.stdout.write(f"SDC {tag} {rank} {'ok' if ok else 'bad'}\\n")
sys.stdout.flush()
ompi_tpu_torch.finalize()
'''


def _set(vals):
    saved = {k: registry.get(k) for k in vals}
    for k, v in vals.items():
        registry.set(k, v)
    return saved


def _restore(saved):
    for k, v in saved.items():
        registry.set(k, v)


def _pv(name):
    return registry._pvars[name].read()


def _pool2(tmp_path, capacity):
    uri = str(tmp_path / "dvm.uri")
    srv = DVMServer(capacity, devices=CPU, uri_file=uri, hosts=2).start()
    return srv, uri


def _lines(stdout, kind, tag):
    return [line.split()[2:] for line in stdout.splitlines()
            if line.split()[:2] == [kind, tag]]


def _wait_for(pred, timeout=T, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.01)


def _reset_health(srv):
    """Leave no process-global residue (degraded-mask bits, the
    fleet_host_health gauge) for later tests in this process."""
    hp = srv.health
    if hp is None:
        return
    for h in range(hp.hosts):
        hp.reset_host(h)
    hp.collect()


def _ref_digest(tmp_path, prog, args, np_):
    """DIGEST of one run through the reference's two-host pool."""
    jax = pytest.importorskip("jax")
    from ompi_tpu.tools import dvm as ref_dvm
    d = tmp_path / "ref"
    d.mkdir(exist_ok=True)
    uri = str(d / "dvm.uri")
    srv = ref_dvm.DVMServer(4, devices=jax.devices(), uri_file=uri,
                            hosts=2).start()
    try:
        with ref_dvm.DvmClient(uri) as c:
            sid = c.attach(np_, timeout=T)["sid"]
            r = c.run(sid, prog, args, timeout=T)
            c.detach(sid)
    finally:
        srv.stop()
    assert r["code"] == 0, r["stderr"][-2000:]
    return _lines(r["stdout"], "DIGEST", args[0])[0][0]


class _Beater(threading.Thread):
    """An in-process stand-in for a tpud host agent: registers on the
    pool port and beats at a test-controlled pace."""

    def __init__(self, uri, host, interval_s):
        super().__init__(daemon=True)
        self.uri = uri
        self.host = host
        self.interval_s = interval_s
        self._halt = threading.Event()

    def halt(self):
        self._halt.set()

    def run(self):
        c = DvmClient(self.uri)
        try:
            c._rpc({"op": "host_register", "host": self.host,
                    "pid": 0})
            while not self._halt.wait(self.interval_s):
                c._rpc({"op": "host_beat", "host": self.host})
        except Exception:  # noqa: BLE001 — the pool stopping under us
            pass
        finally:
            c.sock.close()


# -- the mitigation ladder on a live pool -----------------------------------


def test_quarantine_drains_and_replaces_placement(tmp_path):
    """A quarantined host drains its residents through the preemption
    machinery (park, not kill — the host is alive) and the next
    bring-up bands the session over the healthy host only; new
    placements avoid it too.  Nothing fails, and the session's DIGEST
    (placement-free) is the reference pool's."""
    srv, uri = _pool2(tmp_path, 4)
    base_q, base_m = _pv("fleet_quarantines"), _pv("fleet_migrations")
    c = DvmClient(uri)
    try:
        sid = c.attach(4, timeout=T)["sid"]
        r = c.run(sid, PROG, ["gq"], timeout=T)
        assert r["code"] == 0, r["stderr"][-2000:]
        sess = srv.sessions[sid]
        assert sess.placement is None  # all healthy: static banding
        hp = srv.health
        hp.state[1] = QUARANTINED
        hp.pending[1] = 1
        srv._health_applied[1] = DEGRADED
        srv._health_collect()
        assert _pv("fleet_quarantines") == base_q + 1
        assert _pv("fleet_migrations") == base_m + 1
        assert sess.parked  # idle resident: parked directly
        r2 = c.run(sid, PROG, ["gq"], timeout=T)
        assert r2["code"] == 0, r2["stderr"][-2000:]
        assert sess.placement == [0, 0, 0, 0]
        assert r2["stdout"] == r["stdout"]
        assert srv._plan_placement(2) == [0, 0]
        assert srv._host_dead[1] == 0  # quarantined, never dead
        assert c.metrics()["host_health"][1]["state"] == "quarantined"
        c.detach(sid)
    finally:
        c.sock.close()
        _reset_health(srv)
        srv.stop()
    assert _lines(r["stdout"], "DIGEST", "gq")[0][0] \
        == _ref_digest(tmp_path, REF_PROG, ["gq"], 4)


def test_stats_and_metrics_expose_health(tmp_path):
    """Per-host health rows ride the metrics RPC; stats carries the
    degraded/quarantined counts.  A one-host pool has no plane."""
    srv, uri = _pool2(tmp_path, 2)
    try:
        with DvmClient(uri) as c:
            st = c.stats()
            assert st["hosts_degraded"] == 0
            assert st["hosts_quarantined"] == 0
            rows = c.metrics()["host_health"]
            assert len(rows) == 2
            for row in rows:
                assert row["state"] == "healthy" and row["score"] == 0
                assert row["grace_ms"] > 0
    finally:
        srv.stop()
    uri1 = str(tmp_path / "one.uri")
    srv1 = DVMServer(2, devices=CPU, uri_file=uri1).start()
    try:
        with DvmClient(uri1) as c1:
            assert c1.metrics()["host_health"] is None
            assert c1.stats()["hosts_degraded"] == 0
    finally:
        srv1.stop()


def test_dead_host_excluded_from_health_plane(tmp_path):
    """Death stays the liveness plane's case: a killed host leaves the
    scoring sweep (excluded, state reset), and a respawned host rejoins
    healthy with fresh estimates."""
    srv, uri = _pool2(tmp_path, 4)
    try:
        hp = srv.health
        srv.kill_host(1)
        assert hp.excluded[1] == 1 and hp.state[1] == HEALTHY
        assert not hp.placement_ok(1)
        assert srv._plan_placement(4) == [0, 0, 0, 0]
        assert srv.respawn_host(1) > 0
        assert hp.excluded[1] == 0 and hp.state[1] == HEALTHY
        assert hp.placement_ok(1)
        assert srv._plan_placement(4) is None
    finally:
        _reset_health(srv)
        srv.stop()


def test_degraded_host_widens_shed_deadline(tmp_path):
    """The ladder's deadline arm: a session touching a degraded host
    has its deadline widened by health_widen_pct at shed admission
    instead of being shed."""
    from ompi_tpu_torch.tools.dvm import DvmDeadline
    srv, uri = _pool2(tmp_path, 4)
    try:
        with DvmClient(uri) as c:
            sid = c.attach(4, timeout=T)["sid"]
            sess = srv.sessions[sid]
            srv.est_wall_us = 200_000  # a 200 ms run estimate
            with pytest.raises(DvmDeadline):
                srv._shed_check(sess, 100)
            hp = srv.health
            hp.state[1] = DEGRADED
            hp.degraded_n = 1
            srv._shed_check(sess, 100)  # widened 3x: 300 ms fits
            c.detach(sid)
    finally:
        _reset_health(srv)
        srv.stop()


# -- chaos matrices ----------------------------------------------------------


def test_divergence_chaos_matrix_host_slow_and_step_kill(tmp_path):
    """The gray failure and a hard one at once: host 1 beats slow
    (host_slow on its agent) while rank 1 on the HEALTHY host dies at a
    step boundary.  ULFM shrink completes with one consistent failure
    set and equal survivor digests (the reference's three-rank digest);
    the slow host ends DEGRADED — never dead, never quarantined — and
    nothing fails."""
    saved = _set({
        "dvm_heartbeat_s": 0.2,
        "oob_host_grace_s": 0.1,
        "health_tick_ms": 150,
        "health_trip_ticks": 1,
        "health_clear_ticks": 64,        # hold degraded for the run
        "health_quarantine_score": 101,  # unreachable: score caps at 100
        "ft_inject_plan": "host_slow",
        "ft_inject_skip": 0,
        "ft_inject_victim_host": 1,
        "ft_inject_delay_ms": 5,
    })
    base_q = _pv("fleet_quarantines")
    srv, uri = _pool2(tmp_path, 4)
    beaters = [_Beater(uri, 0, 0.08), _Beater(uri, 1, 0.6)]
    for b in beaters:
        b.start()
    c = DvmClient(uri)
    try:
        sid = c.attach(4, timeout=T)["sid"]
        r = c.run(sid, HOST_PROG, ["gm", "20", "1:5", "--device", "cpu",
                                   "--mib", "1"], timeout=T)
        assert r["code"] == 0, r["stderr"][-2000:]
        shrinks = _lines(r["stdout"], "SHRINKS", "gm")
        digs = _lines(r["stdout"], "DIGEST", "gm")
        assert sorted(int(s[0]) for s in shrinks) == [0, 2, 3], shrinks
        assert all(int(s[1]) == 1 for s in shrinks), shrinks
        assert len(digs) == 3 and len({d[0] for d in digs}) == 1, digs
        _wait_for(lambda: srv._health_applied[1] >= DEGRADED,
                  timeout=20, what="host 1 degraded")
        assert srv._host_dead[1] == 0, "slow host declared DEAD"
        assert srv.health.state[1] == DEGRADED
        assert _pv("fleet_quarantines") == base_q
        assert srv.health.state[0] == HEALTHY
        st = c.stats()
        assert st["hosts_degraded"] >= 1 and st["hosts_lost"] == 0
        c.detach(sid)
    finally:
        for b in beaters:
            b.halt()
        c.sock.close()
        for b in beaters:
            b.join(timeout=5)
        _reset_health(srv)
        srv.stop()
        _restore(saved)
    assert digs[0][0] == _ref_digest(tmp_path, REF_HOST_PROG, ["gm", "20"],
                                     3)


def test_chaos_matrix_sdc_host_slow_rank_kill(tmp_path):
    """The silent failure composed with the gray and the hard one:
    device_sdc on rank 1 (host 0) while host 1 crawls — every flip is
    convicted against exactly that rank and every result stays exact;
    the pool's convict hook feeds the health plane, whose next tick
    quarantines host 0.  Then host_slow with a step-boundary kill:
    ULFM shrink completes byte-identically.  Zero failed jobs."""
    saved = _set({
        "health_tick_ms": 600_000,  # ticks under test control only
        "integrity_enable": 1,
        "integrity_sample": 1,
        "integrity_sample_auto": 0,
        "ft_inject_plan": "device_sdc:3,host_slow",
        "ft_inject_skip": 0,
        "ft_inject_victim_rank": "1",
        "ft_inject_victim_host": 1,
        "ft_inject_sdc_period": 1,
        "ft_inject_delay_ms": 5,
    })
    ig.refresh()
    ig.reset()
    base_c = _pv("integrity_convictions")
    prog = tmp_path / "_sdc_prog.py"
    prog.write_text(SDC_SRC)
    srv, uri = _pool2(tmp_path, 4)
    srv.health.next_ns = time.perf_counter_ns() + 3_600 * 1_000_000_000
    c = DvmClient(uri)
    try:
        sid = c.attach(4, timeout=T)["sid"]
        r = c.run(sid, str(prog), ["cm", "6"], timeout=T)
        assert r["code"] == 0, r["stderr"][-2000:]
        rows = _lines(r["stdout"], "SDC", "cm")
        assert sorted(int(x[0]) for x in rows) == [0, 1, 2, 3], rows
        assert all(x[1] == "ok" for x in rows), rows
        recs = ig.convicted_snapshot()
        assert recs and {rec["rank"] for rec in recs} == {1}, recs
        assert {rec["host"] for rec in recs} == {0}, recs
        assert _pv("integrity_convictions") > base_c
        hp = srv.health
        assert hp.sdc[0] > 0 and hp.sdc[1] == 0
        assert c.metrics()["sdc"]
        c.detach(sid)
        registry.set("ft_inject_plan", "host_slow")
        sid = c.attach(4, timeout=T)["sid"]
        r2 = c.run(sid, HOST_PROG, ["cm2", "20", "1:5", "--device",
                                    "cpu", "--mib", "1"], timeout=T)
        assert r2["code"] == 0, r2["stderr"][-2000:]
        shrinks = _lines(r2["stdout"], "SHRINKS", "cm2")
        digs = _lines(r2["stdout"], "DIGEST", "cm2")
        assert sorted(int(s[0]) for s in shrinks) == [0, 2, 3], shrinks
        assert all(int(s[1]) == 1 for s in shrinks), shrinks
        assert len(digs) == 3 and len({d[0] for d in digs}) == 1, digs
        hp.next_ns = 0
        hp.tick(time.monotonic_ns())
        assert hp.state[0] == QUARANTINED
        assert "sdc" in hp.tripped(0)
        assert srv._host_dead[0] == 0  # quarantined, never dead
        c.detach(sid)
    finally:
        c.sock.close()
        ig.reset()
        _reset_health(srv)
        srv.stop()
        _restore(saved)
        ig.refresh()
    assert digs[0][0] == _ref_digest(tmp_path, REF_HOST_PROG,
                                     ["cm2", "20"], 3)
