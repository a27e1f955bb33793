"""The serving control plane of the port's resident pool on the CPU
(ompi_tpu_torch/tools/dvm.py, ompi_tpu_torch/serve): analogs of the
reference's one-host tests of tests/test_fleet.py (queue timeout, dead
queued clients, priority admission, preemption of running and idle
sessions, live resize under traffic and chaos, rank_kill confined to
its session, deadline shedding, the HBM quota, the FleetController and
its audited tick) and of tests/test_ctrlplane.py (the kill injectors
and the Supervisor), plus the request trace context's minting half
(tests/test_reqtrace.py) held against the reference's.

Pinned divergences, each a test named ``test_divergence_*``: the port
has no compiled-program cache, so the HBM quota's degrade step records
its flight event and evicts nothing (the reference drops the
offender's compiled executables), and a pool started with
``dvm_quota_cache_share_pct`` nonzero is refused (no cache to bound).
The multi-host fleet is tested in tests/test_torch_fleet.py and
tests/test_torch_grayfail.py.

Every pool here is ``DVMServer(n, devices=[cpu])`` (coll/hbm with the
kernels' plain versions); every RPC and join carries its own timeout.
"""

import os
import sys
import threading
import time

import pytest
import torch

from ompi_tpu_torch import obs as _obs
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.obs import reqtrace
# registers the ctrl_* knobs, so _set/_restore of them is order-free
from ompi_tpu_torch.serve import controller as _controller  # noqa: F401
from ompi_tpu_torch.tools.dvm import (DVMServer, DvmBusy, DvmClient,
                                      DvmDeadline, DvmError, _pv_preempts,
                                      _pv_resizes, _pv_sheds, _send)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "ompi_tpu_torch", "examples")
PROG = os.path.join(EX, "dvm_session.py")
SLOW_PROG = os.path.join(EX, "dvm_slow.py")
CPU = [torch.device("cpu")]
T = 60  # seconds: every run / attach RPC and join of this file

# A stepped allreduce accumulation that checkpoints every step (rank 0
# writes (step, vec) atomically between two barriers) and resumes from
# the checkpoint at start: a preempted run finishes byte-identical to
# an unpreempted one.  argv: tag store steps [sleep_s]
CKPT_SRC = '''\
import hashlib, os, sys, time
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.op import op as mpi_op
tag, store, steps = sys.argv[1], sys.argv[2], int(sys.argv[3])
sleep_s = float(sys.argv[4]) if len(sys.argv) > 4 else 0.0
comm = ompi_tpu_torch.init()
rank = comm.rank
path = os.path.join(store, "ckpt.npz")
start, vec = 0, np.zeros(32, np.float64)
if os.path.exists(path):
    d = np.load(path)
    start, vec = int(d["step"]), d["vec"].copy()
comm.Barrier()
for step in range(start, steps):
    contrib = np.full(32, float((step + 1) * (rank + 1)), np.float64)
    r = np.empty_like(contrib)
    comm.Allreduce(contrib, r, mpi_op.SUM)
    vec = vec + r
    comm.Barrier()
    if rank == 0:
        os.makedirs(store, exist_ok=True)
        np.savez(path + ".tmp.npz", step=step + 1, vec=vec)
        os.replace(path + ".tmp.npz", path)
    comm.Barrier()
    if sleep_s:
        time.sleep(sleep_s)
if rank == 0:
    sys.stdout.write(f"STEPS {tag} {start}\\n")
    sys.stdout.write(f"DIGEST {tag} {hashlib.sha256(vec.tobytes()).hexdigest()}\\n")
ompi_tpu_torch.finalize()
'''


@pytest.fixture
def ckpt_prog(tmp_path):
    p = tmp_path / "_ckpt_prog.py"
    p.write_text(CKPT_SRC)
    return str(p)


def _set(vals):
    saved = {k: registry.get(k) for k in vals}
    for k, v in vals.items():
        registry.set(k, v)
    return saved


def _restore(saved):
    for k, v in saved.items():
        registry.set(k, v)


def _pool(tmp_path, capacity):
    uri = str(tmp_path / "dvm.uri")
    srv = DVMServer(capacity, devices=CPU, uri_file=uri).start()
    return srv, uri


def _digest(stdout, tag):
    for line in stdout.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[0] == "DIGEST" and parts[1] == tag:
            return parts[2]
    raise AssertionError(f"no DIGEST {tag} in: {stdout!r}")


def _resumed_at(stdout, tag):
    for line in stdout.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[0] == "STEPS" and parts[1] == tag:
            return int(parts[2])
    raise AssertionError(f"no STEPS {tag} in: {stdout!r}")


def _wait_for(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _join(*threads):
    for t in threads:
        t.join(timeout=T)
        assert not t.is_alive(), f"{t.name} still running after {T}s"


def _assert_band_sums_exact():
    """global == sum(bands) for every ScopedPvar — attribution never
    leaks or double-counts, including across resize epochs."""
    for sp in _obs.scoped_items():
        g = sp.pvar.read()
        s = sum(sp.bands)
        assert g == s, f"{sp.pvar.full_name}: global {g} != sum {s}"


# -- admission ---------------------------------------------------------------

def test_queue_timeout_then_retry(tmp_path):
    """dvm_queue_timeout_s bounds an untimed queued attach with a
    friendly DvmBusy naming the knob; a retry after capacity frees
    succeeds."""
    srv, uri = _pool(tmp_path, 2)
    saved = _set({"dvm_queue_timeout_s": 1.0})
    try:
        c1 = DvmClient(uri)
        s1 = c1.attach(2, timeout=T)["sid"]
        c2 = DvmClient(uri)
        t0 = time.monotonic()
        with pytest.raises(DvmBusy, match="dvm_queue_timeout_s"):
            c2.attach(2)  # no client timeout: the knob bounds it
        assert time.monotonic() - t0 < 20
        c1.detach(s1)
        r = c2.attach(2, timeout=T)
        c2.detach(r["sid"])
        c1.close()
        c2.close()
    finally:
        _restore(saved)
        srv.stop()


def test_dead_queued_client_swept_and_successor_admitted(tmp_path):
    """A client that dies WHILE QUEUED does not hold its place in line:
    the heartbeat sweep abandons its waiter and the session queued
    behind it is admitted as soon as capacity frees."""
    srv, uri = _pool(tmp_path, 2)
    saved = _set({"dvm_heartbeat_s": 0.3})
    try:
        c1 = DvmClient(uri)
        s1 = c1.attach(2, timeout=T)["sid"]
        doomed = DvmClient(uri)
        _send(doomed.sock, {"op": "attach", "np": 2, "wait": True})
        _wait_for(lambda: len(srv._waiters) == 1,
                  what="doomed attach queued")
        got = {}

        def behind():
            with DvmClient(uri) as c3:
                r = c3.attach(2, timeout=T)
                got.update(r)
                c3.detach(r["sid"])

        th = threading.Thread(target=behind)
        th.start()
        _wait_for(lambda: len(srv._waiters) == 2,
                  what="successor queued behind the doomed client")
        doomed.sock.close()  # dies in line
        _wait_for(lambda: len(srv._waiters) == 1, timeout=15,
                  what="heartbeat sweep of the dead waiter")
        c1.detach(s1)  # frees capacity -> the SUCCESSOR admits
        _join(th)
        assert "sid" in got, got
        c1.close()
    finally:
        _restore(saved)
        srv.stop()


def test_priority_orders_admission_queue(tmp_path):
    """A higher-priority attach queued later is admitted first (FIFO
    within a priority level, priority across levels)."""
    srv, uri = _pool(tmp_path, 2)
    c1 = DvmClient(uri)
    s1 = c1.attach(2, timeout=T)["sid"]
    order = []

    def waiter(prio, name):
        with DvmClient(uri) as c:
            r = c.attach(2, timeout=T, priority=prio)
            order.append(name)
            time.sleep(0.3)  # hold briefly so admissions serialize
            c.detach(r["sid"])

    lo = threading.Thread(target=waiter, args=(0, "lo"))
    lo.start()
    _wait_for(lambda: len(srv._waiters) == 1, what="low-prio queued")
    hi = threading.Thread(target=waiter, args=(5, "hi"))
    hi.start()
    _wait_for(lambda: len(srv._waiters) == 2, what="high-prio queued")
    with srv.lock:
        assert srv._waiters[0].priority == 5
    c1.detach(s1)
    _join(hi, lo)
    assert order == ["hi", "lo"]
    c1.close()
    srv.stop()


# -- preemption --------------------------------------------------------------

def test_preempt_running_session_resumes_byte_identical(tmp_path,
                                                        ckpt_prog):
    """A high-priority attach preempts a running preemptible session:
    the victim resumes from its checkpoint (STEPS shows a nonzero
    restart), its client sees ONE successful run whose digest equals an
    unpreempted baseline — never a failed job."""
    srv, uri = _pool(tmp_path, 2)
    steps, sleep_s = 10, 0.2
    cb = DvmClient(uri)
    sb = cb.attach(2, timeout=T)["sid"]
    rb = cb.run(sb, ckpt_prog, ["base", str(tmp_path / "store_a"),
                                str(steps)], timeout=T)
    assert rb["code"] == 0, rb["stderr"][-2000:]
    base_dig = _digest(rb["stdout"], "base")
    cb.detach(sb)
    cb.close()

    p0 = _pv_preempts.read()
    cv = DvmClient(uri)
    sv = cv.attach(2, preemptible=True, timeout=T)["sid"]
    res = {}

    def victim_run():
        res["r"] = cv.run(sv, ckpt_prog,
                          ["vic", str(tmp_path / "store_v"), str(steps),
                           str(sleep_s)], timeout=T)

    th = threading.Thread(target=victim_run)
    th.start()
    time.sleep(1.0)  # the victim is mid-run, a few steps checkpointed
    hi = DvmClient(uri)
    rh = hi.attach(2, priority=5, timeout=T)
    rr = hi.run(rh["sid"], PROG, ["hi"], timeout=T)
    assert rr["code"] == 0, rr["stderr"][-2000:]
    hi.detach(rh["sid"])
    hi.close()
    _join(th)
    r = res["r"]
    assert r["code"] == 0, r["stderr"][-2000:]  # never a failed job
    assert r.get("preempted", 0) >= 1
    assert _pv_preempts.read() >= p0 + 1
    assert _resumed_at(r["stdout"], "vic") > 0, \
        "victim restarted from scratch instead of its checkpoint"
    assert _digest(r["stdout"], "vic") == base_dig
    cv.detach(sv)
    cv.close()
    srv.stop()


def test_preempt_idle_session_parks_then_resumes_transparently(tmp_path):
    """An idle preemptible victim is parked at once (its ranks
    reclaimed for the preemptor); its next run re-admits and re-brings
    it up behind the scenes."""
    srv, uri = _pool(tmp_path, 2)
    p0 = _pv_preempts.read()
    cv = DvmClient(uri)
    sv = cv.attach(2, preemptible=True, timeout=T)["sid"]
    r0 = cv.run(sv, PROG, ["idle"], timeout=T)
    assert r0["code"] == 0, r0["stderr"][-2000:]
    hi = DvmClient(uri)
    rh = hi.attach(2, priority=1, timeout=T)
    with srv.lock:
        assert srv.sessions[sv].parked, "idle victim was not parked"
        assert srv.active_ranks == 2
    assert _pv_preempts.read() == p0 + 1
    hi.detach(rh["sid"])
    hi.close()
    r1 = cv.run(sv, PROG, ["idle"], timeout=T)
    assert r1["code"] == 0, r1["stderr"][-2000:]
    assert r1.get("preempted", 0) == 1
    assert r1["stdout"] == r0["stdout"]
    cv.detach(sv)
    cv.close()
    srv.stop()


# -- live resize under traffic and chaos --------------------------------------

def test_resize_under_traffic_zero_failed_jobs(tmp_path):
    """Grow 4->8 and shrink 8->4 while sessions run: zero failed jobs,
    byte-identical outputs, both epochs recorded, and ScopedPvar band
    sums exact across the resize epochs."""
    srv, uri = _pool(tmp_path, 4)
    c0 = DvmClient(uri)
    s0 = c0.attach(2, timeout=T)["sid"]
    baseline = c0.run(s0, PROG, ["rz"], timeout=T)
    assert baseline["code"] == 0, baseline["stderr"][-2000:]
    c0.detach(s0)
    c0.close()
    z0 = _pv_resizes.read()
    errors = []
    outs = []

    def worker(nruns):
        try:
            with DvmClient(uri) as c:
                sid = c.attach(2, timeout=T)["sid"]
                for _ in range(nruns):
                    r = c.run(sid, PROG, ["rz"], timeout=T)
                    assert r["code"] == 0, r["stderr"][-2000:]
                    outs.append(r["stdout"])
                c.detach(sid)
        except BaseException as e:  # noqa: BLE001
            errors.append(repr(e))

    t1 = threading.Thread(target=worker, args=(4,))
    t2 = threading.Thread(target=worker, args=(4,))
    t1.start()
    t2.start()
    time.sleep(0.3)  # traffic in flight
    admin = DvmClient(uri)
    gr = admin.resize(8)
    assert gr["was"] == 4 and gr["epoch"] == 1
    t3 = threading.Thread(target=worker, args=(2,))
    t3.start()  # uses the grown headroom
    time.sleep(0.3)
    sh = admin.resize(4)
    assert sh["was"] == 8 and sh["epoch"] == 2
    _join(t1, t2, t3)
    assert not errors, errors
    assert len(outs) == 10 and all(o == baseline["stdout"] for o in outs)
    assert _pv_resizes.read() == z0 + 2
    st = admin.stats()
    assert st["capacity"] == 4 and st["epoch"] == 2
    admin.close()
    _assert_band_sums_exact()
    srv.stop()


def test_resize_with_client_disconnect_chaos(tmp_path):
    """ft_inject dvm_disconnect during the resize window: the doomed
    client's session unwinds, the pool resizes anyway, survivors stay
    byte-identical, and new sessions keep being admitted."""
    srv, uri = _pool(tmp_path, 4)
    cb = DvmClient(uri)
    sb = cb.attach(2, timeout=T)["sid"]
    base = cb.run(sb, PROG, ["sv"], timeout=T)
    assert base["code"] == 0, base["stderr"][-2000:]
    saved = _set({"ft_inject_plan": "dvm_disconnect:1",
                  "ft_inject_skip": 0})
    try:
        ca = DvmClient(uri)  # injector armed at construction
        sa = ca.attach(2, timeout=T)["sid"]
        with pytest.raises(DvmError, match="dvm_disconnect"):
            ca.run(sa, PROG, ["doomed"])
    finally:
        _restore(saved)
    admin = DvmClient(uri)
    admin.resize(8)
    r1 = cb.run(sb, PROG, ["sv"], timeout=T)
    assert r1["code"] == 0 and r1["stdout"] == base["stdout"]
    admin.resize(4)
    r2 = cb.run(sb, PROG, ["sv"], timeout=T)
    assert r2["code"] == 0 and r2["stdout"] == base["stdout"]
    _wait_for(lambda: len(srv.sessions) == 1, timeout=T,
              what="orphaned session reaped")
    with DvmClient(uri) as cn:
        rn = cn.attach(2, timeout=T)
        cn.detach(rn["sid"])
    _assert_band_sums_exact()
    cb.detach(sb)
    cb.close()
    admin.close()
    srv.stop()


def test_rank_kill_chaos_confined_to_victim_session(tmp_path, ckpt_prog):
    """ft_inject rank_kill inside one session of the pool: that run
    fails and the session dies, but a peer session's output stays
    byte-identical and the pool keeps admitting new sessions."""
    srv, uri = _pool(tmp_path, 4)
    cb = DvmClient(uri)
    sb = cb.attach(2, timeout=T)["sid"]
    base = cb.run(sb, PROG, ["pk"], timeout=T)
    assert base["code"] == 0, base["stderr"][-2000:]
    # the death timer arms at mpi_init: arm the kill ONLY around the
    # doomed session's bring-up
    saved = _set({"ft_inject_plan": "rank_kill",
                  "ft_inject_skip": 0,
                  "ft_inject_victim_rank": "1",
                  "ft_inject_after": 0.3})
    try:
        ca = DvmClient(uri)
        sa = ca.attach(2, timeout=T)["sid"]
    finally:
        _restore(saved)
    ra = ca.run(sa, ckpt_prog, ["doom", str(tmp_path / "store_kill"),
                                "20", "0.2"], timeout=T)
    assert ra["code"] != 0, "the armed rank_kill never fired"
    # the victim's RankKilled is published ULFM-style; this program is
    # not ULFM-aware, so its surviving peer dies session-confined on
    # the resulting ERR_PROC_FAILED naming the corpse
    assert "MPI_ERR_PROC_FAILED" in ra["stderr"], ra["stderr"][-3000:]
    assert "rank_kill" in ra["stderr"]
    with pytest.raises(DvmError, match="dead"):
        ca.run(sa, PROG, ["again"])
    rb = cb.run(sb, PROG, ["pk"], timeout=T)
    assert rb["code"] == 0 and rb["stdout"] == base["stdout"]
    ca.detach(sa)  # releases the dead session's ranks
    with DvmClient(uri) as cn:
        rn = cn.attach(2, timeout=T)
        r = cn.run(rn["sid"], PROG, ["fresh"], timeout=T)
        assert r["code"] == 0, r["stderr"][-2000:]
        cn.detach(rn["sid"])
    ca.close()
    cb.detach(sb)
    cb.close()
    srv.stop()


# -- deadline shedding -------------------------------------------------------

def test_deadline_shed_typed_reject_keeps_session_alive(tmp_path):
    """An infeasible deadline is shed at admission with a typed
    DvmDeadline — and shedding a run does NOT poison the session: a
    feasible run right after succeeds."""
    srv, uri = _pool(tmp_path, 4)
    c = DvmClient(uri)
    sid = c.attach(2, timeout=T)["sid"]
    warm = c.run(sid, SLOW_PROG, timeout=T)  # seeds est_wall_us
    assert warm["code"] == 0, warm["stderr"][-2000:]
    assert srv.est_wall_us > 1_000_000  # the 1.5 s sleep dominates
    h0 = _pv_sheds.read()
    with pytest.raises(DvmDeadline, match="shed at admission"):
        c.run(sid, SLOW_PROG, deadline_ms=100)
    assert _pv_sheds.read() == h0 + 1
    r = c.run(sid, PROG, ["ok"], deadline_ms=60_000, timeout=T)
    assert r["code"] == 0, r["stderr"][-2000:]
    c.detach(sid)
    c.close()
    srv.stop()


# -- per-session quotas ------------------------------------------------------

HOG_SRC = ("import numpy as np\n"
           "import ompi_tpu_torch\n"
           "from ompi_tpu_torch.op import op as mpi_op\n"
           "comm = ompi_tpu_torch.init()\n"
           "for i in range(8):\n"
           "    x = np.full(4096, float(comm.rank + i), np.float64)\n"
           "    comm.allreduce_arr(x, mpi_op.SUM)\n"
           "ompi_tpu_torch.finalize()\n")


def test_hbm_quota_degrades_then_rejects_without_poisoning_pool(
        tmp_path):
    """Over-budget deposits: the first breach degrades, a continued
    breach fails THAT run with QuotaExceeded — the peer session and
    the pool keep working.  Each of the hog's 8 iterations deposits 2
    ranks x 32 KiB of host numpy onto the device; a 100 KB budget
    breaches on the 4th deposit and rejects on the 5th."""
    from ompi_tpu_torch.serve import quota

    srv, uri = _pool(tmp_path, 4)
    hog = tmp_path / "_hog.py"
    hog.write_text(HOG_SRC)
    cb = DvmClient(uri)
    sb = cb.attach(2, timeout=T)["sid"]
    saved = _set({"dvm_quota_hbm_bytes": 100_000})
    rej0 = quota.pv_rejects.read()
    try:
        ca = DvmClient(uri)
        sa = ca.attach(2, timeout=T)["sid"]
        ra = ca.run(sa, str(hog), timeout=T)
        assert ra["code"] != 0, "the quota never rejected"
        assert "quota" in ra["stderr"]
        assert quota.pv_rejects.read() > rej0
        assert quota.pv_hbm.read_band(sa) > 0  # attributed to the hog
        ca.close()
    finally:
        _restore(saved)
    rb = cb.run(sb, PROG, ["peer"], timeout=T)
    assert rb["code"] == 0, rb["stderr"][-2000:]
    cb.detach(sb)
    cb.close()
    _assert_band_sums_exact()
    srv.stop()


def test_divergence_quota_degrade_evicts_nothing():
    """Divergence: the reference's first breach evicts the offender's
    compiled executables from its compiled-collective cache
    (``compile_cache.drop_band``); the port has no compiled-program
    cache (its kernels are built libraries every session shares), so
    the degrade step is the ``dvm_quota`` (hbm_degrade) flight event
    alone — and the next breach rejects, as in the reference."""
    import types

    from ompi_tpu_torch.coll import device
    from ompi_tpu_torch.runtime import state as statemod
    from ompi_tpu_torch.serve import quota

    assert not hasattr(device, "compile_cache")
    band = 777
    saved = _set({"dvm_quota_hbm_bytes": 100})
    statemod.set_current(types.SimpleNamespace(cid_band=band))
    rec = _obs.recorder()
    n0 = rec.recorded
    try:
        quota.begin_run(band)
        quota.charge_hbm(64)           # within budget: nothing recorded
        assert rec.recorded == n0
        quota.charge_hbm(64)           # first breach: degrade
        evs = [e["args"] for e in rec.snapshot(8)
               if e["name"] == "dvm_quota"]
        assert evs and evs[-1]["sid"] == band
        assert evs[-1]["kind"] == "hbm_degrade"
        with pytest.raises(quota.QuotaExceeded, match="hbm quota"):
            quota.charge_hbm(64)       # continued breach: reject
    finally:
        statemod.set_current(None)
        quota.begin_run(band)
        _restore(saved)


def test_divergence_cache_share_quota_refused(tmp_path):
    """Divergence: ``dvm_quota_cache_share_pct`` caps one session's
    share of the reference's compiled-collective cache; the port has
    no such cache to bound, so a pool started with the knob nonzero is
    refused, naming why, before it binds or publishes anything — and at
    0 the same pool starts and serves."""
    from ompi_tpu_torch.coll import device
    assert not hasattr(device, "compile_cache")
    uri = tmp_path / "dvm.uri"
    saved = _set({"dvm_quota_cache_share_pct": 5})
    try:
        srv = DVMServer(2, devices=CPU, uri_file=str(uri))
        with pytest.raises(ValueError, match="no compiled-program cache"):
            srv.start()
        assert not uri.exists() and srv.listener is None
    finally:
        _restore(saved)
    srv, uri = _pool(tmp_path, 2)
    try:
        with DvmClient(uri) as c:
            sid = c.attach(2, timeout=T)["sid"]
            r = c.run(sid, PROG, ["cs"], timeout=T)
            c.detach(sid)
        assert r["code"] == 0 and _digest(r["stdout"], "cs")
    finally:
        srv.stop()


# -- the FleetController -----------------------------------------------------

def test_controller_grows_under_backlog_and_shrinks_idle(tmp_path):
    """dvm_ctrl=1: queued attaches make the controller grow the pool
    (admitting the backlog with no manual resize), and a sustained idle
    pool shrinks back to its floor."""
    saved = _set({"dvm_ctrl": 1,
                  "dvm_ctrl_max_ranks": 4,
                  "ctrl_tick_interval_ms": 50,
                  "ctrl_grow_queue_depth": 1,
                  "ctrl_grow_step": 2,
                  "ctrl_shrink_idle_ticks": 2,
                  "dvm_heartbeat_s": 0.3})
    try:
        srv, uri = _pool(tmp_path, 2)  # floor 2, ceiling 4
        assert srv.ctrl is not None
        c1 = DvmClient(uri)
        s1 = c1.attach(2, timeout=T)["sid"]
        c2 = DvmClient(uri)
        r2 = c2.attach(2, timeout=T)  # backlog -> controller grows
        assert srv.capacity == 4
        m = c2.metrics(events=4)
        assert m["ctrl"]["ticks"] > 0
        assert m["ctrl"]["shed_margin_pct"] >= 100
        assert m["epoch"] >= 1
        assert registry._pvars["ctrl_loop_ticks"].read() > 0
        c2.detach(r2["sid"])
        c1.detach(s1)
        _wait_for(lambda: srv.capacity == 2, timeout=30,
                  what="idle shrink back to the floor")
        c1.close()
        c2.close()
        srv.stop()
    finally:
        _restore(saved)


def test_controller_matches_reference_decisions():
    """The controller's decisions against a stub server are the
    reference's, tick by tick (grow under backlog, shed margin, idle
    shrink)."""
    import types

    from ompi_tpu.serve.controller import FleetController as RefCtrl
    from ompi_tpu_torch.serve.controller import FleetController

    def trace(cls):
        srv = types.SimpleNamespace(capacity=4, active_ranks=4,
                                    _waiters=[1, 2, 3], est_wall_us=0)
        c = cls(srv, floor=4, ceil=8)
        out = []
        for i, (q, a) in enumerate([(3, 4), (3, 4), (0, 0), (0, 0)] +
                                   [(0, 0)] * 30):
            srv._waiters = [0] * q
            srv.active_ranks = a
            c.tick(c.next_ns)
            out.append((c.want_capacity, c.shed_margin_pct,
                        c.wd_factor_pct, c.idle_ticks))
        return out

    assert trace(FleetController) == trace(RefCtrl)


def test_controller_tick_is_audited_hot():
    """The controller's decision tick rides the progress sweep, so it
    is declared to the hot-path audit — and passes it; so do the
    pool's journal and watchdog ticks."""
    from ompi_tpu_torch.tools.hotpath_audit import HOT_FUNCTIONS, audit
    assert "FleetController.tick" in HOT_FUNCTIONS[
        "ompi_tpu_torch/serve/controller.py"]
    assert {"_Journal.tick", "DVMServer._watchdog_tick"} <= set(
        HOT_FUNCTIONS["ompi_tpu_torch/tools/dvm.py"])
    assert audit() == []


# -- the control plane's chaos and its supervisor ------------------------------

def test_kill_injectors_disabled_by_default():
    """Empty plan = no injector objects: a production KV server or
    pool never pays for chaos plumbing."""
    from ompi_tpu_torch import ft_inject
    assert not ft_inject.enabled()
    assert ft_inject.kv_kill_injector() is None
    assert ft_inject.dvm_kill_injector() is None
    assert ft_inject.dvm_injector() is None


def test_kill_injector_fires_exactly_once_at_count():
    """The armed op count is deterministic (no RNG): False until op N,
    True AT op N, False forever after; rates below 1 arm the mid-run
    default.  The same sequence as the reference's injector."""
    from ompi_tpu.ft_inject import KillInjector as RefKill
    from ompi_tpu_torch.ft_inject import KillInjector
    ki = KillInjector("kv", 5)
    assert [ki.op() for _ in range(10)] == \
        [False] * 4 + [True] + [False] * 5
    rk = RefKill("kv", 5)
    assert [rk.op() for _ in range(10)] == \
        [False] * 4 + [True] + [False] * 5
    assert KillInjector("dvm", 0.02).after_ops == 64 == \
        RefKill("dvm", 0.02).after_ops


def test_dvm_kill_injector_armed_by_plan():
    """ft_inject_plan dvm_kill:N arms the server's one-shot kill at op
    N (serve() arms it on a subprocess pool only)."""
    from ompi_tpu_torch import ft_inject
    saved = _set({"ft_inject_plan": "dvm_kill:3"})
    try:
        ki = ft_inject.dvm_kill_injector()
        assert ki is not None and ki.scope == "dvm" and ki.after_ops == 3
    finally:
        _restore(saved)


def test_supervisor_respawns_and_heals_fault_plan(tmp_path):
    """Kill once, then heal: the first child sees the armed chaos env
    and dies; the respawn runs under respawn_env with the plan cleared
    and exits 0, which ends the loop."""
    from ompi_tpu_torch.tools.dvm import Supervisor
    marker = str(tmp_path / "runs.txt")
    prog = ("import os,sys\n"
            f"open({marker!r},'a').write("
            "os.environ.get('PROBE_CHAOS','-')+'\\n')\n"
            "sys.exit(7 if os.environ.get('PROBE_CHAOS') else 0)\n")
    env = dict(os.environ)
    env["PROBE_CHAOS"] = "1"
    heal = dict(os.environ)
    heal.pop("PROBE_CHAOS", None)
    sup = Supervisor([sys.executable, "-c", prog], env=env,
                     respawn_env=heal)
    rc = sup.run_forever()
    assert rc == 0
    assert sup.restarts == 1
    with open(marker) as f:
        assert f.read().split() == ["1", "-"]


# -- the request trace context: the minting half -----------------------------

def test_mint_parse_fmt_roundtrip():
    """mint gives distinct 63-bit positive ids with a span >= 1, in the
    reference's fmt/parse forms."""
    from ompi_tpu.obs import reqtrace as ref_reqtrace
    seen = set()
    for _ in range(1000):
        tid, span = reqtrace.mint()
        assert 0 < tid < 1 << 63
        assert tid not in seen
        seen.add(tid)
        assert span >= 1
    t = next(iter(seen))
    assert reqtrace.parse(reqtrace.fmt(t)) == t
    assert reqtrace.fmt(t) == ref_reqtrace.fmt(t)
    assert reqtrace.parse(str(t)) == t
    with pytest.raises(ValueError):
        reqtrace.parse("not-a-tid")


def test_mint_disabled_by_default():
    assert not reqtrace.enabled()
    saved = _set({"obs_reqtrace_enable": 1})
    try:
        assert reqtrace.enabled()
    finally:
        _restore(saved)
    assert not reqtrace.enabled()


def test_next_span_monotonic():
    a = reqtrace.next_span()
    b = reqtrace.next_span()
    assert b > a


def test_reqtrace_rides_attach_and_run(tmp_path):
    """With obs_reqtrace_enable the client mints a trace id at attach
    and a span a run; the pool keeps the id on the session and records
    the request's attach and run events under it."""
    srv, uri = _pool(tmp_path, 2)
    saved = _set({"obs_reqtrace_enable": 1})
    try:
        with DvmClient(uri) as c:
            r = c.attach(2, timeout=T)
            tid = r["tid"]
            assert tid > 0
            run = c.run(r["sid"], PROG, ["rt"], timeout=T)
            assert run["code"] == 0, run["stderr"][-2000:]
            with srv.lock:
                assert srv.sessions[r["sid"]].tid == tid
                assert srv.sessions[r["sid"]].span > 0
            m = c.metrics(events=64, prometheus=False)
            assert m["sessions"][str(r["sid"])]["tid"] == tid
            kinds = {e["name"] for e in m["events"]}
            assert {"req_attach", "req_run"} <= kinds, kinds
            c.detach(r["sid"])
    finally:
        _restore(saved)
        srv.stop()
