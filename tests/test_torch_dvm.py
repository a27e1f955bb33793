"""The port's resident pool (ompi_tpu_torch/tools/dvm.py) on the CPU:
analogs of the reference's tests/test_dvm.py on a
``DVMServer(8, devices=[cpu])`` — every session rank on the CPU, the
coll/hbm tier with the kernels' plain versions — and the pool's DIGEST
held against the reference pool's for the same session mix.

Concurrent sessions must print byte-identical digests to sequential
ones; admission control must queue and reject deterministically; halt
must drain in-flight runs; a client dying mid-run must never poison the
pool or a peer session (ft_inject dvm_disconnect); a failing session is
confined to itself; the journal rehydrates a session after a crash.

The reference's "warm" check counts compiled executables; the port has
no compiled-program cache, so its analog is the kernel loader: later
and concurrent sessions build and load no kernel library (on the CPU
the wrappers take their plain versions and load none at all; the chip
smoke test holds the same on the card).

Parity: ``examples/dvm_session.py`` through the port's pool and the
reference's ``tests/_dvm_session_prog.py`` through the reference's pool
(JAX on the CPU, as tests/test_dvm.py runs it) print the same DIGEST
line, solo and as two concurrent sessions with the cross-session window
open.  Tolerance: exact (sha256 of the result bytes).

Every RPC and join here carries its own timeout, so no test can hang
the run.
"""

import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import pytest
import torch

from ompi_tpu_torch.coll import fusion
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.tools.dvm import (DVMServer, DvmBusy, DvmClient,
                                      DvmError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "ompi_tpu_torch", "examples")
PROG = os.path.join(EX, "dvm_session.py")
SLOW_PROG = os.path.join(EX, "dvm_slow.py")
REF_PROG = os.path.join(REPO, "tests", "_dvm_session_prog.py")
CPU = [torch.device("cpu")]
T = 60  # seconds: every run / attach RPC of this file


@pytest.fixture
def pool(tmp_path):
    uri = str(tmp_path / "dvm.uri")
    srv = DVMServer(8, devices=CPU, uri_file=uri).start()
    yield srv, uri
    srv.stop()


def _set(vals, reg=registry):
    saved = {k: reg.get(k) for k in vals}
    for k, v in vals.items():
        reg.set(k, v)
    return saved


def _restore(saved, reg=registry):
    for k, v in saved.items():
        reg.set(k, v)


def _run_once(uri, tag, np_=4, prog=PROG):
    with DvmClient(uri) as c:
        sid = c.attach(np_, timeout=T)["sid"]
        resp = c.run(sid, prog, [tag], timeout=T)
        c.detach(sid)
    assert resp.get("code") == 0, resp.get("stderr", "")[-2000:]
    return resp["stdout"]


def _join(threads):
    for t in threads:
        t.join(timeout=T)
        assert not t.is_alive(), f"{t.name} still running after {T}s"


def _libs():
    from ompi_tpu_torch.kernels import build
    return sorted(build._libs)


def test_concurrent_sessions_byte_identical_and_warm(pool):
    """Two concurrent sessions == two sequential sessions, byte for
    byte — and after the sequential warm-up the concurrent pair builds
    and loads no kernel library (the loader's table is unchanged)."""
    srv, uri = pool
    seq = [_run_once(uri, "x") for _ in range(2)]
    assert seq[0] == seq[1]
    assert "DIGEST x " in seq[0]
    libs0 = _libs()
    outs = [None, None]

    def worker(i):
        outs[i] = _run_once(uri, "x")

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(2)]
    for t in threads:
        t.start()
    _join(threads)
    assert outs[0] == seq[0] and outs[1] == seq[0], (outs, seq)
    assert _libs() == libs0, "a concurrent session loaded a kernel library"
    with DvmClient(uri) as c:
        assert c.metrics(events=0)["kernel_libs"] == libs0


def test_session_argv_isolation(pool):
    """Two concurrent sessions with DIFFERENT argv each see their own
    (thread-local sys.argv proxy, not a process-global swap)."""
    srv, uri = pool
    outs = {}

    def worker(tag):
        outs[tag] = _run_once(uri, tag, np_=2)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in ("alpha", "beta")]
    for t in threads:
        t.start()
    _join(threads)
    assert "DIGEST alpha " in outs["alpha"]
    assert "DIGEST beta " in outs["beta"]
    assert "beta" not in outs["alpha"]


def _pair(uri, tag, prog):
    """Attach two sessions of 4 first (so the pool reports 2 resident
    before either program dispatches), run both at once, detach."""
    ca, cb = DvmClient(uri), DvmClient(uri)
    try:
        sa = ca.attach(4, timeout=T)["sid"]
        sb = cb.attach(4, timeout=T)["sid"]
        res = {}

        def runner(c, sid, key):
            res[key] = c.run(sid, prog, [tag], timeout=T)

        threads = [threading.Thread(target=runner, args=args)
                   for args in ((ca, sa, "a"), (cb, sb, "b"))]
        for t in threads:
            t.start()
        _join(threads)
        ca.detach(sa)
        cb.detach(sb)
    finally:
        ca.close()
        cb.close()
    for key in ("a", "b"):
        assert res[key]["code"] == 0, res[key]["stderr"][-2000:]
    return res["a"]["stdout"], res["b"]["stdout"]


def test_cross_session_batching_byte_identical(pool):
    """With the cross-session window open, fused batches from two
    concurrently-resident sessions coalesce into combined dispatches —
    results still byte-identical to the solo run, and the
    dvm_xsession pvars prove at least one combined dispatch."""
    srv, uri = pool
    baseline = _run_once(uri, "w")
    saved = _set({"dvm_batch_window_us": 800000})
    xb0 = fusion._pv_xbatches.read()
    xc0 = fusion._pv_xcolls.read()
    try:
        outs = _pair(uri, "w", PROG)
    finally:
        _restore(saved)
    assert outs == (baseline, baseline)
    assert fusion._pv_xbatches.read() > xb0, \
        "no combined cross-session dispatch happened inside the window"
    assert fusion._pv_xcolls.read() >= xc0 + 2
    assert fusion._xsession_hint == 0  # both detached


def test_admission_queue_and_reject(tmp_path):
    """Rank-capacity admission: wait=False rejects immediately when
    full; one waiter queues; a second is rejected by the queue bound;
    detach admits the queued waiter FIFO."""
    uri = str(tmp_path / "dvm.uri")
    srv = DVMServer(4, devices=CPU, uri_file=uri).start()
    saved = _set({"dvm_queue_max": 1})
    try:
        c1 = DvmClient(uri)
        s1 = c1.attach(4, timeout=T)["sid"]
        c2 = DvmClient(uri)
        with pytest.raises(DvmBusy):
            c2.attach(2, wait=False)
        got = {}

        def waiter():
            try:
                with DvmClient(uri) as c3:
                    r = c3.attach(2, timeout=T)
                    got.update(r)
                    c3.detach(r["sid"])
            except DvmError as e:  # surfaced by the assert below
                got["err"] = str(e)

        th = threading.Thread(target=waiter)
        th.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with srv.lock:
                if len(srv._waiters) == 1:
                    break
            time.sleep(0.02)
        with srv.lock:
            assert len(srv._waiters) == 1, "waiter never queued"
        c4 = DvmClient(uri)
        with pytest.raises(DvmBusy, match="queue full"):
            c4.attach(2, timeout=30)
        c4.close()
        c1.detach(s1)  # frees capacity -> the queued waiter admits
        _join([th])
        assert "sid" in got, got
        assert got["queued_us"] > 0
        c1.close()
        c2.close()
    finally:
        _restore(saved)
        srv.stop()


def test_halt_drains_inflight_runs(tmp_path):
    """Halt while a run is executing: the drain lets the run finish
    (code 0, output delivered) before the pool stops."""
    uri = str(tmp_path / "dvm.uri")
    srv = DVMServer(4, devices=CPU, uri_file=uri).start()
    c = DvmClient(uri)
    sid = c.attach(4, timeout=T)["sid"]
    res = {}

    def runner():
        res["resp"] = c.run(sid, SLOW_PROG, timeout=T)

    th = threading.Thread(target=runner)
    th.start()
    time.sleep(0.4)  # the run is inside its 1.5 s sleep now
    h = DvmClient(uri)
    hr = h.halt()
    assert hr.get("ok"), hr
    h.close()
    _join([th])
    assert res["resp"]["code"] == 0, res["resp"]
    assert "DONE" in res["resp"]["stdout"]
    with srv.lock:
        assert not srv.sessions, "halt left sessions resident"
    c.close()
    srv.stop()


def test_client_disconnect_mid_run_never_poisons_pool(pool):
    """ft_inject dvm_disconnect: a client that dies right after sending
    a run request leaves its job executing with no client.  The pool
    completes it, reaps the orphaned session, and leaves the pool and a
    concurrently-resident peer session untouched."""
    srv, uri = pool
    cb = DvmClient(uri)
    sb = cb.attach(4, timeout=T)["sid"]
    saved = _set({"ft_inject_plan": "dvm_disconnect:1",
                  "ft_inject_skip": 0})
    try:
        ca = DvmClient(uri)  # injector armed at construction
        sa = ca.attach(2, timeout=T)["sid"]
        with pytest.raises(DvmError, match="dvm_disconnect"):
            ca.run(sa, PROG, ["doomed"])
    finally:
        _restore(saved)
    rb = cb.run(sb, PROG, ["peer"], timeout=T)
    assert rb["code"] == 0, rb["stderr"][-2000:]
    assert "DIGEST peer " in rb["stdout"]
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        with srv.lock:
            n = len(srv.sessions)
        if n == 1:
            break
        time.sleep(0.05)
    assert n == 1, f"orphaned session never reaped ({n} resident)"
    cb.detach(sb)
    cb.close()


def test_failing_session_isolated(pool):
    """A program that raises poisons ONLY its own session: the run
    reports nonzero, the session is dead to further runs, and a peer
    session attached to the same pool keeps working — and a session
    attached right after prints the solo digest."""
    srv, uri = pool
    solo = _run_once(uri, "peer")
    with tempfile.NamedTemporaryFile(
            "w", suffix=".py", delete=False) as f:
        f.write("import ompi_tpu_torch\n"
                "comm = ompi_tpu_torch.init()\n"
                "raise RuntimeError('boom rank %d' % comm.rank)\n")
        bad = f.name
    try:
        cb = DvmClient(uri)
        sb = cb.attach(4, timeout=T)["sid"]
        ca = DvmClient(uri)
        sa = ca.attach(2, timeout=T)["sid"]
        ra = ca.run(sa, bad, timeout=T)
        assert ra["code"] != 0
        assert "boom" in ra["stderr"]
        with pytest.raises(DvmError, match="dead"):
            ca.run(sa, PROG, ["again"])
        rb = cb.run(sb, PROG, ["peer"], timeout=T)
        assert rb["code"] == 0, rb["stderr"][-2000:]
        assert rb["stdout"] == solo
        ca.detach(sa)
        cb.detach(sb)
        ca.close()
        cb.close()
        assert _run_once(uri, "peer") == solo
    finally:
        os.unlink(bad)


def test_proctable_published_and_pruned(pool):
    """Resident sessions publish {uri}.proctable.json entries mapping
    rank -> pool pid + thread; detach prunes them."""
    srv, uri = pool
    c = DvmClient(uri)
    r = c.attach(3, timeout=T)
    with open(uri + ".proctable.json") as f:
        table = json.load(f)
    tags = {e["tag"] for e in table}
    assert "pool" in tags
    assert {f"s{r['sid']}:r{i}" for i in range(3)} <= tags
    assert all(e["pid"] == os.getpid() for e in table)
    assert all("thread" in e for e in table)
    c.detach(r["sid"])
    c.close()
    with open(uri + ".proctable.json") as f:
        table2 = json.load(f)
    assert not any(e["tag"].startswith(f"s{r['sid']}:")
                   for e in table2)


def test_client_diagnostics(tmp_path):
    """The client fails fast and friendly: a missing uri-file, and a
    stale uri-file (pool exited, file left behind)."""
    with pytest.raises(DvmError, match="not found"):
        DvmClient(str(tmp_path / "nope.uri"))
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()  # nothing listens here any more
    stale = str(tmp_path / "stale.uri")
    with open(stale, "w") as f:
        f.write(f"127.0.0.1:{port}\n")
    with pytest.raises(DvmError, match="stale uri-file"):
        DvmClient(stale, connect_timeout=5)


def test_attach_pvars_and_jobid_counter(pool):
    """Attach latency feeds the dvm pvars, and inproc jobids ride a
    process-monotonic counter."""
    from ompi_tpu_torch.tools.dvm import _jobid_counter
    srv, uri = pool
    before = registry._pvars["dvm_attaches"].read()
    _run_once(uri, "pv", np_=2)
    assert registry._pvars["dvm_attaches"].read() == before + 1
    assert registry._pvars["dvm_attach_us_max"].read() > 0
    assert sum(registry._pvars["dvm_attach_hist"].read()) >= 1
    assert registry._pvars["dvm_sessions_peak"].read() >= 1
    ids = {f"dvm-{os.getpid()}-j{next(_jobid_counter)}"
           for _ in range(100)}
    assert len(ids) == 100


def test_detach_requires_ownership(pool):
    """A connection may only detach sessions IT attached."""
    srv, uri = pool
    ca = DvmClient(uri)
    sa = ca.attach(2, timeout=T)["sid"]
    cb = DvmClient(uri)
    with pytest.raises(DvmError, match="not attached"):
        cb.detach(sa)
    with srv.lock:
        assert sa in srv.sessions, "cross-client detach destroyed it"
    r = ca.run(sa, PROG, ["own"], timeout=T)
    assert r["code"] == 0, r["stderr"][-2000:]
    ca.detach(sa)
    ca.close()
    cb.close()


def test_detach_refused_while_running(pool):
    """_detach must not finalize/scrub a world whose rank-threads are
    mid-run (only drain and owner-death cleanup force through)."""
    srv, uri = pool
    c = DvmClient(uri)
    sid = c.attach(4, timeout=T)["sid"]
    res = {}

    def runner():
        res["r"] = c.run(sid, SLOW_PROG, timeout=T)

    th = threading.Thread(target=runner)
    th.start()
    time.sleep(0.4)  # the run is inside its sleep now
    with pytest.raises(DvmError, match="run in progress"):
        srv._detach(sid)
    _join([th])
    assert res["r"]["code"] == 0, res["r"]
    assert "DONE" in res["r"]["stdout"]
    c.detach(sid)
    c.close()


def test_early_rank_exit_releases_run_boundary_fence(pool):
    """One rank exits nonzero EARLY; its peers reach the run-boundary
    fence later.  The session's namespace abort fails that late fence
    at once instead of wedging the session and the client's run."""
    srv, uri = pool
    with tempfile.NamedTemporaryFile(
            "w", suffix=".py", delete=False) as f:
        f.write("import sys\nimport time\n"
                "import ompi_tpu_torch\n"
                "comm = ompi_tpu_torch.init()\n"
                "if comm.rank == 0:\n"
                "    sys.exit(3)\n"
                "time.sleep(1.0)\n")
        prog = f.name
    try:
        c = DvmClient(uri)
        sid = c.attach(2, timeout=T)["sid"]
        r = c.run(sid, prog, timeout=T)
        assert r["code"] == 3, r
        with pytest.raises(DvmError, match="dead"):
            c.run(sid, prog)
        c.detach(sid)
        c.close()
        with srv.lock:
            assert not srv.sessions, "session never released"
    finally:
        os.unlink(prog)


def test_same_jobid_submitted_twice_runs_exactly_once(pool):
    """A resubmitted jobid whose run already completed is acknowledged
    from the session's replay memory — same exit code, replayed=True,
    and the program does NOT run a second time."""
    srv, uri = pool
    with DvmClient(uri) as c:
        sid = c.attach(2, timeout=T)["sid"]
        msg = {"op": "run", "sid": sid,
               "prog": os.path.abspath(PROG), "args": ["dedup"],
               "jobid": "t-dedup-1"}
        r1 = c._rpc(dict(msg))
        assert r1["code"] == 0 and not r1.get("replayed"), r1
        assert "DIGEST dedup " in r1["stdout"]
        r2 = c._rpc(dict(msg))
        assert r2.get("replayed") is True, r2
        assert r2["code"] == 0
        assert r2["stdout"] == ""
        c.detach(sid)


def test_journal_rehydration_reattach_and_run(tmp_path):
    """Crash recovery in-process: a journal left behind by a dead
    incarnation makes the next server rehydrate the session PARKED;
    the client reattaches by token on the NEW incarnation and runs."""
    uri = str(tmp_path / "dvm.uri")
    srv = DVMServer(4, devices=CPU, uri_file=uri).start()
    jpath = uri + ".journal.jsonl"
    c = DvmClient(uri)
    sid = c.attach(2, timeout=T)["sid"]
    token = c._tokens[sid]
    inc1 = c.incarnation
    assert inc1
    with open(jpath, "rb") as f:
        journal = f.read()   # open + quota + attach records
    c.close()                # NOT detach: the session was live
    srv.stop()               # clean stop deletes the journal...
    assert not os.path.exists(jpath)
    with open(jpath, "wb") as f:
        f.write(journal)     # ...resurrect it: a crash left this
    srv2 = DVMServer(4, devices=CPU, uri_file=uri).start()
    try:
        assert srv2.rehydrated == 1
        c2 = DvmClient(uri)
        assert c2.incarnation and c2.incarnation != inc1
        r = c2.reattach(sid, token)
        assert r["ok"] and r["parked"], r
        resp = c2.run(sid, PROG, ["rehyd"], timeout=T)
        assert resp["code"] == 0, resp.get("stderr", "")[-2000:]
        assert "DIGEST rehyd " in resp["stdout"]
        c2.detach(sid)
        c2.close()
    finally:
        srv2.stop()


def test_reattach_bad_token_refused(pool):
    """A token mismatch is a FINAL verdict — never a silent takeover."""
    srv, uri = pool
    with DvmClient(uri) as c:
        sid = c.attach(1, timeout=T)["sid"]
        with DvmClient(uri) as thief:
            with pytest.raises(DvmError, match="token"):
                thief.reattach(sid, "not-the-token")
        c.detach(sid)


# -- the pool's process boundary --------------------------------------------

def test_embedded_pool_restores_stdio(tmp_path):
    """The pool's per-thread stdout/stderr/argv overlays are put back
    when an embedded pool stops: the host gets its own streams."""
    out, err, argv = sys.stdout, sys.stderr, list(sys.argv)
    srv = DVMServer(2, devices=CPU, uri_file=str(tmp_path / "u")).start()
    assert sys.stdout is not out and sys.stderr is not err
    srv.stop()
    assert sys.stdout is out and sys.stderr is err
    assert type(sys.argv) is list and sys.argv == argv


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_devices_auto_without_a_card_exits_and_starts_no_session(
        tmp_path):
    """``--devices auto`` on a machine with no card: the pool exits
    non-zero before it listens (no uri file, so no session can ever be
    attached) — it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    uri = str(tmp_path / "dvm.uri")
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.dvm", "--np", "2",
         "--devices", "auto", "--uri-file", uri],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=T)
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr, r.stderr
    assert not os.path.exists(uri)


def test_subprocess_pool_serves_and_halts(tmp_path):
    """The CLI pool (``--devices cpu``): a session runs the mix, and
    ``--halt`` drains it and ends the process with exit 0."""
    uri = str(tmp_path / "dvm.uri")
    p = subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.dvm", "--np", "4",
         "--devices", "cpu", "--uri-file", uri],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=REPO)
    try:
        deadline = time.monotonic() + T
        while not os.path.exists(uri) and time.monotonic() < deadline:
            assert p.poll() is None, p.stderr.read()
            time.sleep(0.05)
        out = _run_once(uri, "cli")
        assert "DIGEST cli " in out
        h = subprocess.run(
            [sys.executable, "-m", "ompi_tpu_torch.tools.dvm", "--halt",
             uri], capture_output=True, text=True, env=_env(), cwd=REPO,
            timeout=T)
        assert h.returncode == 0, h.stderr
        assert p.wait(timeout=T) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=T)


# -- parity with the reference's pool ----------------------------------------

def _digest(stdout, tag):
    for line in stdout.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[0] == "DIGEST" and parts[1] == tag:
            return line
    raise AssertionError(f"no DIGEST {tag} in: {stdout!r}")


@pytest.mark.parametrize("mode", ["solo", "concurrent_window_open"])
def test_digest_matches_reference_pool(mode, tmp_path):
    """The same session mix through the reference's pool (JAX on the
    CPU, its 8 virtual devices) and the port's pool prints the same
    DIGEST line: solo, and as two concurrent sessions of 4 with the
    cross-session window open (both combine: dvm_xsession_batches moves
    in each package)."""
    jax = pytest.importorskip("jax")
    from ompi_tpu.coll import fusion as ref_fusion
    from ompi_tpu.mca.params import registry as ref_registry
    from ompi_tpu.tools import dvm as ref_dvm

    lines = {}
    for name, server_cls, client_cls, devices, prog, reg, fus in (
            ("ref", ref_dvm.DVMServer, ref_dvm.DvmClient, jax.devices(),
             REF_PROG, ref_registry, ref_fusion),
            ("port", DVMServer, DvmClient, CPU, PROG, registry, fusion)):
        uri = str(tmp_path / f"{name}.uri")
        srv = server_cls(8, devices=devices, uri_file=uri).start()
        try:
            if mode == "solo":
                with client_cls(uri) as c:
                    sid = c.attach(4, timeout=T)["sid"]
                    r = c.run(sid, prog, ["par"], timeout=T)
                    c.detach(sid)
                assert r["code"] == 0, r["stderr"][-2000:]
                lines[name] = [_digest(r["stdout"], "par")]
            else:
                saved = _set({"dvm_batch_window_us": 800000}, reg)
                xb0 = fus._pv_xbatches.read()
                try:
                    ca, cb = client_cls(uri), client_cls(uri)
                    sa = ca.attach(4, timeout=T)["sid"]
                    sb = cb.attach(4, timeout=T)["sid"]
                    res = {}

                    def runner(c, sid, key, prog=prog):
                        res[key] = c.run(sid, prog, ["par"], timeout=T)

                    ths = [threading.Thread(target=runner, args=a)
                           for a in ((ca, sa, "a"), (cb, sb, "b"))]
                    for t in ths:
                        t.start()
                    _join(ths)
                    ca.detach(sa)
                    cb.detach(sb)
                    ca.close()
                    cb.close()
                finally:
                    _restore(saved, reg)
                for k in ("a", "b"):
                    assert res[k]["code"] == 0, res[k]["stderr"][-2000:]
                lines[name] = [_digest(res[k]["stdout"], "par")
                               for k in ("a", "b")]
                assert fus._pv_xbatches.read() > xb0, name
        finally:
            srv.stop()
    assert lines["port"] == lines["ref"], lines
    assert len(set(lines["port"])) == 1
