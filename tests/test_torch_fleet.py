"""The resident pool's fleet of host failure domains on the CPU
(ompi_tpu_torch/tools/dvm.py ``hosts > 1``, tools/tpud.py ``--fleet``):
analogs of the reference's tests/test_fleet.py host-domain tests on
``DVMServer(n, devices=[cpu], hosts=2)`` — every session rank on the
CPU, the coll/hbm tier with the kernels' plain versions.

Parity with the reference's own output: the reference's pool (JAX on
the CPU, as tests/test_fleet.py runs it) with two host domains prints
the same ``dvm_session`` DIGEST as the port's, and the reference's
``tests/_fleet_host_prog.py`` run unkilled on two ranks prints the
DIGEST the port's host-kill survivors and its checkpointing workload
print (the same accumulation formula).  Tolerance: exact (sha256 of the
result bytes).  Each package's pool has its own uri directory and KV
server.

Pinned divergences: the port's ``host_kill`` fault does not count the
agents' beats among the pool's served ops, since they arrive on the
wall clock (``test_divergence_host_kill_op_count_skips_beats``); the
replay arm's program checkpoints through ``cr.checkpoint`` /
``cr.restore`` until ``cr/ckpt.py`` (ROADMAP A9;
``test_host_kill_replay_arm_byte_identical``).  A host kill here lands
at the examples' ``--hold`` point (a file the program writes before it
blocks) instead of after the reference tests' sleeps.

Every RPC and join carries its own timeout, so no test can hang the
run.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.serve import controller as _controller
from ompi_tpu_torch.tools.dvm import DVMServer, DvmClient, DvmError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "ompi_tpu_torch", "examples")
PROG = os.path.join(EX, "dvm_session.py")
HOST_PROG = os.path.join(EX, "fleet_host.py")
CKPT_PROG = os.path.join(EX, "fleet_ckpt.py")
BUDDY_PROG = os.path.join(EX, "fleet_buddy.py")
REF_PROG = os.path.join(REPO, "tests", "_dvm_session_prog.py")
REF_HOST_PROG = os.path.join(REPO, "tests", "_fleet_host_prog.py")
CPU = [torch.device("cpu")]
T = 60  # seconds: every run / attach RPC and join of this file


def _set(vals, reg=registry):
    saved = {k: reg.get(k) for k in vals}
    for k, v in vals.items():
        reg.set(k, v)
    return saved


def _restore(saved, reg=registry):
    for k, v in saved.items():
        reg.set(k, v)


def _pool2(tmp_path, capacity, hosts=2):
    uri = str(tmp_path / "dvm.uri")
    srv = DVMServer(capacity, devices=CPU, uri_file=uri,
                    hosts=hosts).start()
    return srv, uri


def _lines(stdout, kind, tag):
    out = []
    for line in stdout.splitlines():
        parts = line.split()
        if len(parts) >= 3 and parts[0] == kind and parts[1] == tag:
            out.append(parts[2:])
    return out


def _digest(stdout, tag):
    got = _lines(stdout, "DIGEST", tag)
    assert got, f"no DIGEST {tag} in: {stdout!r}"
    return got[0][0]


def _wait_for(pred, timeout=T, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.01)


def _run_held(client, sid, prog, args, hold):
    """Start ``client.run`` on a thread and wait until the program has
    written its ``--hold`` file (it then blocks until the host dies).
    Returns (thread, result dict)."""
    res = {}

    def run():
        res["r"] = client.run(sid, prog, args, timeout=T)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    _wait_for(lambda: os.path.exists(hold) or not th.is_alive(),
              what=f"{prog} to reach its hold point")
    assert th.is_alive(), res.get("r")
    return th, res


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _ref_run(tmp_path, prog, args, np_, hosts=2):
    """One run through the reference's pool (JAX on the CPU)."""
    jax = pytest.importorskip("jax")
    from ompi_tpu.tools import dvm as ref_dvm
    d = tmp_path / "ref"
    d.mkdir(exist_ok=True)
    uri = str(d / "dvm.uri")
    srv = ref_dvm.DVMServer(max(np_, 2), devices=jax.devices(),
                            uri_file=uri, hosts=hosts).start()
    try:
        with ref_dvm.DvmClient(uri) as c:
            sid = c.attach(np_, timeout=T)["sid"]
            r = c.run(sid, prog, args, timeout=T)
            c.detach(sid)
    finally:
        srv.stop()
    assert r["code"] == 0, r["stderr"][-2000:]
    return r["stdout"]


def _port_run(uri, prog, args, np_):
    with DvmClient(uri) as c:
        sid = c.attach(np_, timeout=T)["sid"]
        r = c.run(sid, prog, args, timeout=T)
        c.detach(sid)
    assert r["code"] == 0, r["stderr"][-2000:]
    return r["stdout"]


# -- placement --------------------------------------------------------------

RING_CASES = [
    ([0, 0, 1, 1], 1, [2]),        # the unique host-safe offset
    ([0, 0, 1, 1], 3, [2, 1, 3]),  # past the host-safe supply
    ([0, 1, 0, 1], 1, [1]),        # interleaved: odd offsets cross
    ([0, 0, 0, 0], 2, [1, 2]),     # one host: the classic ring
    ([0, 0, 1], 1, [1]),           # no host-safe offset: plain ring
    ([7], 1, []),
    ([0, 0, 0, 0, 1, 1, 1, 1], 2, [4, 1]),
]


@pytest.mark.parametrize("nodes,deg,want", RING_CASES)
def test_ring_offsets_matches_reference(nodes, deg, want):
    """cr/buddy's partner ring over a pool's host bands: off-host
    partners whenever the placement allows, the classic ring when it
    cannot — the reference's offsets, case by case."""
    from ompi_tpu.cr.buddy import ring_offsets as ref_offsets

    from ompi_tpu_torch.cr.buddy import ring_offsets
    assert ring_offsets(nodes, deg) == ref_offsets(nodes, deg) == want


def test_two_host_attach_byte_identical(tmp_path):
    """One attach spans both host domains: the ranks band as
    ``rank * hosts // np`` (the proctable's ``hdom``), stats reads the
    quiet fleet, and the session's DIGEST equals the one-host pool's
    and the reference's two-host pool's."""
    (tmp_path / "one").mkdir()
    srv1, uri1 = _pool2(tmp_path / "one", 4, hosts=1)
    try:
        base = _digest(_port_run(uri1, PROG, ["xh"], 4), "xh")
    finally:
        srv1.stop()
    srv, uri = _pool2(tmp_path, 4)
    try:
        with DvmClient(uri) as c:
            r = c.attach(4, timeout=T)
            assert r["hosts"] == 2
            with open(f"{uri}.proctable.json") as fh:
                table = json.load(fh)
            assert [e["hdom"] for e in table if "hdom" in e] \
                == [0, 0, 1, 1], table
            out = c.run(r["sid"], PROG, ["xh"], timeout=T)
            assert out["code"] == 0, out["stderr"][-2000:]
            st = c.stats()
            assert st["hosts"] == 2 and st["hosts_lost"] == 0
            assert st["hosts_degraded"] == 0
            assert st["hosts_quarantined"] == 0
            assert st["hosts_rehydrating"] == 0
            c.detach(r["sid"])
    finally:
        srv.stop()
    assert _digest(out["stdout"], "xh") == base
    assert _digest(_ref_run(tmp_path, REF_PROG, ["xh"], 4), "xh") == base


# -- host kill under ULFM ---------------------------------------------------


def test_host_kill_shrink_single_failure_set(tmp_path):
    """A host killed mid-loop under ULFM: its ranks land in ONE failure
    set, so each survivor shrinks exactly once; the survivors' digests
    and card digests are equal, equal to an unkilled run on two ranks
    and to the reference's.  respawn_host reports a real MTTR and
    refills the fleet."""
    srv, uri = _pool2(tmp_path, 4)
    lost0 = registry._pvars["fleet_hosts_lost"].read()
    try:
        with DvmClient(uri) as c, DvmClient(uri) as ops:
            two = _port_run(uri, HOST_PROG,
                            ["s2", "12", "--device", "cpu", "--mib", "1"], 2)
            sid = c.attach(4, timeout=T)["sid"]
            hold = str(tmp_path / "hold")
            th, res = _run_held(c, sid, HOST_PROG,
                                ["sa", "12", "--hold", "3", hold,
                                 "--device", "cpu", "--mib", "1"], hold)
            ops.kill_host(1)
            assert srv._host_dead[1] == 1
            assert srv.hosts_rehydrating == 1
            th.join(timeout=T)
            assert not th.is_alive()
            r = res["r"]
            assert r["code"] == 0, r["stderr"][-2000:]
            shrinks = _lines(r["stdout"], "SHRINKS", "sa")
            assert sorted(int(s[0]) for s in shrinks) == [0, 1], shrinks
            assert all(int(s[1]) == 1 for s in shrinks), shrinks
            digs = {d[0] for d in _lines(r["stdout"], "DIGEST", "sa")}
            cards = {d[1] for d in _lines(r["stdout"], "CARD", "sa")}
            assert digs == {_digest(two, "s2")}, (digs, two)
            assert cards == {d[1] for d in _lines(two, "CARD", "s2")}
            st = ops.stats()
            assert st["hosts_lost"] == 1 and st["hosts_rehydrating"] == 1
            rr = ops.respawn_host(1)
            assert rr["mttr_ms"] > 0
            assert srv.hosts_rehydrating == 0 and srv._host_dead[1] == 0
            assert ops.stats()["hosts_lost"] == 0
            assert registry._pvars["fleet_hosts_lost"].read() == lost0 + 1
            c.detach(sid)
    finally:
        srv.stop()
    ref = _ref_run(tmp_path, REF_HOST_PROG, ["s2", "12"], 2)
    assert digs == {_digest(ref, "s2")}


def test_divergence_host_kill_op_count_skips_beats(tmp_path):
    """Pinned divergence: the ft_inject ``host_kill`` fault severs
    ``ft_inject_victim_host`` at the pool's Nth served op — the same
    lost-domain handling as heartbeat silence — and, unlike the
    reference, an agent's beats are not counted among those ops."""
    saved = _set({"ft_inject_plan": "host_kill:4", "ft_inject_skip": 0,
                  "ft_inject_victim_host": 1})
    try:
        srv, uri = _pool2(tmp_path, 4)
        try:
            assert srv._hkill is not None
            with DvmClient(uri) as agent, DvmClient(uri) as c:
                r = agent._rpc({"op": "host_register", "host": 1,
                                "pid": 0})                       # op 1
                assert r["ok"] and r["grace_s"] > 0
                for _ in range(5):
                    assert agent._rpc({"op": "host_beat",
                                       "host": 1})["ok"]  # not counted
                c.stats()                                        # op 2
                c.stats()                                        # op 3
                assert srv._host_dead[1] == 0
                c.stats()                                        # op 4
                assert srv._host_dead[1] == 1
                assert srv.hosts_rehydrating == 1
                assert c.stats()["hosts_lost"] == 1
        finally:
            srv.stop()
    finally:
        _restore(saved)


def test_host_kill_replay_arm_byte_identical(tmp_path):
    """A host killed under a session that is NOT ULFM-aware
    (mpi_ft_ulfm=0): the session parks, waits out the rehydration and
    replays from its checkpoint — one run with exit code 0, resumed at
    the hold step, the unkilled baseline's digest (which is also the
    reference's two-rank ``_fleet_host_prog`` digest: one formula)."""
    saved = _set({"mpi_ft_ulfm": 0})
    try:
        srv, uri = _pool2(tmp_path, 4)
        try:
            base = _port_run(uri, CKPT_PROG,
                             ["hb", str(tmp_path / "sa"), "10",
                              "--device", "cpu"], 2)
            with DvmClient(uri) as c, DvmClient(uri) as ops:
                sid = c.attach(2, timeout=T)["sid"]
                hold = str(tmp_path / "hold")
                th, res = _run_held(
                    c, sid, CKPT_PROG,
                    ["hb", str(tmp_path / "sv"), "10", "--hold", "4",
                     hold, "--device", "cpu"], hold)
                ops.kill_host(1)
                assert ops.respawn_host(1)["mttr_ms"] > 0
                th.join(timeout=T)
                assert not th.is_alive()
                r = res["r"]
                assert r["code"] == 0, r["stderr"][-2000:]
                assert r.get("preempted", 0) >= 1
                assert _lines(r["stdout"], "STEPS", "hb") == [["4"]]
                c.detach(sid)
        finally:
            srv.stop()
    finally:
        _restore(saved)
    assert _digest(r["stdout"], "hb") == _digest(base, "hb")
    assert _lines(r["stdout"], "CARD", "hb") == _lines(base, "CARD", "hb")
    ref = _ref_run(tmp_path, REF_HOST_PROG, ["hb", "10"], 2)
    assert _digest(base, "hb") == _digest(ref, "hb")


def test_buddy_restore_from_off_host_partner(tmp_path):
    """On a two-host pool the buddy ring reads each rank's host band
    (its node_id) and places every replica off-host, so host 1's ranks
    restore from host 0 partners after losing their own copies."""
    srv, uri = _pool2(tmp_path, 4)
    try:
        out = _port_run(uri, BUDDY_PROG, ["bd", "--device", "cpu"], 4)
    finally:
        srv.stop()
    oks = _lines(out, "BUDDY", "bd")
    assert sorted(int(o[0]) for o in oks) == [0, 1, 2, 3], out
    assert len(_lines(out, "CARD", "bd")) == 1


# -- the federated journal --------------------------------------------------


def test_host_journal_federation_and_bounded_replay(tmp_path):
    """Per-host journals federate under one incarnation (a session's
    records land in host ``sid % hosts``'s file); completed-jobid
    replay memory stays bounded at 64 through a torn tail, compaction
    and two incarnations."""
    srv, uri = _pool2(tmp_path, 4)
    c = DvmClient(uri)
    sid = c.attach(2, timeout=T)["sid"]  # sid 1 -> host 1's journal
    r = c.run(sid, PROG, ["fj"], timeout=T)
    assert r["code"] == 0, r["stderr"][-2000:]
    h0_path = f"{uri}.journal.jsonl"
    h1_path = f"{uri}.journal.h1.jsonl"

    def _read(p):
        with open(p) as fh:
            return fh.read()

    _wait_for(lambda: '"run_done"' in _read(h1_path),
              what="run_done flushed to the host journal")
    h0, h1 = _read(h0_path), _read(h1_path)
    assert '"attach"' not in h0
    assert '"attach"' in h1 and '"run_done"' in h1
    assert json.loads(h0.splitlines()[0])["inc"] \
        == json.loads(h1.splitlines()[0])["inc"]
    c.sock.close()  # vanish without detach: the session must replay
    srv.stop()      # deletes both journals
    fakes = "".join(json.dumps({"t": "run_done", "sid": sid,
                                "jobid": f"fake-{i}", "code": 0}) + "\n"
                    for i in range(80))
    with open(h0_path, "w") as fh:
        fh.write(h0)
    with open(h1_path, "w") as fh:
        fh.write(h1 + fakes + '{"t": "run_done", "sid')  # torn tail
    srv2 = DVMServer(4, devices=CPU, uri_file=uri, hosts=2).start()
    try:
        assert srv2.rehydrated == 1
        sess = srv2.sessions[sid]
        assert sess.parked and len(sess.completed) <= 64
        h1b, h0b = _read(h1_path), _read(h0_path)
        assert h1b.count('"run_done"') <= 64
    finally:
        srv2.stop()
    with open(h0_path, "w") as fh:
        fh.write(h0b)
    with open(h1_path, "w") as fh:
        fh.write(h1b)
    srv3 = DVMServer(4, devices=CPU, uri_file=uri, hosts=2).start()
    try:
        assert srv3.rehydrated == 1
        assert len(srv3.sessions[sid].completed) <= 64
    finally:
        srv3.stop()


@pytest.mark.parametrize("how", ["halt_rpc", "stop"])
def test_clean_halt_deletes_federated_journals(tmp_path, how):
    """A journal on disk always means a crash: a clean halt (the RPC,
    or an embedded pool's stop) deletes every host's journal."""
    srv, uri = _pool2(tmp_path, 4)
    c = DvmClient(uri)
    c.attach(2, timeout=T)  # sid 1 -> host 1's journal
    assert os.path.exists(f"{uri}.journal.jsonl")
    assert os.path.exists(f"{uri}.journal.h1.jsonl")
    if how == "halt_rpc":
        c.halt()
    c.close()
    srv.stop()
    assert not os.path.exists(f"{uri}.journal.jsonl")
    assert not os.path.exists(f"{uri}.journal.h1.jsonl")


# -- host agents and the CLI ------------------------------------------------


def _agent(uri, host):
    return subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.tpud", "--fleet",
         uri, "--host", str(host)], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=REPO)


def test_tpud_fleet_registers_beats_and_dies_with_its_host(tmp_path):
    """``tpud --fleet URI --host H`` registers, then beats; a host kill
    SIGKILLs the agent's process (the liveness signal), and the other
    agent exits 0 when the pool halts.  The agent imports no torch."""
    saved = _set({"dvm_heartbeat_s": 0.2})
    try:
        srv, uri = _pool2(tmp_path, 4)
        agents = [_agent(uri, h) for h in (0, 1)]
        try:
            _wait_for(lambda: len(srv._host_agents) == 2,
                      what="both agents registered")
            first = list(srv._host_beat)
            _wait_for(lambda: all(b > f for b, f in
                                  zip(srv._host_beat, first)),
                      what="both agents beating")
            srv.kill_host(1)
            assert agents[1].wait(timeout=T) == -signal.SIGKILL
            with DvmClient(uri) as c:
                c.halt()
            assert agents[0].wait(timeout=T) == 0, agents[0].stderr.read()
        finally:
            for a in agents:
                if a.poll() is None:
                    a.kill()
                    a.wait(timeout=T)
            srv.stop()
    finally:
        _restore(saved)
    r = subprocess.run(
        [sys.executable, "-c", "import sys, ompi_tpu_torch.tools.tpud, "
         "ompi_tpu_torch.tools.dvm; print('torch' in sys.modules)"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=T)
    assert r.stdout.strip() == "False", r.stderr


def test_heartbeat_silence_declares_host_lost(tmp_path):
    """An agent that stops beating (SIGSTOP: alive, silent) is the
    production silence path: past the grace horizon the pool declares
    its whole host lost, one record, with no kill RPC."""
    saved = _set({"dvm_heartbeat_s": 0.2, "oob_host_grace_s": 0.1,
                  "health_enable": 0})
    try:
        srv, uri = _pool2(tmp_path, 4)
        agent = _agent(uri, 1)
        try:
            _wait_for(lambda: 1 in srv._host_agents,
                      what="agent registered")
            assert srv.health is None
            os.kill(agent.pid, signal.SIGSTOP)
            _wait_for(lambda: srv._host_dead[1] == 1, timeout=20,
                      what="silent host declared lost")
            assert srv.hosts_rehydrating == 1
        finally:
            agent.kill()
            agent.wait(timeout=T)
            srv.stop()
    finally:
        _restore(saved)


def test_cli_kill_and_respawn_host(tmp_path):
    """``tpu-dvm --kill-host H`` / ``--respawn-host H`` against a
    running fleet (named by ``--uri-file``); a host outside the fleet
    is refused with a non-zero exit."""
    srv, uri = _pool2(tmp_path, 4)
    try:
        def cli(*args):
            return subprocess.run(
                [sys.executable, "-m", "ompi_tpu_torch.tools.dvm",
                 "--uri-file", uri, *args], capture_output=True,
                text=True, env=_env(), cwd=REPO, timeout=T)

        r = cli("--kill-host", "1")
        assert r.returncode == 0 and "host 1 severed" in r.stderr, r.stderr
        assert srv._host_dead[1] == 1
        r = cli("--respawn-host", "1")
        assert r.returncode == 0 and "mttr" in r.stderr, r.stderr
        assert srv._host_dead[1] == 0
        r = cli("--kill-host", "5")
        assert r.returncode == 1 and "outside fleet" in r.stderr, r.stderr
        with DvmClient(uri) as c, pytest.raises(DvmError, match="outside"):
            c.respawn_host(7)
    finally:
        srv.stop()


def test_controller_respawns_dead_hosts_and_holds_shrink(tmp_path):
    """The controller's fleet half: no shrink while a host rehydrates,
    and with ctrl_host_respawn=1 its apply sweep re-places a dead
    host domain itself."""
    srv, uri = _pool2(tmp_path, 4)
    try:
        ctrl = _controller.FleetController(srv, floor=2, ceil=8)
        ctrl.shrink_ticks = 1
        srv.capacity = 4
        srv.kill_host(1)
        ctrl.tick(10 ** 18)
        assert ctrl.idle_ticks == 0 and not ctrl.want_capacity
        ctrl.apply()
        assert srv._host_dead[1] == 1  # ctrl_host_respawn off: operator's
        saved = _set({"ctrl_host_respawn": 1})
        try:
            ctrl.apply()
        finally:
            _restore(saved)
        assert srv._host_dead[1] == 0 and srv.hosts_rehydrating == 0
        ctrl.next_ns = 0
        ctrl.tick(10 ** 18 + 1)
        assert ctrl.want_capacity == 2  # idle and whole: may shrink
    finally:
        srv.stop()
