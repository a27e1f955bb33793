"""Live recovery, restart and migration through the port's launcher
(ompi_tpu_torch/runtime/ft.py, mpirun's ``recover`` and ``restart``
errmgr policies, ``--ckpt-dir``/``--restart``, tools/restart.py and
tools/migrate.py), with the reference beside it where it runs.

The analogs of tests/test_failures.py (its live recovery and its
failure-path cases), of tests/test_cr.py's three launcher cases (kill
and ``tools.restart``, the restart policy, ``tools.migrate``) and of
tests/test_grayfail.py's whole-host evacuation plan.  The jobs run the
port's examples (``ft_prog.py``, ``ckpt_prog.py``) on the CPU
(``--device cpu``); their final answers are held to the reference's
``tests/_ckpt_prog.py`` under the reference's mpirun, and to the closed
form of the accumulation.  Tolerance: exact (the sums are of small
integers).

Pinned divergence, a fault of the reference fixed in the port's copy:
the reference's ``runtime/ft.recover`` leaves a re-routed rank that a
survivor's transport already declared dead in ULFM's failed set, so
its first collective after the recovery raises MPI_ERR_PROC_FAILED
(tests/test_failures.py::test_daemon_loss_live_recovery fails on it);
the port's un-fails the re-routed ranks before its epoch fences
(``test_divergence_recover_unfails_the_rerouted_ranks``, and the job
here).  The daemon killed mid-job is found through the launcher's own
records (``--verbose state`` names each daemon's pid as it
registers), not by scanning the process table.

Every subprocess has its own timeout.
"""

import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ompi_tpu_torch.ft import ulfm
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.runtime import ft
from ompi_tpu_torch.testing import mpirun_run, run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join(REPO, "ompi_tpu_torch", "examples")
FT_PROG = os.path.join(EX, "ft_prog.py")
CKPT_PROG = os.path.join(EX, "ckpt_prog.py")
REF_CKPT_PROG = os.path.join(REPO, "tests", "_ckpt_prog.py")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _run(cmd, timeout=120, **extra):
    return subprocess.run(cmd, capture_output=True, env=_env(**extra),
                          cwd=REPO, timeout=timeout)


def _mpirun(*args):
    return [sys.executable, "-m", "ompi_tpu_torch.tools.mpirun", *args]


def _final(out: bytes) -> str:
    return [ln for ln in out.decode().splitlines()
            if ln.startswith("final ")][0]


def _card(out: bytes) -> str:
    return [ln.split()[1] for ln in out.decode().splitlines()
            if ln.startswith("CARD ")][0]


def _digest(vals) -> str:
    return hashlib.sha256(np.asarray(vals, np.float64).tobytes()).hexdigest()


def _ref_baseline(tmp_path, np_, *extra):
    """The reference's uninterrupted ``_ckpt_prog.py`` run: its final
    line."""
    r = _run([sys.executable, "-m", "ompi_tpu.tools.mpirun", "-np",
              str(np_), *extra, "--ckpt-dir", str(tmp_path / "refjob"),
              REF_CKPT_PROG], timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return _final(r.stdout)


# ---- the live recovery job -------------------------------------------


def test_daemon_loss_live_recovery(tmp_path):
    """SIGKILL a DAEMON (not a rank) mid-job under --simulate-nodes with
    the recover errmgr policy: the dead node's rank is re-routed onto a
    survivor at a bumped epoch, every rank meets in a Barrier and an
    Allreduce on COMM_WORLD right after the epoch reset (where the
    reference raises), rolls back to the latest snapshot, and the job
    ends with an uninterrupted run's final line — no whole-job
    relaunch."""
    store = str(tmp_path / "store")
    proc = subprocess.Popen(
        _mpirun("-np", "3", "--simulate-nodes", "3x1",
                "--ranks-per-proc", "1", "--ckpt-dir", store,
                "--timeout", "150", "--verbose", "state",
                "--mca", "errmgr_base_policy", "recover",
                FT_PROG, "--device", "cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_env(),
        cwd=REPO, text=True)
    err = []
    reader = threading.Thread(target=lambda: err.extend(proc.stderr),
                              daemon=True)
    reader.start()
    out = []
    try:
        deadline = time.monotonic() + 120
        for ln in proc.stdout:
            out.append(ln)
            if "ft: step 3 done" in ln:
                break
            assert time.monotonic() < deadline, "".join(out)[-800:]
        pids = [m.group(1) for m in (
            re.search(r"daemon sim1 \(node \d+\) registered, pid (\d+)",
                      e) for e in list(err)) if m]
        assert len(pids) == 1, "".join(err)[-2000:]
        os.kill(int(pids[0]), signal.SIGKILL)
        out += proc.stdout.readlines()
        proc.wait(timeout=150)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    text, errt = "".join(out), "".join(err)
    assert proc.returncode == 0, text[-1200:] + errt[-2500:]
    assert "recovering in place: re-routing ranks [1]" in errt, errt
    assert "RECOVERING (re-route epoch" in errt, errt
    assert "relaunching from snapshot" not in errt, errt
    assert re.search(r"rank [02]: recovering( after transport error)? "
                     r"\(epoch 1\)", text), text
    for rank in range(3):
        assert f"rank {rank}: world ok after recovery (3 ranks)" in text
    m = re.search(r"rank 1 on node (\w+)", text)
    assert m and m.group(1) != "sim1", text
    # the final line of an uninterrupted run, in closed form:
    # sum over steps s = 1..10 of s * (1 + 2 + 3)
    want = [float(6 * sum(range(1, 11)))] * 4
    assert _final(text.encode()) == f"final step=10 acc={want}"
    assert _card(text.encode()) == _digest(want)


def test_divergence_recover_unfails_the_rerouted_ranks():
    """A thread world's ``recover``: after a survivor-side failure
    record for rank 1 (the transport's verdict on the dead
    incarnation) and an epoch reset, a Barrier, an Allreduce and a
    coll/hbm ``allreduce_arr`` on COMM_WORLD succeed on every rank —
    the reference raises MPI_ERR_PROC_FAILED at the first of them.
    The reset drops every per-communicator cache of ulfm's list (the
    one shrink and respawn purge), and the hbm tier rebuilds its own on
    the next device collective."""
    saved = os.environ.get("TPUMPI_RESTART")

    def fn(comm):
        x = torch.arange(1031, dtype=torch.float32) % 13 + comm.rank
        comm.allreduce_arr(x, port_op.SUM)
        filled = {k for k in ulfm._COMM_CACHE_KEYS if k in comm.__dict__}
        comm.Barrier()
        u = comm.state.ulfm
        if comm.rank != 1:
            u.deliver(("fail", 1))
            u.poll()
        was_failed = 1 in u.failed
        ft.recover(comm, ft.JobRecovery(1, {"failed": [1]}))
        left = {k for k in ulfm._COMM_CACHE_KEYS if k in comm.__dict__}
        comm.Barrier()
        tot = np.empty(1)
        comm.Allreduce(np.ones(1), tot, port_op.SUM)
        y = comm.allreduce_arr(x, port_op.SUM)
        refilled = "_hbm_one_device" in comm.__dict__
        return (was_failed, sorted(u.failed), sorted(filled), sorted(left),
                float(tot[0]), y.tolist() == (
                    (torch.arange(1031) % 13) * 4 + 6).float().tolist(),
                refilled)

    try:
        out = run_ranks(4, fn, device_map=lambda r: torch.device("cpu"),
                        timeout=60)
    finally:
        if saved is None:
            os.environ.pop("TPUMPI_RESTART", None)
        else:
            os.environ["TPUMPI_RESTART"] = saved
    for rank, (was, failed, filled, left, tot, ok, refilled) in \
            enumerate(out):
        assert was == (rank != 1) and failed == []
        assert "_hbm_one_device" in filled and left == []
        assert tot == 4.0 and ok and refilled


def test_recover_policy_without_a_snapshot_tears_down(tmp_path):
    """The recover policy needs a complete snapshot to roll back to:
    a daemon lost before the first one tears the job down, as the
    reference's does."""
    prog = tmp_path / "wait.py"
    prog.write_text(
        "import os, sys, time\n"
        "import ompi_tpu_torch\n"
        "comm = ompi_tpu_torch.init(device='cpu')\n"
        "if comm.rank == 1:\n"
        "    os.kill(os.getppid(), 9)\n"
        "time.sleep(30)\n")
    r = _run(_mpirun("-np", "2", "--simulate-nodes", "2x1",
                     "--ranks-per-proc", "1", "--timeout", "60",
                     "--ckpt-dir", str(tmp_path / "store"),
                     "--mca", "errmgr_base_policy", "recover", str(prog)),
             timeout=90)
    err = r.stderr.decode()
    assert r.returncode != 0
    assert "no complete snapshot yet" in err, err[-2000:]


# ---- restart and migration (tests/test_cr.py) ------------------------


def test_checkpoint_kill_restart_under_mpirun(tmp_path):
    """Kill a job mid-iteration (rank 2 exits after the step-5
    checkpoint), restart it from its store with tools.restart: it
    resumes and ends with the reference's uninterrupted final line and
    the same card digest as an uninterrupted port run."""
    store = str(tmp_path / "store")
    ref_line = _ref_baseline(tmp_path, 4)
    base = _run(_mpirun("-np", "4", "--ckpt-dir", str(tmp_path / "base"),
                        "--timeout", "90", CKPT_PROG, "--device", "cpu"))
    assert base.returncode == 0, base.stderr.decode()[-2000:]
    assert _final(base.stdout) == ref_line
    r1 = _run(_mpirun("-np", "4", "--ckpt-dir", store, "--timeout", "90",
                      CKPT_PROG, "--device", "cpu"), CKPT_CRASH_AT="5")
    assert r1.returncode != 0
    from ompi_tpu_torch import cr
    assert cr.Store(store).latest_complete() is not None
    r2 = _run([sys.executable, "-m", "ompi_tpu_torch.tools.restart",
               store])
    assert r2.returncode == 0, r2.stderr.decode()[-2000:]
    line = _final(r2.stdout)
    assert "resumed=True" in line
    assert line.replace("resumed=True", "resumed=False") == ref_line
    assert _card(r2.stdout) == _card(base.stdout)
    job = json.load(open(os.path.join(store, "job.json")))
    assert job["np"] == 4 and job["devices"] == "auto"


def test_errmgr_restart_policy_auto_recovers(tmp_path):
    """With the restart errmgr policy a rank's death mid-run relaunches
    the whole job from the latest complete snapshot, and the job ends
    with the reference's uninterrupted final line."""
    ref_line = _ref_baseline(tmp_path, 4)
    r = _run(_mpirun("-np", "4", "--ckpt-dir", str(tmp_path / "store"),
                     "--timeout", "90", "--verbose", "state",
                     "--mca", "errmgr_base_policy", "restart",
                     CKPT_PROG, "--device", "cpu"),
             timeout=180, CKPT_CRASH_AT="5")
    err = r.stderr.decode()
    assert r.returncode == 0, err[-2000:]
    assert "DRAINING -> RESTARTING" in err
    line = _final(r.stdout)
    assert "resumed=True" in line
    assert line.replace("resumed=True", "resumed=False") == ref_line


def test_migrate_moves_ranks_to_other_nodes(tmp_path):
    """orte-migrate analog: kill a simulated multi-node job mid-run,
    restart it with rank 2 MOVED onto sim0 through tools.migrate; the
    moved rank runs there and the job ends with the reference's final
    line (placement independence)."""
    store = str(tmp_path / "store")
    r1 = _run(_mpirun("-np", "3", "--simulate-nodes", "3x1",
                      "--ranks-per-proc", "1", "--ckpt-dir", store,
                      "--timeout", "90", CKPT_PROG, "--device", "cpu"),
              CKPT_CRASH_AT="4")
    assert r1.returncode != 0
    r2 = _run([sys.executable, "-m", "ompi_tpu_torch.tools.migrate", store,
               "--move", "2=sim0"])
    out = r2.stdout.decode()
    assert r2.returncode == 0, out[-800:] + r2.stderr.decode()[-2000:]
    line = _final(r2.stdout)
    assert "resumed=True" in line
    assert "rank 2 on node sim0" in out, out[-1200:]
    ref_line = _ref_baseline(tmp_path, 3, "--ranks-per-proc", "1")
    assert line.replace("resumed=True", "resumed=False") == ref_line


def test_migrate_evacuate_plans_whole_host(tmp_path):
    """--evacuate NODE computes the per-rank moves itself, exactly as
    the reference's plan does; a prior migration's rankfile is the
    effective placement, so evacuating the emptied node again is an
    error."""
    from ompi_tpu.tools import migrate as ref_migrate
    from ompi_tpu_torch.tools import migrate
    store = tmp_path / "store"
    store.mkdir()
    (store / "job.json").write_text(json.dumps(
        {"np": 4, "simulate": "2x2", "rpp": 1, "prog": "app.py",
         "args": [], "map_by": "byslot", "devices": "cpu"}))
    cmd, rankfile, moves = migrate.plan_evacuation(str(store), "sim1")
    rcmd, rrankfile, rmoves = ref_migrate.plan_evacuation(str(store),
                                                          "sim1")
    assert (rankfile, moves) == (rrankfile, rmoves)
    assert moves == {2: "sim0", 3: "sim0"}
    assert "rank 2=sim0" in rankfile and "rank 3=sim0" in rankfile
    assert cmd[1:3] == ["-m", "ompi_tpu_torch.tools.mpirun"]
    assert "--restart" in cmd and "--oversubscribe" in cmd
    # the port's launch record carries the rank-threads' devices
    assert cmd[cmd.index("--devices") + 1] == "cpu"
    with pytest.raises(ValueError, match="unknown node"):
        migrate.plan_evacuation(str(store), "nosuch")
    (store / "migrate.rankfile").write_text(rankfile)
    with pytest.raises(ValueError, match="no rank currently placed"):
        migrate.plan_evacuation(str(store), "sim1")


def test_restart_command_replays_the_launch_record(tmp_path):
    """tools.restart rebuilds the reference's command from job.json
    (the port's mpirun, and its recorded devices)."""
    from ompi_tpu.tools import restart as ref_restart
    from ompi_tpu_torch.tools import restart
    job = {"np": 3, "prog": "app.py", "args": ["--x", "1"],
           "mca": [["cr_keep", "2"]], "rpp": "all", "simulate": "3x1",
           "map_by": "bynode", "oversubscribe": True, "devices": "cpu"}
    (tmp_path / "job.json").write_text(json.dumps(job))
    cmd = restart.build_cmd(str(tmp_path), ["--timeout", "9"])
    ref = ref_restart.build_cmd(str(tmp_path), ["--timeout", "9"])
    i = cmd.index("--devices")
    assert cmd[i + 1] == "cpu"
    assert cmd[:i] + cmd[i + 2:] == [
        a.replace("ompi_tpu.tools", "ompi_tpu_torch.tools") for a in ref]


# ---- failure-path hardening (tests/test_failures.py) -------------------


_VICTIM = """
import os, time
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.op import op as mpi_op
comm = ompi_tpu_torch.init(device="cpu")
if comm.rank == 1:
    print(f"victim pid {os.getpid()}", flush=True)
    time.sleep(120)
buf = np.zeros(1)
comm.Allreduce(buf, buf.copy(), mpi_op.SUM)
print("should not get here", flush=True)
"""


def test_sigkill_mid_collective_fails_job_fast(tmp_path):
    """SIGKILL one rank while its peers sit in Allreduce: the errmgr
    kills the job within seconds, exits non-zero and says why."""
    prog = tmp_path / "victim.py"
    prog.write_text(_VICTIM)
    p = subprocess.Popen(_mpirun("-np", "3", "--timeout", "60", str(prog)),
                         env=_env(), cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        line = ""
        while "victim pid" not in line:
            line = p.stdout.readline()
            assert line and time.monotonic() < deadline, line
        os.kill(int(line.split()[-1]), signal.SIGKILL)
        t0 = time.monotonic()
        out, err = p.communicate(timeout=30)
        elapsed = time.monotonic() - t0
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode != 0
    assert elapsed < 10, f"took {elapsed}s to react"
    assert "exited with status -9" in err
    assert "should not get here" not in out


def test_modex_timeout_tunable(tmp_path):
    """A rank waiting for a never-published modex key fails after the
    registry-tuned timeout instead of the 30 s default."""
    prog = tmp_path / "modex.py"
    prog.write_text(
        "import time\n"
        "import ompi_tpu_torch\n"
        "from ompi_tpu_torch.runtime import state as statemod\n"
        "comm = ompi_tpu_torch.init()\n"
        "t0 = time.monotonic()\n"
        "try:\n"
        "    statemod.current().rte.modex_get(\n"
        "        (comm.rank + 1) % comm.size, 'never-published-key')\n"
        "except Exception:\n"
        "    assert time.monotonic() - t0 < 15\n"
        "    raise SystemExit(3)\n"
        "print('should not get here', flush=True)\n")
    r = mpirun_run(2, str(prog), mca=(("rte_base_modex_timeout", "2"),),
                   timeout=60)
    assert r.returncode == 3, (r.returncode, r.stderr.decode()[-2000:])


def test_rendezvous_stall_raises():
    """A device-collective rendezvous with an absent peer raises a
    stall diagnostic after the tuned timeout (thread-rank world)."""
    from ompi_tpu_torch.coll.device import Rendezvous
    from ompi_tpu_torch.mca.params import registry
    saved = (registry.get("coll_device_rendezvous_poll"),
             registry.get("coll_device_rendezvous_timeout"))
    registry.set("coll_device_rendezvous_poll", 0.05)
    registry.set("coll_device_rendezvous_timeout", 0.5)
    try:
        rv = Rendezvous(2)  # the second member never arrives
        with pytest.raises(RuntimeError, match="stalled"):
            rv.run(0, object(), lambda slots: slots)
    finally:
        registry.set("coll_device_rendezvous_poll", saved[0])
        registry.set("coll_device_rendezvous_timeout", saved[1])


# ---- the node's KV proxy under a long poll --------------------------


def test_proxy_long_poll_leaves_other_ranks_unblocked(monkeypatch):
    """A rank parked on a KV key nobody has published yet (the recovery
    epoch watcher waits for the whole job) holds no lock the node's
    other ranks need: their puts and gets through the same per-node
    proxy answer at once."""
    from ompi_tpu_torch.runtime import kvstore
    monkeypatch.setenv("TPUMPI_JOB_SECRET", "s3cret")
    server = kvstore.KVServer(2)
    proxy = kvstore.KVProxy(server.addr, 2)
    try:
        parked = kvstore.KVClient(proxy.addr)
        got = {}
        th = threading.Thread(target=lambda: got.update(
            v=parked.get("ft:epoch:1", timeout=20.0)), daemon=True)
        th.start()
        time.sleep(0.5)  # the watcher is polling upstream
        c = kvstore.KVClient(proxy.addr)
        t0 = time.monotonic()
        for i in range(20):
            c.put(f"modex:0:k{i}", i)
            assert c.get(f"modex:0:k{i}", timeout=5.0) == i
        dt = time.monotonic() - t0
        c.put("ft:epoch:1", {"epoch": 1})
        th.join(timeout=10)
        assert got.get("v") == {"epoch": 1}
        assert dt < 1.0, f"40 ops took {dt:.2f} s behind the long poll"
    finally:
        proxy.close()
        server.close()
