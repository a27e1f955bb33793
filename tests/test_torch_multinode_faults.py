"""Failures, state walks and the data plane across simulated nodes,
through the port's launcher on the CPU: a SIGKILLed rank under the
daemon path, the PLM's state trace, the node-level chaos scenarios
(``oob_sever`` — the daemon reconnects and the job completes;
``daemon_kill`` — the job is torn down, never hung), the 256 MiB
chunked pull across two simulated nodes, and the results of
examples ring.py and connectivity.py against the reference's launcher
under ``--simulate-nodes 2x2``.  Analogs of
tests/test_failures.py::test_sigkill_under_simulated_nodes,
tests/test_state.py::test_verbose_state_trace_multinode,
tests/test_chaos.py's two node scenarios and
tests/test_device_p2p.py::test_chunked_256mib_across_simulated_nodes."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np

from ompi_tpu.testing import mpirun_run as ref_mpirun_run
from ompi_tpu_torch.testing import mpirun_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join("ompi_tpu_torch", "examples")

VICTIM = textwrap.dedent("""
    import os, time
    import numpy as np
    import ompi_tpu_torch
    from ompi_tpu_torch.op import op as mpi_op
    comm = ompi_tpu_torch.init()
    if comm.rank == 1:
        print(f"victim pid {os.getpid()}", flush=True)
        time.sleep(120)
    buf = np.zeros(1)
    comm.Allreduce(buf, buf.copy(), mpi_op.SUM)
    print("should not get here", flush=True)
""")


def test_sigkill_under_simulated_nodes(tmp_path):
    """SIGKILL one rank while its peers sit in Allreduce, through the
    multi-node daemon path: the errmgr kills the job, exits non-zero
    and says why."""
    prog = tmp_path / "victim.py"
    prog.write_text(VICTIM)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, "-m", "ompi_tpu_torch.tools.mpirun", "-np", "3",
         "--timeout", "60", "--simulate-nodes", "3x1", "--devices", "none",
         str(prog)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 30
        line = ""
        while time.monotonic() < deadline and "victim pid" not in line:
            line = p.stdout.readline()
        assert "victim pid" in line, line
        os.kill(int(line.split()[-1]), signal.SIGKILL)
        t0 = time.monotonic()
        out, err = p.communicate(timeout=30)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode != 0
    assert time.monotonic() - t0 < 15
    assert "exited with status -9" in err and "terminating job" in err
    assert "should not get here" not in out


def test_verbose_state_trace_multinode():
    """The PLM path walks the daemon states too."""
    r = mpirun_run(2, os.path.join(EX, "hello.py"), devices="none",
                   timeout=120, job_timeout=60,
                   extra=("--verbose", "state", "--simulate-nodes", "2x1"))
    assert r.returncode == 0, r.stderr.decode()
    err = r.stderr.decode()
    for arrow in ("INIT -> ALLOCATE", "ALLOCATE -> MAP",
                  "MAP -> LAUNCH_DAEMONS",
                  "LAUNCH_DAEMONS -> DAEMONS_REPORTED",
                  "DAEMONS_REPORTED -> LAUNCH_APPS",
                  "LAUNCH_APPS -> RUNNING",
                  "RUNNING -> DRAINING", "DRAINING -> TERMINATED"):
        assert arrow in err, err


# the chaos workload: six Allreduces half a second apart, so the job
# is still running when a node scenario fires (ft_inject_after, 1 s
# after the daemon starts); every rank prints the digest of its
# results
CHAOS = textwrap.dedent("""
    import hashlib, time
    import numpy as np
    import ompi_tpu_torch
    from ompi_tpu_torch.op import op as mpi_op
    comm = ompi_tpu_torch.init()
    rank, size = comm.rank, comm.size
    digest = hashlib.sha256()
    for step in range(6):
        time.sleep(0.5)
        x = np.arange(1024, dtype=np.float64) * (rank + 1 + step)
        y = np.empty_like(x)
        comm.Allreduce(x, y, mpi_op.SUM)
        digest.update(y.tobytes())
    print(f"chaos digest {rank} {digest.hexdigest()}", flush=True)
    ompi_tpu_torch.finalize()
""")


def _chaos_want(size: int) -> str:
    digest = __import__("hashlib").sha256()
    for step in range(6):
        y = sum(np.arange(1024, dtype=np.float64) * (r + 1 + step)
                for r in range(size))
        digest.update(y.tobytes())
    return digest.hexdigest()


def _chaos(tmp_path, mca):
    prog = tmp_path / "chaos.py"
    prog.write_text(CHAOS)
    return mpirun_run(4, str(prog), devices="none", timeout=120,
                      job_timeout=60, mca=mca,
                      extra=("--simulate-nodes", "2x2"))


def test_oob_sever_daemon_reconnects(tmp_path):
    """Injected daemon<->HNP channel drop on the victim node: the HNP
    holds EV_DAEMON_LOST for the reconnect grace, the daemon's backoff
    reconnect re-registers, and the job completes with the right
    digests.  The victim daemon's trace holds the reconnect span."""
    dumps = tmp_path / "trace"
    dumps.mkdir()
    r = _chaos(tmp_path, (("ft_inject_plan", "oob_sever"),
                          ("oob_base_reconnect_grace", "5.0"),
                          ("trace_enable", 1),
                          ("trace_dump_path", str(dumps))))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    lines = [ln.split() for ln in r.stdout.decode().splitlines()
             if ln.startswith("chaos digest")]
    assert sorted(int(ln[2]) for ln in lines) == [0, 1, 2, 3]
    assert {ln[3] for ln in lines} == {_chaos_want(4)}
    spans = [e for e in json.loads(
        (dumps / "trace-rtpud-sim1.json").read_text())["events"]
        if e.get("name") == "oob_reconnect"]
    assert [s["args"]["ok"] for s in spans] == [1], spans
    healthy = (dumps / "trace-rtpud-sim0.json").read_text()
    assert "oob_reconnect" not in healthy


def test_daemon_kill_terminates_job(tmp_path):
    """daemon_kill hard-exits the victim node's daemon mid-job: the
    errmgr declares the node lost and tears the job down in bounded
    time — never a hang, never success."""
    t0 = time.monotonic()
    r = _chaos(tmp_path, (("ft_inject_plan", "daemon_kill"),
                          ("oob_base_heartbeat_interval", "0.5"),
                          ("oob_base_heartbeat_budget", "4")))
    assert r.returncode not in (0, 124), r.returncode
    assert time.monotonic() - t0 < 30
    err = r.stderr.decode()
    assert "lost" in err and "node(s) [1]" in err, err[-2000:]
    assert "chaos digest" not in r.stdout.decode()


def test_chunked_256mib_across_simulated_nodes():
    """A 256 MiB tensor (64 chunks of the default 4 MiB) crosses a
    simulated two-node job over btl/tcp: exact bytes, the sender's
    overwrite right after send_arr never reaches the receiver, and the
    sender's staging stays within (depth + 2) chunks."""
    r = mpirun_run(2, os.path.join(EX, "devp2p_big.py"), "--mb", "256",
                   "--device", "cpu", timeout=240, job_timeout=200,
                   extra=("--simulate-nodes", "2"))
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    docs = {d["rank"]: d for d in (json.loads(ln) for ln in
                                   r.stdout.decode().splitlines()
                                   if ln.startswith("{"))}
    s, q = docs[0], docs[1]
    assert s["btl"] == q["btl"] == "tcp"
    assert q["exact"] and s["chunks"] == 64
    assert 0 < s["staged"] <= s["bound"], s


def _outputs(r):
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return sorted(ln for ln in r.stdout.decode().splitlines()
                  if ln.strip())


def test_sim_nodes_examples_match_reference():
    """ring.py and connectivity.py print the same lines under both
    packages' mpirun --simulate-nodes 2x2 (the same programs, each
    package's copy)."""
    for prog in ("ring.py", "connectivity.py"):
        port = _outputs(mpirun_run(4, os.path.join(EX, prog), timeout=120,
                                   job_timeout=60,
                                   extra=("--simulate-nodes", "2x2")))
        ref = _outputs(ref_mpirun_run(4, os.path.join("examples", prog),
                                      timeout=180, job_timeout=120,
                                      extra=("--simulate-nodes", "2x2")))
        assert port == ref, prog
        assert port and ("PASSED" in "".join(port)
                         or "received token 7 from 3" in "".join(port))
