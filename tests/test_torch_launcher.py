"""The port's launcher and process ranks (the analog of
tests/test_launcher.py's single-host cases): hello, ring,
connectivity over shm and over tcp alone, abort and exit-code
propagation, the OSU allreduce, --mca reaching the children,
singleton init, the job timeout and the KV store's job secret, all
through ``python -m ompi_tpu_torch.tools.mpirun``."""

import os
import socket
import subprocess
import sys

import pytest

from ompi_tpu_torch.runtime import kvstore
from ompi_tpu_torch.testing import mpirun_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join("ompi_tpu_torch", "examples")


def run(np_, prog, *args, **kw):
    return mpirun_run(np_, os.path.join(EX, prog), *args, **kw)


def test_hello():
    r = run(3, "hello.py")
    assert r.returncode == 0, r.stderr.decode()
    out = r.stdout.decode()
    for k in range(3):
        assert f"I am {k} of 3" in out


def test_ring():
    r = run(4, "ring.py")
    assert r.returncode == 0, r.stderr.decode()
    assert "received token 7 from 3" in r.stdout.decode()


def test_ring_flat():
    r = run(3, "ring_flat.py")
    assert r.returncode == 0, r.stderr.decode()
    out = r.stdout.decode()
    assert "Process 0 decremented value: 0" in out
    for k in range(3):
        assert f"Process {k} exiting" in out


@pytest.mark.parametrize("btl", [None, "self,tcp"])
def test_connectivity(btl):
    r = run(3, "connectivity.py",
            mca=(("btl", btl),) if btl else ())
    assert r.returncode == 0, r.stderr.decode()
    assert "PASSED" in r.stdout.decode()


def test_abort_propagates_exit_code():
    r = run(3, "abort_test.py")
    assert r.returncode == 42
    assert "MPI_Abort" in r.stderr.decode()
    assert "should not reach here" not in r.stdout.decode()


def test_abnormal_exit_kills_job():
    """A rank exiting 7 without abort while the others wait in a
    collective: the errmgr policy ends the job with that code."""
    r = run(3, "exit_one.py", job_timeout=60)
    assert r.returncode == 7, r.stderr.decode()
    assert "should not reach here" not in r.stdout.decode()


def test_osu_allreduce_runs():
    r = run(2, "osu_allreduce.py", "4,65536")
    assert r.returncode == 0, r.stderr.decode()
    assert "bytes" in r.stdout.decode()


def test_mca_param_flows_to_children():
    # the allreduce still works when forced into tiny rendezvous
    # segments (the rank-side shm knobs reach every child)
    r = run(2, "osu_allreduce.py", "65536",
            mca=(("btl_shm_eager_limit", "1024"),
                 ("btl_shm_max_send_size", "4096")))
    assert r.returncode == 0, r.stderr.decode()


def test_singleton_init():
    """ompi_tpu_torch.init() without a launcher = 1-rank world with no
    device."""
    code = ("import ompi_tpu_torch, numpy as np\n"
            "from ompi_tpu_torch.op import op\n"
            "c = ompi_tpu_torch.init()\n"
            "assert c.size == 1 and c.rank == 0 and c.device is None\n"
            "assert ompi_tpu_torch.initialized()\n"
            "x = np.ones(4, np.float32); r = np.empty_like(x)\n"
            "c.Allreduce(x, r, op.SUM)\n"
            "assert r[0] == 1.0\n"
            "c.Barrier()\n"
            "ompi_tpu_torch.finalize()\n"
            "assert ompi_tpu_torch.finalized()\n"
            "print('singleton ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("TPUMPI_KV_ADDR", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       timeout=60, env=env)
    assert r.returncode == 0, r.stderr.decode()
    assert b"singleton ok" in r.stdout


def test_job_timeout(tmp_path):
    """--timeout kills a hung job with exit 124."""
    prog = tmp_path / "sleep.py"
    prog.write_text("import time; time.sleep(60)\n")
    r = mpirun_run(2, str(prog), job_timeout=3, timeout=60)
    assert r.returncode == 124, r.stderr.decode()


def test_kv_server_refuses_unauthenticated_connection(monkeypatch):
    """The per-job secret gates the KV control plane: a connection
    without (or with a wrong) secret is refused, one with the right
    secret proceeds."""
    monkeypatch.setenv("TPUMPI_JOB_SECRET", "s3cr3t-for-test")
    server = kvstore.KVServer(1)
    try:
        host, port = server.addr.rsplit(":", 1)
        # no hello at all: first op is rejected
        s = socket.create_connection((host, int(port)), timeout=10)
        kvstore._send_msg(s, {"op": "put", "key": "k", "value": 1})
        assert kvstore._recv_msg(s) == {"error": "unauthenticated"}
        s.close()
        # wrong secret
        s = socket.create_connection((host, int(port)), timeout=10)
        kvstore._send_msg(s, {"op": "hello", "secret": "wrong"})
        assert kvstore._recv_msg(s) == {"error": "unauthenticated"}
        s.close()
        # the real client authenticates from the env and works
        c = kvstore.KVClient(server.addr)
        c.put("k", 42)
        assert c.get("k") == 42
        # server data was never touched by the rejected writes
        assert server.data.get("k") == 42
        c.close()
    finally:
        server.close()


@pytest.mark.parametrize("flag", [("--restart", "ckpt"),
                                  ("--ckpt-dir", "ckpt")])
def test_unported_launch_options_raise(flag, tmp_path):
    """The checkpoint store (A9) raises NotImplementedError naming its
    ROADMAP item, for a restart as for a checkpoint directory; no rank
    is started.  (``--dvm``, once in this list, now submits to a
    running pool: test_dvm_submits_to_a_running_cpu_pool.)"""
    prog = tmp_path / "never.py"
    prog.write_text("open(__file__ + '.ran', 'w').close()\n")
    r = mpirun_run(2, str(prog), extra=flag, timeout=60, cwd=str(tmp_path))
    err = r.stderr.decode()
    assert r.returncode != 0
    assert "NotImplementedError" in err and "ROADMAP.md A" in err, err
    assert not os.path.exists(str(prog) + ".ran")


def test_dvm_submits_to_a_running_cpu_pool(tmp_path):
    """``mpirun --dvm URI`` launches nothing: it submits the program to
    a running resident pool (here an embedded ``--devices cpu`` pool)
    and returns the job's exit code and output; options the pool cannot
    honor are refused."""
    import torch

    from ompi_tpu_torch.tools.dvm import DVMServer

    uri = str(tmp_path / "dvm.uri")
    srv = DVMServer(4, devices=[torch.device("cpu")], uri_file=uri).start()
    try:
        r = mpirun_run(4, "ompi_tpu_torch/examples/device_allreduce.py",
                       extra=("--dvm", uri), timeout=120)
        out = r.stdout.decode()
        assert r.returncode == 0, r.stderr.decode()[-3000:]
        assert "coll_allreduce_arr_provider=hbm" in out, out
        assert sorted(l for l in out.splitlines()
                      if l.endswith(" ok")) == [f"rank {i} ok"
                                                for i in range(4)]
        assert srv._jobs == 1
        bad = mpirun_run(2, "ompi_tpu_torch/examples/hello.py",
                         extra=("--dvm", uri, "--ranks-per-proc", "2"),
                         timeout=120)
        assert bad.returncode == 2
        assert "cannot honor --ranks-per-proc" in bad.stderr.decode()
    finally:
        srv.stop()
