"""Hybrid launch through the port's mpirun (the analog of
tests/test_hybrid_launcher.py): --ranks-per-proc spawns app shells
(ompi_tpu_torch.tools.hostrun) whose rank-threads share a device, so
the device tier is reachable from a real launch.  The CPU stands in
for the card only where a test asks for it (``--devices cpu``)."""

import os
import textwrap

import pytest
import torch

from ompi_tpu_torch.testing import mpirun_run

EX = os.path.join("ompi_tpu_torch", "examples")


def test_device_collectives_on_the_shared_device_under_mpirun():
    """The north-star gate's analog: one shell owning all 8 ranks on
    one device runs its *_arr collectives on coll/hbm (K1's plain
    version on the CPU)."""
    r = mpirun_run(8, os.path.join(EX, "device_allreduce.py"),
                   rpp="all", devices="cpu", timeout=150)
    assert r.returncode == 0, (r.stdout.decode(), r.stderr.decode())
    out = r.stdout.decode()
    assert "coll_allreduce_arr_provider=hbm" in out, out
    for k in range(8):
        assert f"rank {k} ok" in out


def test_hybrid_two_shells_ring():
    """Two app shells: cross-process p2p over shm, in-process over the
    inproc btl."""
    r = mpirun_run(4, os.path.join(EX, "ring.py"), rpp=2, devices="none")
    assert r.returncode == 0, r.stderr.decode()
    assert "received token 7 from 3" in r.stdout.decode()


def test_hybrid_two_shells_connectivity():
    r = mpirun_run(4, os.path.join(EX, "connectivity.py"), rpp=2,
                   devices="none", mca=(("btl", "self,inproc,tcp"),))
    assert r.returncode == 0, r.stderr.decode()
    assert "PASSED" in r.stdout.decode()


def test_hybrid_rank_failure_kills_job(tmp_path):
    """A rank-thread failing is the thread analog of a rank process
    dying: the shell reports it to the launcher, whose errmgr policy
    terminates the job (nonzero) instead of hanging peers."""
    prog = tmp_path / "fail_one.py"
    prog.write_text(textwrap.dedent("""
        import numpy as np
        import ompi_tpu_torch
        from ompi_tpu_torch.op import op as mpi_op
        comm = ompi_tpu_torch.init()
        if comm.rank == 1:
            raise RuntimeError("boom on rank 1")
        x = np.zeros(1, np.int32)
        r = np.zeros(1, np.int32)
        comm.Allreduce(x, r, mpi_op.SUM)
        ompi_tpu_torch.finalize()
    """))
    r = mpirun_run(4, str(prog), rpp="all", devices="none",
                   job_timeout=60, timeout=120)
    assert r.returncode != 0
    assert r.returncode != 124, "job hung until --timeout"
    assert "boom on rank 1" in r.stderr.decode()


def test_devices_auto_without_a_card_starts_no_rank(tmp_path):
    """Pinned divergence: ``--devices auto`` (the default) means the
    cards; on a machine with none the shell fails naming the missing
    card and no rank runs — on the CPU or anywhere."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: auto takes it")
    prog = tmp_path / "mark.py"
    prog.write_text("open(__file__ + '.ran', 'w').close()\n")
    r = mpirun_run(4, str(prog), rpp=2, timeout=60)
    err = r.stderr.decode()
    assert r.returncode != 0
    assert "no CUDA card" in err and "no rank was started" in err, err
    assert not os.path.exists(str(prog) + ".ran")
