"""OpenSHMEM over mpirun PROCESS ranks through the port: the ported
examples ``ompi_tpu_torch/examples/shmem_ring.py`` and
``shmem_atomics.py`` (the reference's ``examples/shmem_ring.py`` and
``shmem_atomics.py``) and ``shmem_lock.py`` (the reference's
``tests/_shmem_lock_prog.py``), run through the port's mpirun.

The analogs of tests/test_shmem.py's three process-rank tests
(``test_shmem_ring_example_procs``, ``test_shmem_atomics_example_procs``
and ``test_lock_mutual_exclusion_procs``), held to the reference's
output lines.  Each program calls ``shmem.init()`` with no
communicator, so ``init()``'s world is the PE set; process ranks own no
device here, so the heap is the host window's numpy heap.
"""

import os

from ompi_tpu_torch.testing import mpirun_run

EX = os.path.join("ompi_tpu_torch", "examples")


def _job(np_, prog):
    r = mpirun_run(np_, os.path.join(EX, prog), timeout=150,
                   job_timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r.stdout.decode()


def test_shmem_ring_example_procs():
    assert "PE 0 ended with 45" in _job(4, "shmem_ring.py")


def test_shmem_atomics_example_procs():
    assert "4 tickets, acc=10" in _job(4, "shmem_atomics.py")


def test_lock_mutual_exclusion_procs():
    """Contended lock over the osc/pml stack of process ranks: every
    PE's non-atomic read-modify-write inside the lock survives (3 PEs,
    8 sections each)."""
    assert "shmem lock ok: 24" in _job(3, "shmem_lock.py")
