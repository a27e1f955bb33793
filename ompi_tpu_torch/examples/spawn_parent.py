"""MPI_Comm_spawn demo: parents spawn 2 workers, allreduce across
the bridge (intercomm semantics: each side receives the OTHER side's
reduction), then everyone merges into one intracomm
(ref: orte/test/mpi/loop_spawn.c family).  The port's copy of the
reference's ``examples/spawn_parent.py``.

    python -m ompi_tpu_torch.tools.mpirun -np 2 \\
        ompi_tpu_torch/examples/spawn_parent.py [--device auto|cpu] [--mib N]

``--device`` puts every rank, parents and workers, on a device
(``init(device=...)``: ``auto`` the card ``rank % count``, ``cpu`` the
CPU) and adds one ``allreduce_arr`` SUM of ``--mib`` MiB of float32
(1 by default) on the merged communicator, which spans processes and
so stages through pinned host memory.  Each rank then prints ``CARD
rank={merged rank} device={type} {sha256}`` of the result; the
workers are spawned with the same options.  Without ``--device`` the
program is the reference's, host buffers only.
"""
import os
import sys

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.examples.spawn_worker import card_allreduce, options
from ompi_tpu_torch.op import op as mpi_op

choice, mib = options(sys.argv[1:])
comm = ompi_tpu_torch.init(device=choice)
worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "spawn_worker.py")
inter = comm.spawn(worker, args=sys.argv[1:], maxprocs=2)
assert inter.remote_size == 2

mine = np.array([float(comm.rank + 1)], dtype=np.float64)
got = np.empty(1, dtype=np.float64)
inter.Allreduce(mine, got, mpi_op.SUM)
# workers contribute 100 + their world rank each
assert got[0] == sum(100.0 + r for r in range(2)), got

merged = inter.merge(high=False)
total = np.empty(1, dtype=np.float64)
merged.Allreduce(mine, total, mpi_op.SUM)
print(f"parent {comm.rank}: merged size {merged.size} "
      f"total {total[0]}", flush=True)
if choice is not None:
    card_allreduce(merged, mib)
ompi_tpu_torch.finalize()
