"""Repeated Comm_spawn rounds (loop_spawn.c analog): the port's copy
of the reference's ``tests/_loop_spawn_prog.py``.  Each round spawns
one worker, allreduces over the merged comm, and frees it; the
universe grows monotonically.

    python -m ompi_tpu_torch.tools.mpirun -np 2 \
        ompi_tpu_torch/examples/loop_spawn_prog.py
"""
import os
import sys

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.op import op as mpi_op

comm = ompi_tpu_torch.init()
parent = ompi_tpu_torch.get_parent()

if parent is not None:  # worker role
    merged = parent.merge(high=True)
    r = np.empty(1)
    merged.Allreduce(np.array([1.0]), r, mpi_op.SUM)
    assert r[0] == merged.size
    ompi_tpu_torch.finalize()
    sys.exit(0)

me = os.path.abspath(__file__)
for round_ in range(3):
    inter = comm.spawn(me, maxprocs=1)
    merged = inter.merge(high=False)
    r = np.empty(1)
    merged.Allreduce(np.array([1.0]), r, mpi_op.SUM)
    assert r[0] == comm.size + 1, (round_, r[0])
    merged.free()
    inter.free()
if comm.rank == 0:
    print("loop-spawn done 3 rounds", flush=True)
ompi_tpu_torch.finalize()
