"""Slow session workload of the resident pool (tools/dvm.py): parks
long enough (1.5 s) for a halt to race it — the pool's drain must let
this run finish.  Torch-only counterpart of the reference's
tests/_dvm_slow_prog.py."""
import time

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.op import op as mpi_op

comm = ompi_tpu_torch.init()
time.sleep(1.5)
x = np.full(8, comm.rank + 1.0, np.float32)
r = np.empty_like(x)
comm.Allreduce(x, r, mpi_op.SUM)
assert abs(float(r[0]) - sum(range(1, comm.size + 1))) < 1e-3
if comm.rank == 0:
    print("DONE", flush=True)
ompi_tpu_torch.finalize()
