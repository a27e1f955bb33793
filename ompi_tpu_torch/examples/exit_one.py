"""Failure-propagation probe: rank 1 exits abnormally WITHOUT calling
abort; every other rank blocks in a collective.  The launcher's
errmgr policy must kill the job (ref: orte/test/mpi/bad_exit.c)."""
import sys

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.op import op as mpi_op

comm = ompi_tpu_torch.init()
if comm.rank == 1:
    sys.exit(7)
buf = np.zeros(1, dtype=np.int64)
comm.Allreduce(buf, buf.copy(), op=mpi_op.SUM)  # hangs: rank 1 never joins
print("should not reach here", flush=True)
