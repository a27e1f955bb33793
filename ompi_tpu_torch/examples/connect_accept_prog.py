"""Connect/accept between two halves of one job through a named port:
the port's copy of the reference's ``tests/_connect_accept_prog.py``.

    python -m ompi_tpu_torch.tools.mpirun -np 4 \
        ompi_tpu_torch/examples/connect_accept_prog.py

Every rank prints ``ok``."""
import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.comm import dpm
from ompi_tpu_torch.op import op as mpi_op

comm = ompi_tpu_torch.init()
half = comm.size // 2
low = comm.rank < half
local = comm.split(0 if low else 1)
if low:
    inter = dpm.comm_accept(local, "ca-test-port")
else:
    inter = dpm.comm_connect(local, "ca-test-port")
s = np.array([1.0 if low else 2.0])
r = np.empty(1)
inter.Allreduce(s, r, mpi_op.SUM)
expect = 2.0 * (comm.size - half) if low else 1.0 * half
assert r[0] == expect, (comm.rank, r[0], expect)

# second rendezvous on the SAME port: the
# first round's connect record must have been consumed, and the two
# bridge cids must differ — no stale-record pairing, no hash cids)
if low:
    inter2 = dpm.comm_accept(local, "ca-test-port")
else:
    inter2 = dpm.comm_connect(local, "ca-test-port")
assert inter2.cid != inter.cid
r2 = np.empty(1)
inter2.Allreduce(s, r2, mpi_op.SUM)
assert r2[0] == expect, (comm.rank, r2[0], expect)
print("ok", flush=True)
ompi_tpu_torch.finalize()
