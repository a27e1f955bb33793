"""MPI_Comm_join driver: the port's copy of the reference's
``tests/_join_prog.py``.  Rank 0 listens on a localhost socket, rank 1
dials it; both join over the connected fd, sendrecv across the
resulting 1-1 intercomm, and verify.  The reference spells the join
``mpi.MPI_Comm_join(fd)``; the port has no flat MPI surface yet, so
this copy calls ``dpm.comm_join(comm_self, fd)``, which that spelling
wraps.

    python -m ompi_tpu_torch.tools.mpirun -np 2 \\
        ompi_tpu_torch/examples/join_prog.py
"""
import socket

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.comm import dpm
from ompi_tpu_torch.datatype import engine as dt

comm = ompi_tpu_torch.init()
state = comm.state
if comm.rank == 0:
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    state.rte.modex_put("join_port", lst.getsockname()[1])
    conn, _ = lst.accept()
else:
    port = state.rte.modex_get(0, "join_port")
    conn = socket.create_connection(("127.0.0.1", int(port)))

inter = dpm.comm_join(state.comm_self, conn.fileno())
assert inter.size == 1 and inter.remote_size == 1
pml = state.pml
x = np.array([comm.rank], dtype=np.int64)
y = np.empty(1, dtype=np.int64)
s = pml.isend(x, 1, dt.INT64_T, 0, -62, inter)
pml.recv(y, 1, dt.INT64_T, 0, -62, inter)
s.wait()
assert int(y[0]) == 1 - comm.rank, y
conn.close()
if comm.rank == 0:
    print("join ok", flush=True)
ompi_tpu_torch.finalize()
