"""Severed-socket recovery: the port of the reference's
``tests/_sever_prog.py``.  Rank 0 starts a large rendezvous send to
rank 1, then hard-closes its outbound tcp sockets; the transfer must
still complete (tcp reconnect + undrained-frame resend), byte-exact.

    python -m ompi_tpu_torch.tools.mpirun -np 2 --mca btl self,tcp \\
        ompi_tpu_torch/examples/sever_prog.py

Rank 0 prints ``sever ok``.
"""
import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.datatype import engine as dt

comm = ompi_tpu_torch.init()
state = comm.state
n = 2 * 1024 * 1024  # well past the tcp eager limit: rendezvous
if comm.rank == 0:
    x = np.arange(n, dtype=np.float32)
    req = state.pml.isend(x, n, dt.FLOAT, 1, 7, comm)
    # sever every outbound tcp socket NOW — between the RNDV head and
    # the ACK-triggered FRAG stream
    for m in state.btls:
        if m.name == "tcp":
            for conn in m._out.values():
                conn.sock.close()
    req.wait()
else:
    y = np.empty(n, dtype=np.float32)
    comm.Recv(y, 0, tag=7)
    assert np.array_equal(y, np.arange(n, dtype=np.float32)), \
        "payload corrupted across the reconnect"
comm.Barrier()
if comm.rank == 0:
    print("sever ok", flush=True)
ompi_tpu_torch.finalize()
