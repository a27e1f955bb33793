"""Every-pair p2p check (ref: examples/connectivity_c.c)."""
import numpy as np
import ompi_tpu_torch

comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
for peer in range(size):
    if peer == rank:
        continue
    me = np.array([rank], dtype=np.int32)
    other = np.zeros(1, dtype=np.int32)
    comm.Sendrecv(me, peer, 7, other, peer, 7)
    assert other[0] == peer, (rank, peer, other)
comm.Barrier()
if rank == 0:
    print(f"Connectivity test on {size} processes PASSED", flush=True)
ompi_tpu_torch.finalize()
