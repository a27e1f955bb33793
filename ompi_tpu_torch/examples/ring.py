"""4-rank token ring (ref: examples/ring_c.c).  Run:

    python -m ompi_tpu_torch.tools.mpirun -np 4 ompi_tpu_torch/examples/ring.py
"""
import numpy as np
import ompi_tpu_torch

comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
token = np.array([0], dtype=np.int32)
if rank == 0:
    token[0] = 10
    print(f"Process 0 sending {token[0]} to 1, tag 201 ({size} processes)")
    comm.Send(token, dest=1, tag=201)
    comm.Recv(token, source=size - 1, tag=201)
    print(f"Process 0 received token {token[0]} from {size - 1}")
else:
    comm.Recv(token, source=rank - 1, tag=201)
    token -= 1
    comm.Send(token, dest=(rank + 1) % size, tag=201)
print(f"Process {rank} done", flush=True)
ompi_tpu_torch.finalize()
