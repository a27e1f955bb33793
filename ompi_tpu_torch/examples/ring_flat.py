"""The reference's examples/ring_c.c — token passed around a ring 10
times — written as (buffer, count, datatype) triples, the flat MPI_*
surface's argument shape:

    python -m ompi_tpu_torch.tools.mpirun -np 4 \
        ompi_tpu_torch/examples/ring_flat.py

The reference's copy calls the flat ``MPI_*`` functions of its
``mpi.py``; the port has no ``mpi.py`` yet (ROADMAP.md A9), so this
copy calls the communicator methods those functions wrap.
"""

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.datatype.engine import INT


def main() -> None:
    comm = ompi_tpu_torch.init()
    rank = comm.rank
    size = comm.size
    next_r, prev_r = (rank + 1) % size, (rank - 1) % size

    message = np.array([10], dtype=np.int32)
    if rank == 0:
        print(f"Process 0 sending {int(message[0])} to {next_r}, "
              f"tag 201 ({size} processes in ring)", flush=True)
        comm.Send((message, 1, INT), next_r, 201)

    while True:
        comm.Recv((message, 1, INT), prev_r, 201)
        if rank == 0:
            message[0] -= 1
            print(f"Process 0 decremented value: {int(message[0])}",
                  flush=True)
        if message[0] == 0 and rank != 0:
            comm.Send((message, 1, INT), next_r, 201)
            break
        comm.Send((message, 1, INT), next_r, 201)
        if message[0] == 0:
            break

    if rank == 0:
        comm.Recv((message, 1, INT), prev_r, 201)
    print(f"Process {rank} exiting", flush=True)
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
