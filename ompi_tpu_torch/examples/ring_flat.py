"""The reference's examples/ring_c.c, written against the flat MPI_*
surface (ompi_tpu_torch.mpi) — token passed around a ring 10 times:

    python -m ompi_tpu_torch.tools.mpirun -np 4 \
        ompi_tpu_torch/examples/ring_flat.py
"""

import numpy as np

from ompi_tpu_torch import mpi as MPI


def main() -> None:
    MPI.MPI_Init()
    comm = MPI.MPI_COMM_WORLD()
    rank = MPI.MPI_Comm_rank(comm)
    size = MPI.MPI_Comm_size(comm)
    next_r, prev_r = (rank + 1) % size, (rank - 1) % size

    message = np.array([10], dtype=np.int32)
    if rank == 0:
        print(f"Process 0 sending {int(message[0])} to {next_r}, "
              f"tag 201 ({size} processes in ring)", flush=True)
        MPI.MPI_Send(message, 1, MPI.MPI_INT, next_r, 201, comm)

    while True:
        MPI.MPI_Recv(message, 1, MPI.MPI_INT, prev_r, 201, comm)
        if rank == 0:
            message[0] -= 1
            print(f"Process 0 decremented value: {int(message[0])}",
                  flush=True)
        if message[0] == 0 and rank != 0:
            MPI.MPI_Send(message, 1, MPI.MPI_INT, next_r, 201, comm)
            break
        MPI.MPI_Send(message, 1, MPI.MPI_INT, next_r, 201, comm)
        if message[0] == 0:
            break

    if rank == 0:
        MPI.MPI_Recv(message, 1, MPI.MPI_INT, prev_r, 201, comm)
    print(f"Process {rank} exiting", flush=True)
    MPI.MPI_Finalize()


if __name__ == "__main__":
    main()
