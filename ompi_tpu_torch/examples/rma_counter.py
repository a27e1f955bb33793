"""One-sided RMA smoke test under mpirun: fence put ring, exclusive-
lock atomic counter, fetch_and_op (ref: MPI-3 RMA examples).  The
port's copy of the reference's ``examples/rma_counter.py``: host
windows over numpy memory.

    python -m ompi_tpu_torch.tools.mpirun -np 4 \
        ompi_tpu_torch/examples/rma_counter.py
"""

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch import osc
from ompi_tpu_torch.op import op as mpi_op


def main() -> None:
    comm = ompi_tpu_torch.init()
    rank, size = comm.rank, comm.size

    # fence epoch: put rank id to right neighbor
    mem = np.full(2, -1, dtype=np.int64)
    win = osc.create(comm, mem)
    win.fence()
    win.put(np.full(2, rank, dtype=np.int64), (rank + 1) % size)
    win.fence()
    assert (mem == (rank - 1 + size) % size).all(), "put ring mismatch"

    # passive target: atomic counter on rank 0
    ctr = np.zeros(1, dtype=np.int64)
    cwin = osc.create(comm, ctr)
    for _ in range(5):
        old = np.empty(1, dtype=np.int64)
        cwin.fetch_and_op(1, old, 0, op=mpi_op.SUM)
    comm.Barrier()
    if rank == 0:
        assert ctr[0] == 5 * size, f"counter {ctr[0]} != {5 * size}"
        print(f"rma_counter OK on {size} ranks")
    cwin.free()
    win.free()
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
