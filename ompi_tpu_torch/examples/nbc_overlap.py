"""Nonblocking-collective smoke test: overlap Iallreduce/Ibcast/
Ibarrier with p2p traffic, verify results.  The port's copy of the
reference's ``examples/nbc_overlap.py``.

    python -m ompi_tpu_torch.tools.mpirun -np 4 \
        ompi_tpu_torch/examples/nbc_overlap.py
"""

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.op import op as mpi_op
from ompi_tpu_torch.pml.request import wait_all


def main() -> None:
    comm = ompi_tpu_torch.init()
    rank, size = comm.rank, comm.size

    x = np.arange(1000, dtype=np.float64) + rank
    r = np.empty_like(x)
    req1 = comm.Iallreduce(x, r, mpi_op.SUM)

    b = np.full(8, 4242, dtype=np.int64) if rank == 0 \
        else np.zeros(8, dtype=np.int64)
    req2 = comm.Ibcast(b, root=0)

    # p2p ring token while the collectives are in flight
    peer = (rank + 1) % size
    src = (rank - 1 + size) % size
    sb = np.array([rank * 11], dtype=np.int64)
    rb = np.empty(1, dtype=np.int64)
    comm.Sendrecv(sb, peer, 7, rb, src, 7)

    req3 = comm.Ibarrier()
    wait_all([req1, req2, req3])

    exp = sum(np.arange(1000, dtype=np.float64) + k for k in range(size))
    assert np.allclose(r, exp), "Iallreduce mismatch"
    assert (b == 4242).all(), "Ibcast mismatch"
    assert rb[0] == src * 11, "Sendrecv mismatch"

    g = np.empty(size, dtype=np.int64) if rank == 0 else None
    comm.Igather(np.array([rank], dtype=np.int64), g, root=0).wait()
    if rank == 0:
        assert list(g) == list(range(size)), "Igather mismatch"
        print(f"nbc_overlap OK on {size} ranks")
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
