"""Distributed-lock mutual exclusion under mpirun PROCESS ranks with
contention: the port of the reference's ``tests/_shmem_lock_prog.py``.
Every PE increments a shared counter on PE 0 inside the lock via a
non-atomic read-modify-write; lost updates are exactly what a broken
lock produces (ref: oshmem/shmem/c/shmem_lock.c).

    python -m ompi_tpu_torch.tools.mpirun -np 3 \\
        ompi_tpu_torch/examples/shmem_lock.py

PE 0 prints ``shmem lock ok: <total>``.
"""
import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch import shmem

comm = ompi_tpu_torch.init()
ctx = shmem.init(comm)
ITERS = 8
lock = ctx.malloc(1, np.int64)
counter = ctx.malloc(1, np.int64)
ctx.barrier_all()
if comm.size > 1:
    # process ranks: peer heaps are NOT addressable -> shmem_ptr NULL
    assert ctx.ptr(counter, (comm.rank + 1) % comm.size) is None
for _ in range(ITERS):
    ctx.set_lock(lock)
    v = int(ctx.g(counter, 0, 0))        # read
    ctx.p(counter, 0, v + 1, 0)          # modify-write (NOT atomic)
    ctx.win.flush(0)
    ctx.clear_lock(lock)
ctx.barrier_all()
if comm.rank == 0:
    total = int(counter.local[0])
    expect = comm.size * ITERS
    assert total == expect, f"lost updates: {total} != {expect}"
    print(f"shmem lock ok: {total}", flush=True)
shmem.finalize()
ompi_tpu_torch.finalize()
