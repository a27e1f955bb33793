"""OpenSHMEM atomics demo: every PE fetch-increments a counter on
PE 0 (ticket lock pattern) and adds into a symmetric accumulator.

The port of the reference's examples/shmem_atomics.py.  Run:

    python -m ompi_tpu_torch.tools.mpirun -np 4 \\
        ompi_tpu_torch/examples/shmem_atomics.py
"""
import numpy as np

from ompi_tpu_torch import shmem

shmem.init()
me, n = shmem.my_pe(), shmem.n_pes()
counter = shmem.malloc(1, np.int64)
acc = shmem.malloc(1, np.int64)
# self-puts, not .local stores: a device heap has no writable host
# alias, so local initialization goes through the data plane too
shmem.p(counter, 0, 0, me)
shmem.p(acc, 0, 0, me)
shmem.barrier_all()

ticket = shmem.atomic_fetch_inc(counter, 0, 0)  # unique 0..n-1
shmem.atomic_add(acc, 0, me + 1, 0)
shmem.barrier_all()

if me == 0:
    assert counter.local[0] == n, counter.local
    assert acc.local[0] == sum(range(1, n + 1)), acc.local
    print(f"shmem atomics ok: {n} tickets, acc={int(acc.local[0])}",
          flush=True)
# every PE got a distinct ticket
all_t = shmem.malloc(n, np.int64)
mine = shmem.malloc(1, np.int64)
shmem.p(mine, 0, ticket, me)
shmem.barrier_all()  # complete the self-put before the collective
shmem.collect(all_t, mine)
assert sorted(all_t.local.tolist()) == list(range(n))
shmem.finalize()
