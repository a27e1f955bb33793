"""OpenSHMEM-style ring: each PE puts a token into its right
neighbor's symmetric flag and waits on its own (the oshmem
ring_oshmem.c analog).

The port of the reference's examples/shmem_ring.py.  Run:

    python -m ompi_tpu_torch.tools.mpirun -np 4 \\
        ompi_tpu_torch/examples/shmem_ring.py
"""
import numpy as np

from ompi_tpu_torch import shmem

shmem.init()
me, n = shmem.my_pe(), shmem.n_pes()
flag = shmem.malloc(1, np.int64)
# self-put, not a .local store: a device heap has no writable host
# alias, so local initialization goes through the data plane too
shmem.p(flag, 0, -1, me)
shmem.barrier_all()

if me == 0:
    shmem.p(flag, 0, 42, (me + 1) % n)  # inject the token
shmem.wait_until(flag, 0, "ge", 0)
token = int(flag.local[0])
if me != 0:
    shmem.p(flag, 0, token + 1, (me + 1) % n)
shmem.barrier_all()
if me == 0:
    assert token == 42 + n - 1, token  # full circle incremented n-1 times
    print(f"shmem ring complete: PE 0 ended with {token}", flush=True)
shmem.finalize()
