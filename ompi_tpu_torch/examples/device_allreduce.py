"""Device-collective program for the hybrid launch model.

Run (one app-shell process owning every rank as a thread):

    python -m ompi_tpu_torch.tools.mpirun -np 8 --ranks-per-proc all \
        ompi_tpu_torch/examples/device_allreduce.py

Each rank allreduces / reduce-scatters a tensor on its device, then a
sub-communicator (even/odd split) allreduces with MAX.  The reference's
copy checks ``coll_tpu_offloaded_collectives``, the mesh tier's
counter: one card puts every rank on ``cuda:0``, which is coll/hbm —
one stacked kernel (K1) over every member's tensor — so this copy
reads the hbm path's engagement in its place: the provider of
``allreduce_arr`` and the K1 launches the shell made (a CPU tensor,
``--devices cpu``, takes K1's plain version, which launches nothing).

``--bytes B --iters K`` runs the headline instead: one allreduce_arr
SUM of B bytes of float32 a rank held against a float64 sum of every
rank's input (within N * 2**-24 * sum|x| element by element, the
float SUM band), then K chained allreduce_arr calls timed on the host
clock from a barrier to ``torch.cuda.synchronize()``.  The lowest rank
of each shell prints one JSON line: the shell's ranks, its K1 launches
over the chained calls and over the whole run, the slowest rank's
microseconds an op, and the check's largest error.
"""
import json
import sys
import time

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch.kernels import stacked
from ompi_tpu_torch.op import op as mpi_op

comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
dev = comm.device


def sync():
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pattern(r: int, n: int, dtype):
    """Rank r's input: a non-constant pattern in [0, 1), on the device."""
    i = torch.arange(n, device=dev, dtype=torch.int64)
    return ((i * 7 + r * 13) % 1001).to(dtype) / 1001.0


def headline(nbytes: int, iters: int) -> None:
    n = nbytes // 4
    x = pattern(rank, n, torch.float32)
    y = comm.allreduce_arr(x, mpi_op.SUM)
    ref = sum(pattern(r, n, torch.float64) for r in range(size))
    err = float((y.double() - ref).abs().max())
    band = float(size * 2.0 ** -24 * ref.abs().max())
    assert torch.isfinite(y).all() and err <= band, (rank, err, band)
    y = x * 1e-6
    sync()
    comm.Barrier()
    k0 = stacked.stacked_reduce.launches.value
    comm.Barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        y = comm.allreduce_arr(y, mpi_op.SUM)
    sync()
    dt = np.array([time.perf_counter() - t0])
    comm.Barrier()
    k1 = stacked.stacked_reduce.launches.value - k0
    slowest = np.empty_like(dt)
    comm.Allreduce(dt, slowest, mpi_op.MAX)
    errs = np.array([err])
    worst = np.empty_like(errs)
    comm.Allreduce(errs, worst, mpi_op.MAX)
    assert torch.isfinite(y).all()
    world = getattr(comm.state.rte, "world", None)
    base = getattr(world, "rank_base", rank)
    if rank == base:
        sys.stdout.write(json.dumps({
            "shell": base, "ranks": getattr(world, "nlocal", 1),
            "provider": comm.coll.providers["allreduce_arr"],
            "ops": iters, "k1": k1,
            "k1_total": stacked.stacked_reduce.launches.value,
            "us_per_op": float(slowest[0]) / iters * 1e6,
            "max_err": float(worst[0]), "device": str(dev)}) + "\n")
        sys.stdout.flush()


if "--bytes" in sys.argv:
    headline(int(sys.argv[sys.argv.index("--bytes") + 1]),
             int(sys.argv[sys.argv.index("--iters") + 1]))
    ompi_tpu_torch.finalize()
    sys.exit(0)

k0 = stacked.stacked_reduce.launches.value
x = torch.full((size * 4,), float(rank + 1), dtype=torch.float32, device=dev)
r = comm.allreduce_arr(x, mpi_op.SUM)
rs = comm.reduce_scatter_arr(x, mpi_op.SUM)
expect = sum(range(1, size + 1))
assert float(r[0]) == expect, (rank, float(r[0]))
assert float(rs[0]) == expect

# sub-communicator: even/odd split meets on the card too
sub = comm.split(rank % 2)
sr = sub.allreduce_arr(x, mpi_op.MAX)
assert float(sr[0]) == float(size - 2 + (rank % 2) + 1)
sync()
comm.Barrier()

# one atomic write per line: every rank is a thread of ONE app-shell
# process, and print()'s separate text/newline writes interleave
# across ranks on the shared stdout
provider = comm.coll.providers["allreduce_arr"]
if rank == 0:
    k1 = stacked.stacked_reduce.launches.value - k0
    sys.stdout.write(f"coll_allreduce_arr_provider={provider}\n"
                     f"coll_hbm_k1_launches={k1}\n")
    sys.stdout.flush()
    if dev is not None and dev.type == "cuda":
        assert provider == "hbm" and k1 > 0, \
            "device collectives did not run on the card's kernel!"
sys.stdout.write(f"rank {rank} ok\n")
sys.stdout.flush()
ompi_tpu_torch.finalize()
