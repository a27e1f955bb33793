"""Hierarchical allreduce across simulated (or real) multi-device nodes.

The multi-node device-collective pattern: split COMM_WORLD by node
(COMM_TYPE_SHARED), device-allreduce *within* each node (the mesh tier,
coll/tpu: one K6 fold and one K2 peer copy a card an op), then combine
the per-node partials *across* nodes on the node leaders over the host
network (btl/tcp between nodes), and broadcast back.

Run:  python -m ompi_tpu_torch.tools.mpirun -np 4 --simulate-nodes 2x2 \\
          --ranks-per-proc all ompi_tpu_torch/examples/hier_allreduce.py

(``--devices cpu`` runs it on the CPU: each node's ranks then hold M
logical devices of the CPU and the kernels take their plain versions.)

``--bytes B --iters K`` runs it at B bytes of float32 a rank instead:
each rank's input is a non-constant pattern; one checked op (the
result within the float SUM band, N * 2**-24 * sum|x| element by
element, of a float64 sum of every rank's input), then K ops, each
step timed on the host clock from a barrier (the slowest node leader's
mean: a member's Bcast wait holds the leaders' hop).  The lowest rank
of each node prints one JSON line: the node, its ranks, the provider
of the node comm's allreduce_arr, the node's K6 / K2-peer / K1
launches over the K ops and in all, the microseconds an op of each
step (node allreduce_arr, the leaders' Allreduce, the node Bcast) and
of the whole op, the largest error, and the leader's wall clock
(``time.time()``) when the job's first collectives (the two splits)
and its first hierarchical allreduce returned.
"""
import json
import sys
import time

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch.comm.communicator import COMM_TYPE_SHARED
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as mpi_op

comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
dev = comm.device

node = comm.split_type(COMM_TYPE_SHARED)
leaders = comm.split(0 if node.rank == 0 else 1)
first_collective = time.time()  # the job's first collectives returned


def sync():
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def offloaded() -> int:
    for pv in registry.all_pvars():
        if pv.full_name == "coll_tpu_offloaded_collectives":
            return pv.read()
    return 0


def hier(x, times=None):
    """One hierarchical allreduce of ``x``; ``times`` collects each
    step's host-clock seconds."""
    t0 = time.perf_counter()
    # 1. intra-node device allreduce (the mesh tier over the node's
    # devices)
    partial = node.allreduce_arr(x, mpi_op.SUM)
    buf = partial.cpu().numpy()
    t1 = time.perf_counter()
    # 2. inter-node allreduce of the partials on node leaders (host
    # plane)
    if node.rank == 0:
        total = np.empty_like(buf)
        leaders.Allreduce(buf, total, op=mpi_op.SUM)
    else:
        total = buf
    t2 = time.perf_counter()
    # 3. intra-node bcast of the result
    out = np.empty_like(total)
    node.Bcast(total if node.rank == 0 else out, root=0)
    result = total if node.rank == 0 else out
    t3 = time.perf_counter()
    if times is not None:
        times.append((t1 - t0, t2 - t1, t3 - t2, t3 - t0))
    return result


def pattern(r: int, n: int, dtype):
    """Rank r's input: a non-constant pattern in [0, 1), on the device."""
    i = torch.arange(n, device=dev, dtype=torch.int64)
    return ((i * 7 + r * 13) % 1001).to(dtype) / 1001.0


def launches() -> dict:
    from ompi_tpu_torch.kernels import mesh, stacked
    return {"mesh_fold": mesh.mesh_fold.launches.value,
            "peer_copy": stacked.peer_copy.launches.value,
            "stacked_reduce": stacked.stacked_reduce.launches.value}


def measured(nbytes: int, iters: int) -> None:
    n = nbytes // 4
    x = pattern(rank, n, torch.float32)
    y = torch.from_numpy(hier(x))
    ref = sum(pattern(r, n, torch.float64) for r in range(size)).cpu()
    err = float((y.double() - ref).abs().max())
    band = float(size * 2.0 ** -24 * ref.abs().max())
    assert torch.isfinite(y).all() and err <= band, (rank, err, band)
    first_allreduce = time.time()
    sync()
    comm.Barrier()
    k0 = launches()
    times = []
    for _ in range(iters):
        comm.Barrier()
        hier(x, times)
    sync()
    comm.Barrier()
    k1 = launches()
    errs = np.array([err])
    worst = np.empty_like(errs)
    comm.Allreduce(errs, worst, mpi_op.MAX)
    world = getattr(comm.state.rte, "world", None)
    if node.rank == 0:
        # the split as the leaders see it (a member's Bcast wait holds
        # the leaders' hop): the slowest leader's mean of each step
        mean = np.array(times).mean(axis=0)
        slowest = np.empty_like(mean)
        leaders.Allreduce(mean, slowest, mpi_op.MAX)
        sys.stdout.write(json.dumps({
            "node": comm.state.rte.node_id,
            "ranks": node.size, "shell_ranks": getattr(world, "nlocal", 1),
            "node_provider": node.coll.providers["allreduce_arr"],
            "ops": iters,
            "launches": {k: k1[k] - k0[k] for k in k1},
            "launches_total": k1,
            "us_node_allreduce": float(slowest[0]) * 1e6,
            "us_leaders_allreduce": float(slowest[1]) * 1e6,
            "us_node_bcast": float(slowest[2]) * 1e6,
            "us_per_op": float(slowest[3]) * 1e6,
            "offloaded": offloaded(),
            "unix_first_collective": first_collective,
            "unix_first_allreduce": first_allreduce,
            "max_err": float(worst[0]), "device": str(dev)}) + "\n")
        sys.stdout.flush()
    assert offloaded() > 0, "intra-node collective was not device-offloaded"


if "--bytes" in sys.argv:
    measured(int(sys.argv[sys.argv.index("--bytes") + 1]),
             int(sys.argv[sys.argv.index("--iters") + 1]))
    ompi_tpu_torch.finalize()
    sys.exit(0)

x = torch.full((size * 2,), float(rank + 1), dtype=torch.float32,
               device=dev)
result = hier(x)

expect = sum(range(1, size + 1))
assert float(result[0]) == expect, (rank, result[0], expect)

n_off = offloaded()
# one atomic write per line: the ranks of a node are threads of one
# app-shell process sharing its stdout
sys.stdout.write(f"rank {rank}: hierarchical allreduce ok "
                 f"(device-offloaded={n_off})\n")
sys.stdout.flush()
assert n_off > 0, "intra-node collective was not device-offloaded"
ompi_tpu_torch.finalize()
