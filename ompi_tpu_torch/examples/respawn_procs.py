"""Self-healing respawn over process ranks: the port's copy of the
reference's ``tests/_respawn_prog.py``.  One rank is killed mid-loop by
ft_inject ``rank_kill``; under mpirun's ``respawn`` errmgr policy
mpirun relaunches it (or the app shell holding it) under the SAME world
rank at a bumped recovery epoch, survivors and replacement run the
rejoin protocol (ft/respawn) and everyone rolls back to the newest
buddy checkpoint (cr/buddy) — the job finishes at FULL size with
results byte-identical to a fault-free run, and the replacement's state
comes from a partner rank's memory.

    python -m ompi_tpu_torch.tools.mpirun -np 4 \\
        --mca errmgr_base_policy respawn --mca cr_buddy_degree 1 \\
        --mca ft_inject_plan rank_kill --mca ft_inject_victim_rank 1 \\
        --mca ft_inject_after 0.8 \\
        ompi_tpu_torch/examples/respawn_procs.py [--device auto|cpu]

Every rank prints the reference's ``rank={r} size={n} joined={0|1}
rejoins={k} digest={hex}`` line, then reduces its accumulator on its
device with ``allreduce_arr`` and prints ``CARD rank={r} {sha256}`` of
the result (equal on every rank).
"""
import hashlib
import sys
import time

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch.cr import buddy
from ompi_tpu_torch.errhandler import MPIException
from ompi_tpu_torch.ft import respawn
from ompi_tpu_torch.op import op as mpi_op

ITERS = 40
argv = sys.argv[1:]
choice = argv[argv.index("--device") + 1] if "--device" in argv else "auto"


def _load(st):
    if st is None:  # died before the first commit: start over
        return 0, np.zeros(8)
    return int(st["i"]), np.asarray(st["acc"])


comm = ompi_tpu_torch.init(device=choice)
was_joining = respawn.joining(comm.state)
if was_joining:
    comm = respawn.rejoin(comm)
    i, acc = _load(buddy.restore(comm))
else:
    i, acc = 0, np.zeros(8)
rejoins = 0
while i < ITERS:
    try:
        buddy.checkpoint(comm, {"i": i, "acc": acc})
        x = np.full(8, (comm.rank + 1.0) * (i + 1))
        r = np.empty_like(x)
        comm.Allreduce(x, r, mpi_op.SUM)
        acc = acc + r
        i += 1
        time.sleep(0.05)
    except MPIException as e:
        assert e.code in (75, 76, 77), e.code
        comm = respawn.rejoin(comm)
        i, acc = _load(buddy.restore(comm))
        rejoins += 1
card = comm.allreduce_arr(torch.from_numpy(acc).to(comm.device),
                          mpi_op.SUM)
cdig = hashlib.sha256(card.cpu().numpy().tobytes()).hexdigest()
# one write for both lines: the rank-threads of an app shell share its
# stdout, and print()'s separate text and newline writes interleave
sys.stdout.write(f"rank={comm.rank} size={comm.size} "
                 f"joined={int(was_joining)} rejoins={rejoins} "
                 f"digest={acc.tobytes().hex()[:24]}\n"
                 f"CARD rank={comm.rank} {cdig}\n")
sys.stdout.flush()
ompi_tpu_torch.finalize()
