"""Off-host buddy-restore workload of the resident pool's fleet: the
port's copy of the reference's ``tests/_fleet_buddy_prog.py``.  On a
pool of two host domains every rank buddy-checkpoints with degree 1 and
asserts the failure-domain-aware ring (cr/buddy ``ring_offsets`` over
the ranks' ``node_id``, the pool's host bands) placed its replica on
the OTHER host.  Host 1's ranks then drop their own copies — the
stand-in for "host 1 died and its replacements came back empty" — and
the collective restore must serve them from the off-host partners.

    python -m ompi_tpu_torch.tools.mpirun --dvm /tmp/dvm.uri -np 4 \\
        ompi_tpu_torch/examples/fleet_buddy.py TAG [--device auto|cpu]

Every rank prints the reference's ``BUDDY {tag} {rank} OK`` after
verifying the restored payload, and rank 0 prints ``CARD {tag} {sha256}``: the digest of the restored
vectors reduced with ``allreduce_arr``.
"""
import hashlib
import sys

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch.cr import buddy
from ompi_tpu_torch.op import op as mpi_op

argv = sys.argv[1:]
choice = argv[argv.index("--device") + 1] if "--device" in argv else "auto"
tag = argv[0]

comm = ompi_tpu_torch.init(device=choice)
rank, size = comm.rank, comm.size

nodes = buddy._rank_nodes(comm)
assert len(set(nodes)) > 1, (
    f"pool did not band ranks across hosts: {nodes}")
my_node = nodes[rank]

payload = {"rank": rank,
           "vec": np.full(16, float(rank + 1), np.float64)}
seq = buddy.checkpoint(comm, payload, degree=1)
assert seq >= 0, "buddy checkpoint did not commit"

bs = comm.state.extra["cr_buddy"]
# placement proof: every copy this rank holds belongs to an OFF-host
# owner — one dead host can never take a rank and its replica together
for owner, s in bs["held"]:
    assert nodes[owner] != my_node, (
        f"rank {rank} (host {my_node}) holds rank {owner}'s copy but "
        f"they share a host — placement is not domain-aware")

# host 1 dies: its ranks lose their own in-memory state
if my_node == 1:
    bs["self"].clear()

out = buddy.restore(comm)
assert out is not None, "restore found nothing committed"
assert int(out["rank"]) == rank
assert np.array_equal(np.asarray(out["vec"]),
                      np.full(16, float(rank + 1), np.float64))

card = comm.allreduce_arr(
    torch.as_tensor(np.asarray(out["vec"]), device=comm.device),
    mpi_op.SUM)
# one write a line: rank-threads share the session's stdout
sys.stdout.write(f"BUDDY {tag} {rank} OK\n")
if rank == 0:
    cdig = hashlib.sha256(card.cpu().numpy().tobytes()).hexdigest()
    sys.stdout.write(f"CARD {tag} {cdig}\n")
sys.stdout.flush()
ompi_tpu_torch.finalize()
