"""The port's copy of the reference's ``tests/_collseg_tails_prog.py``.

Tail-segment audit exerciser for the chunked segment collectives:
element counts straddling the piece size (count % piece in
{0, 1, piece-1}) across odd dtypes must stream through the segment
correctly — the ragged remainder takes the every-rank-folds round,
the P-divisible head must still split as reduce_scatter+allgather.

argv[1]: 0 (exact multiple), 1 (one extra element), -1 (piece-1
extra).  Run with a small coll_seg_slot_bytes so several pieces fit
in seconds:

    python -m ompi_tpu_torch.tools.mpirun -np 5 \
        --mca coll_seg_slot_bytes 16384 \
        ompi_tpu_torch/examples/collseg_tails_prog.py 1
"""
import sys

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as mpi_op

comm = ompi_tpu_torch.init()
P, me = comm.size, comm.rank
assert comm.coll.providers.get("allreduce") == "seg", \
    comm.coll.providers

slot = registry.get("coll_seg_slot_bytes")
rem_arg = int(sys.argv[1])

for dt in (np.int8, np.float16, np.float32, np.float64):
    itemsize = np.dtype(dt).itemsize
    per = (slot // itemsize) // P * P
    rem = {0: 0, 1: 1, -1: per - 1}[rem_arg]
    n = per * 2 + rem  # two full pieces + the tail under test
    # exact-representable values at every dtype (fp16 sums stay tiny,
    # int8 sums stay far from wraparound for P <= 8)
    base = (np.arange(n) % 5).astype(dt)
    x = base + np.dtype(dt).type(me % 2)
    r = np.empty_like(x)
    comm.Allreduce(x, r, mpi_op.SUM)
    expect = base.astype(np.int64) * P + sum(r_ % 2 for r_ in range(P))
    assert (r.astype(np.int64) == expect).all(), \
        (dt, n, np.nonzero(r.astype(np.int64) != expect)[0][:5])

    # MAX exercises the non-SUM fold on the same tail geometry
    xm = base + np.dtype(dt).type(me)
    rm = np.empty_like(xm)
    comm.Allreduce(xm, rm, mpi_op.MAX)
    expect_m = base.astype(np.int64) + (P - 1)
    assert (rm.astype(np.int64) == expect_m).all(), (dt, n)

    # chunked bcast has its own piece size (no P rounding): same
    # count offsets against it
    perb = slot // itemsize
    nb = perb * 2 + {0: 0, 1: 1, -1: perb - 1}[rem_arg]
    bb = (np.arange(nb) % 7).astype(dt) if me == 0 \
        else np.zeros(nb, dt)
    comm.Bcast(bb, root=0)
    assert (bb.astype(np.int64) == np.arange(nb) % 7).all(), (dt, nb)

comm.Barrier()
if me == 0:
    print("collseg tails ok", flush=True)
ompi_tpu_torch.finalize()
