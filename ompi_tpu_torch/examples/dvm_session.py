"""Session workload of the resident pool (tools/dvm.py): a deterministic
mix of fused nonblocking device collectives plus one blocking
allreduce, digested to one line printed by rank 0 only — so a run's
DIGEST line is byte-comparable across sequential and concurrent
sessions, across pools, and with the reference pool's
(tests/_dvm_session_prog.py, which needs JAX; this program imports
only torch and the port).

    python -m ompi_tpu_torch.tools.dvm --np 8 --devices cpu \\
        --uri-file /tmp/dvm.uri &
    python -m ompi_tpu_torch.tools.mpirun --dvm /tmp/dvm.uri -np 4 \\
        ompi_tpu_torch/examples/dvm_session.py TAG [REPS] [report]

A rep is ``iallreduce_arr`` SUM of 32 int32, ``iallreduce_arr`` MAX of
16 float32, ``ibcast_arr`` of 7 int32 from rank 1 % size (one fused
batch: one K3 launch a (op, dtype) group, the bcast riding the int32
SUM group) and a blocking ``allreduce_arr`` SUM of 64 float32 (one K1
launch).  Every value is an integer, or a float sum of small integers,
so the digest is exact.  Without a device (``--devices none``) a rep is
one host Allreduce of 16 float32.

``TAG`` is echoed in the digest line (argv isolation), ``REPS`` repeats
the mix (default 1), and ``report`` makes rank 0 print one more line,
``REPORT TAG {json}``: the microseconds a collective of the timed reps
(from a barrier before them to a barrier after).  The pool's launch
counts are read through its metrics RPC (``DvmClient.metrics``).
"""
import hashlib
import json
import sys
import time

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch.op import op as mpi_op

comm = ompi_tpu_torch.init()
rank, size = comm.rank, comm.size
dev = comm.device
tag = sys.argv[1] if len(sys.argv) > 1 else "t"
reps = int(sys.argv[2]) if len(sys.argv) > 2 else 1
report = len(sys.argv) > 3 and sys.argv[3] == "report"



if report:
    comm.Barrier()
    t0 = time.perf_counter()
pieces = []
for _ in range(reps):
    if dev is not None:
        a = torch.arange(32, dtype=torch.int32, device=dev) * (rank + 1)
        b = torch.full((16,), float(rank + 1), dtype=torch.float32,
                       device=dev)
        b[0] = -rank
        c = torch.full((7,), rank * 3 + 1, dtype=torch.int32, device=dev)
        reqs = [comm.iallreduce_arr(a, mpi_op.SUM),
                comm.iallreduce_arr(b, mpi_op.MAX),
                comm.ibcast_arr(c, 1 % size)]
        for q in reqs:
            q.wait()
        pieces += [q.result.cpu().numpy().tobytes() for q in reqs]
        d = comm.allreduce_arr(
            torch.full((64,), rank + 1.0, dtype=torch.float32, device=dev),
            mpi_op.SUM)
        pieces.append(d.cpu().numpy().tobytes())
    else:
        x = np.full(16, rank + 1.0, np.float32)
        r = np.empty_like(x)
        comm.Allreduce(x, r, mpi_op.SUM)
        pieces.append(r.tobytes())
if report:
    comm.Barrier()
    wall = time.perf_counter() - t0
dig = hashlib.sha256(b"".join(pieces)).hexdigest()
if rank == 0:
    # one write a line: the session's ranks share the pool's stdout
    sys.stdout.write(f"DIGEST {tag} {dig}\n")
    if report:
        ncoll = (4 if dev is not None else 1) * reps
        doc = {"reps": reps, "np": size, "device": str(dev),
               "us_per_coll": wall / ncoll * 1e6}
        sys.stdout.write(f"REPORT {tag} {json.dumps(doc)}\n")
    sys.stdout.flush()
ompi_tpu_torch.finalize()
