"""ULFM forward recovery over process ranks: the port's copy of the
reference's ``tests/_ulfm_prog.py``.  One rank is killed mid-loop by
ft_inject ``rank_kill``; under mpirun's ``ulfm`` errmgr policy the
survivors see ERR_PROC_FAILED, shrink, and finish the job on the
remaining ranks — forward recovery, no restart.  Unlike the
reference's loop, the survivors agree after the shrink on the step to
go on from (see the loop).

    python -m ompi_tpu_torch.tools.mpirun -np 4 \\
        --mca errmgr_base_policy ulfm --mca ft_inject_plan rank_kill \\
        --mca ft_inject_victim_rank 1 --mca ft_inject_after 0.8 \\
        ompi_tpu_torch/examples/ulfm_procs.py [--device auto|cpu] [--mib N]

Each survivor prints the reference's ``rank={r} size={n} shrunk={k}
sum={s}`` line, then reduces a tensor of ``--mib`` MiB of float32 (8 by
default) on its device with ``allreduce_arr`` over the survivors'
communicator and prints ``CARD rank={r} {sha256}`` of the result (equal
on every survivor).  ``--device auto`` (the default) puts a process
rank on card ``rank % count`` and a rank of an app shell on the shell's
device; ``cpu`` on the CPU.
"""
import hashlib
import sys
import time

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch.errhandler import MPIException
from ompi_tpu_torch.op import op as mpi_op

argv = sys.argv[1:]
choice = argv[argv.index("--device") + 1] if "--device" in argv else "auto"
mib = int(argv[argv.index("--mib") + 1]) if "--mib" in argv else 8

comm = ompi_tpu_torch.init(device=choice)
work = comm
r = np.empty(64, dtype=np.float64)
shrunk = 0
step = 0
while step < 120:
    try:
        buf = np.full(64, work.rank + 1.0, dtype=np.float64)
        work.Allreduce(buf, r, mpi_op.SUM)
    except MPIException as e:
        assert e.code in (75, 76, 77), e.code
        work = work.shrink(name="survivors")
        shrunk += 1
        # the survivors agree on the step to go on from (the failed
        # one is skipped, as the reference's loop skips it): a survivor
        # whose Allreduce completed before the death is a step ahead
        # of one whose did not, and the reference's loop, which counts
        # its steps alone, lets the two run different numbers of
        # collectives on the shrunk communicator
        nxt = np.array([step + 1], np.int64)
        work.Allreduce(nxt.copy(), nxt, mpi_op.MAX)
        step = int(nxt[0])
        continue
    time.sleep(0.02)
    step += 1
x = torch.full((mib * (1 << 20) // 4,), float(work.rank + 1),
               dtype=torch.float32, device=comm.device)
card = work.allreduce_arr(x, mpi_op.SUM)
cdig = hashlib.sha256(card.cpu().numpy().tobytes()).hexdigest()
# one write for both lines: the rank-threads of an app shell share its
# stdout, and print()'s separate text and newline writes interleave
sys.stdout.write(f"rank={work.rank} size={work.size} shrunk={shrunk} "
                 f"sum={float(r[0])}\nCARD rank={work.rank} {cdig}\n")
sys.stdout.flush()
ompi_tpu_torch.finalize()
