"""Checkpointing session workload of the resident pool's fleet: the
port's copy of the reference's ``tests/_fleet_ckpt_prog.py`` — a
deterministic stepped allreduce accumulation that checkpoints EVERY
step to the filesystem tier and restores at start, so a run that the
pool parks and replays (its host died under a session that is not
ULFM-aware) resumes where it stopped and its final digest is
byte-identical to an unkilled run.  The reference checkpoints through
``cr.ckpt``; the port's filesystem tier until ROADMAP A9 is
``cr.checkpoint`` / ``cr.restore`` — the same state and digest.

    python -m ompi_tpu_torch.tools.mpirun --dvm /tmp/dvm.uri -np 2 \\
        ompi_tpu_torch/examples/fleet_ckpt.py TAG STORE STEPS [SLEEP_S] \\
        [--hold STEP PATH] [--device auto|cpu]

``--hold STEP PATH``: at step STEP of a run that did not resume, rank 0
writes PATH and every rank then waits in a receive nobody sends — the
deterministic kill point of a test: whoever watches PATH kills a host,
the pool takes the session down (the wait raises) and replays the run,
which resumes from step STEP's checkpoint.

Rank 0 prints the reference's ``STEPS {tag} {resumed_at}`` and
``DIGEST {tag} {sha256}``, then ``CARD {tag} {sha256}``: the digest of
the accumulator reduced on the ranks' device with ``allreduce_arr``.
"""
import hashlib
import os
import sys
import time

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch import cr
from ompi_tpu_torch.op import op as mpi_op

argv = list(sys.argv[1:])
hold = None
if "--hold" in argv:
    i = argv.index("--hold")
    hold = (int(argv[i + 1]), argv[i + 2])
    del argv[i:i + 3]
choice = "auto"
if "--device" in argv:
    i = argv.index("--device")
    choice = argv[i + 1]
    del argv[i:i + 2]
tag = argv[0]
store = argv[1]
steps = int(argv[2])
sleep_s = float(argv[3]) if len(argv) > 3 else 0.0

comm = ompi_tpu_torch.init(device=choice)
rank, size = comm.rank, comm.size

snap = cr.restore(comm, store_dir=store, resume=True)
if snap is None:
    start = 0
    vec = np.zeros(32, np.float64)
else:
    start = int(snap["step"])
    vec = np.asarray(snap["vec"], np.float64)

for step in range(start, steps):
    if hold is not None and step == hold[0] and start == 0:
        if rank == 0:
            with open(hold[1] + ".tmp", "w") as fh:
                fh.write(f"{tag} {step}\n")
            os.replace(hold[1] + ".tmp", hold[1])
        comm.Recv(np.empty(1, np.float64), source=(rank + 1) % size,
                  tag=7007)
    contrib = np.full(32, float((step + 1) * (rank + 1)), np.float64)
    r = np.empty_like(contrib)
    comm.Allreduce(contrib, r, mpi_op.SUM)
    vec = vec + r
    cr.checkpoint(comm, {"step": step + 1, "vec": vec}, store_dir=store)
    if sleep_s:
        time.sleep(sleep_s)

dig = hashlib.sha256(vec.tobytes()).hexdigest()
card = comm.allreduce_arr(torch.from_numpy(vec).to(comm.device),
                          mpi_op.SUM)
cdig = hashlib.sha256(card.cpu().numpy().tobytes()).hexdigest()
if rank == 0:
    print(f"STEPS {tag} {start}", flush=True)
    print(f"DIGEST {tag} {dig}", flush=True)
    print(f"CARD {tag} {cdig}", flush=True)
ompi_tpu_torch.finalize()
