"""Iterating job with per-step checkpoints: the port's copy of the
reference's ``tests/_ckpt_prog.py``.  CKPT_CRASH_AT=k makes rank 2 die
hard right after the step-k checkpoint; a restart (``tools/restart``,
``tools/migrate`` or mpirun's restart policy) resumes from that
snapshot and must produce the same final answer as an uninterrupted
run.

    python -m ompi_tpu_torch.tools.mpirun -np 4 --ckpt-dir STORE \\
        ompi_tpu_torch/examples/ckpt_prog.py [--device auto|cpu]

Beside the reference's numpy accumulator, the state carries the same
sum as a float64 tensor on the rank's device (``--device auto``, the
default: card ``rank % count``; ``cpu``: the CPU); rank 0 prints
``CARD <sha256>`` of its bytes before the reference's ``final`` line.
"""
import hashlib
import os
import sys

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch import cr
from ompi_tpu_torch.op import op as mpi_op

argv = sys.argv[1:]
choice = argv[argv.index("--device") + 1] if "--device" in argv else "auto"
STEPS = 8
crash_at = int(os.environ.get("CKPT_CRASH_AT", "-1"))

comm = ompi_tpu_torch.init(device=choice)
dev = comm.state.device
state = cr.restore(comm)
resumed = state is not None
if state is None:
    state = {"step": 0, "acc": np.zeros(4),
             "card": torch.zeros(4, dtype=torch.float64, device=dev)}

while state["step"] < STEPS:
    contrib = np.full(4, float(comm.rank + 1) * (state["step"] + 1))
    r = np.empty(4)
    comm.Allreduce(contrib, r, mpi_op.SUM)
    state["acc"] = state["acc"] + r
    state["card"] += torch.from_numpy(r).to(dev)
    state["step"] += 1
    cr.checkpoint(comm, state, keep=2)
    if state["step"] == crash_at and comm.rank == 2:
        os._exit(17)  # hard mid-job death (no finalize, no cleanup)

node = os.environ.get("TPUMPI_NODE_NAME", "local")
print(f"rank {comm.rank} on node {node}", flush=True)
if comm.rank == 0:
    card = state["card"].cpu().numpy()
    print(f"CARD {hashlib.sha256(card.tobytes()).hexdigest()}",
          flush=True)
    print(f"final step={state['step']} resumed={resumed} "
          f"acc={state['acc'].tolist()}", flush=True)
ompi_tpu_torch.finalize()
