"""Live daemon-loss recovery job: the port's copy of the reference's
``tests/_ft_prog.py``.

Iterates checkpointed allreduce steps.  When a node daemon dies
mid-run, the launcher's recover policy re-routes the dead node's ranks
onto a survivor at a bumped epoch; surviving ranks catch JobRecovery
out of whatever collective they were parked in, perform the epoch
reset (``runtime/ft.recover``), and every rank reloads the latest
snapshot.  The final answer equals an uninterrupted run's.

    python -m ompi_tpu_torch.tools.mpirun -np 3 --simulate-nodes 3x1 \\
        --ranks-per-proc 1 --ckpt-dir STORE \\
        --mca errmgr_base_policy recover \\
        ompi_tpu_torch/examples/ft_prog.py [--device auto|cpu]

Beside the reference's numpy accumulator, the state carries the same
sum as a float64 tensor on the rank's device (``--device auto``, the
default: card ``rank % count``; ``cpu``: the CPU), checkpointed with
it; rank 0 prints ``CARD <sha256>`` of its bytes before the
reference's ``final step=... acc=[...]`` line.  A survivor prints
``rank R: world ok after recovery (N ranks)`` once a Barrier and an
Allreduce on COMM_WORLD succeeded right after its epoch reset; a
re-routed rank joins those two collectives right after init.
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
from ompi_tpu_torch.runtime import ft

argv = sys.argv[1:]
choice = argv[argv.index("--device") + 1] if "--device" in argv else "auto"

comm = ompi_tpu_torch.init(device=choice)
dev = comm.state.device
STEPS = 10
PACE = float(os.environ.get("FT_PACE_S", "0.25"))


def _dbg(msg):
    if os.environ.get("FT_DEBUG"):
        print(f"[prog r{comm.rank}] {msg}", file=sys.stderr, flush=True)


def load():
    _dbg("cr.restore enter")
    s = cr.restore(comm)
    _dbg(f"cr.restore done (have={s is not None})")
    if s is None:
        return {"step": 0, "acc": np.zeros(4),
                "card": torch.zeros(4, dtype=torch.float64, device=dev)}
    return s


def world_ok():
    """The first collectives of a recovery epoch, on every rank (a
    survivor right after its epoch reset, a re-routed rank right after
    init): where the reference's recovery raises MPI_ERR_PROC_FAILED."""
    comm.Barrier()
    one = np.ones(1)
    tot = np.empty(1)
    comm.Allreduce(one, tot, mpi_op.SUM)
    print(f"rank {comm.rank}: world ok after recovery "
          f"({int(tot[0])} ranks)", flush=True)


def recover(exc, how):
    print(f"rank {comm.rank}: recovering{how} (epoch {exc.epoch})",
          flush=True)
    ft.recover(comm, exc)
    world_ok()
    _dbg("recover returned; loading")
    return load()


if comm.state.ft_epoch:
    world_ok()  # a re-routed rank meets the survivors' world_ok
state = load()
recoveries = 0
while state["step"] < STEPS:
    try:
        contrib = np.full(4, float(comm.rank + 1) * (state["step"] + 1))
        r = np.empty(4)
        comm.Allreduce(contrib, r, mpi_op.SUM)
        state["acc"] = state["acc"] + r
        state["card"] += torch.from_numpy(r).to(dev)
        state["step"] += 1
        cr.checkpoint(comm, state, keep=3)
        if comm.rank == 0:
            print(f"ft: step {state['step']} done", flush=True)
        time.sleep(PACE)  # a window for the test to kill a daemon
    except ft.JobRecovery as e:
        recoveries += 1
        state = recover(e, "")
        _dbg(f"resuming at step {state['step']}")
    except Exception:  # noqa: BLE001 — transport error racing the
        #                epoch announcement (a dead peer's connection
        #                can fail a send first)
        if os.environ.get("FT_DEBUG"):
            import traceback
            print(f"rank {comm.rank}: transport-path error:\n"
                  f"{traceback.format_exc()}", file=sys.stderr,
                  flush=True)
        exc = ft.wait_pending(comm, timeout=30.0)
        recoveries += 1
        state = recover(exc, " after transport error")

node = os.environ.get("TPUMPI_NODE_NAME", "local")
print(f"rank {comm.rank} on node {node} recoveries={recoveries}",
      flush=True)
if comm.rank == 0:
    card = state["card"].cpu().numpy()
    print(f"CARD {hashlib.sha256(card.tobytes()).hexdigest()}",
          flush=True)
    print(f"final step={state['step']} acc={state['acc'].tolist()}",
          flush=True)
ompi_tpu_torch.finalize()
