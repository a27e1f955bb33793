"""Uncoordinated checkpoint e2e (vprotocol/pessimist): the port of the
reference's ``tests/_vproto_prog.py``.  Rank 0 SENDS, then checkpoints
at once — no quiesce, the message may still be in flight; rank 1
checkpoints BEFORE receiving.  A crash after the snapshots
(VPROTO_CRASH=1: rank 1 dies) and a restart must replay the in-flight
message from rank 0's sender log so rank 1's receive completes
correctly.  The crash waits for both snapshots (a control-plane fence,
which leaves the pml's cut as it is): a rank killed mid-write would
leave no snapshot to restart from.

    python -m ompi_tpu_torch.tools.mpirun -np 2 --ckpt-dir STORE \\
        --mca pml_vprotocol pessimist \\
        ompi_tpu_torch/examples/vproto_prog.py [--device auto|cpu --mib M]
    python -m ompi_tpu_torch.tools.mpirun -np 2 --restart STORE \\
        --mca pml_vprotocol pessimist \\
        ompi_tpu_torch/examples/vproto_prog.py [--device auto|cpu --mib M]

With ``--mib M`` (and ``--device``: ``auto``, card ``rank % count``, or
``cpu``) rank 0 also ``send_arr``s an M MiB float32 tensor of
``card_values`` before its snapshot and overwrites it right after;
past ``btl_tpu_chunk_bytes`` it rides the chunked pull, whose parked
snapshot the uncoordinated checkpoint holds.  After the restart rank 1
receives it on its own device and prints ``CARD <sha256>`` of its
bytes.  Rank 0 prints ``vproto ok`` at the end.
"""
import hashlib
import os
import sys

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch import cr
from ompi_tpu_torch.op import op as mpi_op

argv = sys.argv[1:]
choice = argv[argv.index("--device") + 1] if "--device" in argv else None
mib = int(argv[argv.index("--mib") + 1]) if "--mib" in argv else 0
crash = os.environ.get("VPROTO_CRASH") == "1"


def card_values(n: int, dev):
    """The M MiB tensor's values: small integers in float32, exact."""
    import torch
    i = torch.arange(n, dtype=torch.int64, device=dev)
    return ((i * 2654435761) % 1000003).to(torch.float32)


comm = ompi_tpu_torch.init(device=choice)
dev = comm.state.device
if mib and dev is None:
    raise SystemExit("--mib needs --device auto|cpu")

state = cr.restore_local(comm)
if state is None:
    state = {"phase": 0}
    # warm the channel with one exchanged value
    x = np.full(4, comm.rank + 1.0)
    r = np.empty(4)
    comm.Allreduce(x, r, mpi_op.SUM)
    if comm.rank == 0:
        comm.Send(np.arange(8.0), dest=1, tag=11)
        if mib:
            t = card_values(mib * (1 << 18), dev)
            comm.send_arr(t, 1, tag=12)
            t.fill_(-1.0)  # the sender writes on: the log must not see it
        # send IN FLIGHT: snapshot without quiesce or drain
        state["phase"] = 1
        cr.checkpoint_local(comm, state)
    else:
        state["phase"] = 1
        cr.checkpoint_local(comm, state)  # BEFORE receiving tag 11
    # both snapshots durable before the crash: the control-plane fence
    # rides the KV store, never the pml, so it leaves the cut as it is
    comm.state.rte.fence()
    if crash and comm.rank == 1:
        os._exit(17)

if state["phase"] == 1:
    if comm.rank == 1:
        got = np.empty(8)
        comm.Recv(got, source=0, tag=11)
        assert (got == np.arange(8.0)).all(), got
        if mib:
            y = comm.recv_arr(0, tag=12)
            assert y.device == dev, (y.device, dev)
            raw = y.contiguous().cpu().numpy().tobytes()
            print(f"CARD {hashlib.sha256(raw).hexdigest()}", flush=True)
    comm.Barrier()
    if comm.rank == 0:
        print("vproto ok", flush=True)
ompi_tpu_torch.finalize()
