"""Replay of a logged payload LARGER than the shm ring: the port of
the reference's ``tests/_vproto_big_prog.py``.  Rank 0 sends 12 MiB
(more than the 8 MiB default ``btl_shm_ring_size``), then replays its
whole log.  A raw MATCH frame that size can never fit the ring; the
payload rides position-addressed MSEG segments and the receiver drops
the assembled duplicate (its sequence number is consumed).

    python -m ompi_tpu_torch.tools.mpirun -np 2 \\
        --mca pml_vprotocol pessimist \\
        ompi_tpu_torch/examples/vproto_big_prog.py
"""
import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.pml.vprotocol import find

comm = ompi_tpu_torch.init()
v = find(comm.state.pml)
assert v is not None, "launch with --mca pml_vprotocol pessimist"
N = 12 * 1024 * 1024 // 8
if comm.rank == 0:
    comm.Send(np.arange(N, dtype=np.float64), dest=1, tag=5)
    comm.Barrier()
    assert v.replay() >= 1
    comm.Barrier()
    print("vproto big ok", flush=True)
else:
    got = np.empty(N)
    comm.Recv(got, source=0, tag=5)
    assert got[0] == 0.0 and got[-1] == N - 1
    comm.Barrier()   # sender replays now
    comm.Barrier()   # sender done replaying
    comm.state.progress.progress()
    # the assembled duplicate must have been dropped, not re-matched
    assert comm.Iprobe(source=0, tag=5) in (False, None), \
        "duplicate redelivery of replayed large message"
ompi_tpu_torch.finalize()
