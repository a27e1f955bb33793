"""Multi-rail striping exerciser: the port of the reference's
``tests/_rails_prog.py``.  A rendezvous-sized transfer over ``btl
self,tcp`` with ``btl_tcp_rails`` > 1 must land FRAG segments on more
than one rail (pvar-counted) and arrive intact; with one rail, only
rail 0 carries them.

    python -m ompi_tpu_torch.tools.mpirun -np 2 --mca btl self,tcp \\
        --mca btl_tcp_rails 3 --mca btl_tcp_max_send_size 131072 \\
        ompi_tpu_torch/examples/rails_prog.py

Rank 0 prints ``rails used=<n> counts=[...]``.
"""
import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.mca.params import registry

comm = ompi_tpu_torch.init()
N = 4 * 1024 * 1024 // 8  # 4 MiB of float64 >> eager limit
if comm.rank == 0:
    x = np.arange(N, dtype=np.float64)
    comm.Send(x, dest=1, tag=5)
    comm.Barrier()
    counts = []
    for pv in registry.all_pvars():
        if pv.full_name.startswith("btl_tcp_rail") and \
                pv.full_name.endswith("_frags_r0"):
            counts.append((pv.full_name, pv.read()))
    counts.sort()
    used = sum(1 for _, c in counts if c and c > 0)
    print(f"rails used={used} counts={counts}", flush=True)
else:
    got = np.empty(N, dtype=np.float64)
    comm.Recv(got, source=0, tag=5)
    assert got[0] == 0.0 and got[-1] == float(N - 1)
    step = max(1, N // 997)
    idx = np.arange(0, N, step)
    assert (got[idx] == idx.astype(np.float64)).all()
    comm.Barrier()
ompi_tpu_torch.finalize()
