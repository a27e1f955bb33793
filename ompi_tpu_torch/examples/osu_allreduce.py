"""OSU-style allreduce micro-benchmark over the launched job
(ref: the external OSU suite SURVEY.md §4 delegates to)."""
import sys
import time
import numpy as np
import ompi_tpu_torch
from ompi_tpu_torch.op import op

comm = ompi_tpu_torch.init()
sizes = [4, 1024, 64 * 1024, 1024 * 1024]
if len(sys.argv) > 1:
    sizes = [int(s) for s in sys.argv[1].split(",")]
for nbytes in sizes:
    n = max(1, nbytes // 4)
    x = np.full(n, comm.rank + 1.0, dtype=np.float32)
    r = np.empty_like(x)
    comm.Allreduce(x, r, op.SUM)
    iters = 20 if nbytes <= 64 * 1024 else 5
    comm.Barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        comm.Allreduce(x, r, op.SUM)
    dt = (time.perf_counter() - t0) / iters
    assert abs(r[0] - sum(range(1, comm.size + 1))) < 1e-3
    if comm.rank == 0:
        print(f"{n * 4:>10} bytes  {dt * 1e6:10.1f} us", flush=True)
ompi_tpu_torch.finalize()
