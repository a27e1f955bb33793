"""Warm-pool probe of the resident pool (tools/dvm.py), run through
``mpirun --dvm``: times program start -> first completed device
collective.  In a warm pool the imports, the CUDA context and the
kernel libraries are all already there, so a second job's time
collapses.  Torch-only counterpart of the reference's
tests/_dvm_prog.py.

    python -m ompi_tpu_torch.tools.mpirun --dvm /tmp/dvm.uri -np 4 \\
        ompi_tpu_torch/examples/dvm_prog.py
"""
import time

t0 = time.perf_counter()
import numpy as np  # noqa: E402
import torch  # noqa: E402

import ompi_tpu_torch  # noqa: E402
from ompi_tpu_torch.op import op as mpi_op  # noqa: E402

comm = ompi_tpu_torch.init()
if comm.device is not None:
    x = torch.full((1024,), comm.rank + 1.0, dtype=torch.float32,
                   device=comm.device)
    got = float(comm.allreduce_arr(x, mpi_op.SUM)[0])
else:
    x = np.full(1024, comm.rank + 1.0, dtype=np.float32)
    r = np.empty_like(x)
    comm.Allreduce(x, r, mpi_op.SUM)
    got = float(r[0])
expect = sum(range(1, comm.size + 1))
assert abs(got - expect) < 1e-3, (got, expect)
if comm.rank == 0:
    print(f"first_coll_s={time.perf_counter() - t0:.4f}", flush=True)
ompi_tpu_torch.finalize()
