"""dfs exerciser: the port's copy of the reference's
``tests/_dfs_prog.py``.  Ranks on (simulated) compute nodes read a
file that only the launch host is meant to own, via file://hnp/
through the KV control plane (dfs/app analog).  The file must hold
the 3000 bytes i % 256:

    python -m ompi_tpu_torch.tools.mpirun -np 2 \\
        ompi_tpu_torch/examples/dfs_prog.py /path/to/input.bin
"""
import sys

import ompi_tpu_torch
from ompi_tpu_torch.runtime import dfs

path = sys.argv[1]
comm = ompi_tpu_torch.init()

# remote-host route: explicit hnp uri forces the control plane
with dfs.open(f"file://hnp/{path.lstrip('/')}", comm.state.rte) as f:
    assert f.size() == 3000, f.size()
    head = f.read(100)
    assert head == bytes(range(100)), head[:8]
    f.seek(2900)
    tail = f.read()
    assert len(tail) == 100 and tail[-1] == (2999 % 256)
    try:
        f.seek(5000)
        raise SystemExit("seek past EOF must fail")
    except OSError:
        pass
    # pread does not disturb the pointer
    assert f.pread(0, 4) == bytes(range(4))

# local route: plain path bypasses the control plane
with dfs.open(path) as f:
    assert f.read(10) == bytes(range(10))

comm.Barrier()
if comm.rank == 0:
    print("dfs ok", flush=True)
ompi_tpu_torch.finalize()
