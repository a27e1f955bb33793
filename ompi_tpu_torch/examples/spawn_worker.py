"""Worker side of the Comm_spawn demo (see spawn_parent.py): the
port's copy of the reference's ``examples/spawn_worker.py``, with the
same ``--device``/``--mib`` options as the parent."""
import hashlib
import sys

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch.op import op as mpi_op


def options(argv):
    """(device choice or None, MiB) from the program's arguments."""
    choice = argv[argv.index("--device") + 1] if "--device" in argv \
        else None
    mib = int(argv[argv.index("--mib") + 1]) if "--mib" in argv else 1
    return choice, mib


def card_values(rank: int, n: int, dev) -> torch.Tensor:
    """Merged rank ``rank``'s input: small integers in float32, so the
    SUM over a few ranks is exact in any order."""
    i = torch.arange(n, dtype=torch.int64, device=dev)
    return ((i * 2654435761 + rank * 97) % 1000003).to(torch.float32)


def card_allreduce(merged, mib: int) -> None:
    """One allreduce_arr SUM of ``mib`` MiB of float32 on this rank's
    device over the merged communicator; prints its digest."""
    dev = merged.device
    y = merged.allreduce_arr(card_values(merged.rank, mib << 18, dev),
                             mpi_op.SUM)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sha = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
    print(f"CARD rank={merged.rank} device={y.device.type} {sha}",
          flush=True)


if __name__ == "__main__":
    choice, mib = options(sys.argv[1:])
    comm = ompi_tpu_torch.init(device=choice)
    parent = ompi_tpu_torch.get_parent()
    assert parent is not None, "worker must be spawned"

    mine = np.array([100.0 + comm.rank], dtype=np.float64)
    got = np.empty(1, dtype=np.float64)
    parent.Allreduce(mine, got, mpi_op.SUM)
    # we receive the parents' reduction
    nparents = parent.remote_size
    assert got[0] == sum(range(1, nparents + 1)), got

    merged = parent.merge(high=True)
    total = np.empty(1, dtype=np.float64)
    merged.Allreduce(mine, total, mpi_op.SUM)
    print(f"worker {comm.rank}: merged rank {merged.rank}/{merged.size}",
          flush=True)
    if choice is not None:
        card_allreduce(merged, mib)
    ompi_tpu_torch.finalize()
