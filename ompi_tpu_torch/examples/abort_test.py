"""Abort propagation (ref: orte/test/mpi/abort.c)."""
import sys
import ompi_tpu_torch

comm = ompi_tpu_torch.init()
if comm.rank == 1:
    comm.abort(42)
# other ranks wait in a collective that can never complete
comm.Barrier()
print("should not reach here", flush=True)
