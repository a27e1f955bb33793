"""scoll: the SHMEM collectives framework.

Port of the reference's shmem/scoll.py, a re-design of oshmem/mca/scoll
(ref: oshmem/mca/scoll/basic — PE collectives as their own component
family; scoll/mpi delegates to the MPI coll stack).  Here the `mpi`
component is the default and the point: the per-communicator coll
stack already holds the best available path for this world, so SHMEM
collectives inherit it by riding ``comm.coll`` — the scoll-over-coll
reuse the architecture promises.  The blocks are host numpy buffers
on the comm's host collectives (``Bcast``, ``Allgather``,
``Alltoall``, ``Allreduce``)."""

from __future__ import annotations

import numpy as np

from ompi_tpu_torch.mca.base import Component, frameworks
from ompi_tpu_torch.op.op import BAND, BOR, BXOR, MAX, MIN, PROD, SUM

scoll_framework = frameworks.create("shmem", "scoll")


class MpiScollModule:
    """PE collectives delegated to the context comm's merged coll
    vtable (scoll/mpi analog).  Symmetric blocks are staged through
    the ctx accessors rather than touched as live views: a device
    heap has no writable host alias, so results land via
    ``ctx._write_sym`` (a self-put on the window) and sources come
    from ``ctx._read_sym`` (a heap view, or a snapshot of the device
    shard, read by a self-get)."""

    name = "mpi"

    def __init__(self, ctx) -> None:
        self.ctx = ctx

    def barrier_all(self) -> None:
        self.ctx.comm.Barrier()

    def broadcast(self, dest, src, root: int) -> None:
        comm = self.ctx.comm
        buf = np.array(self.ctx._read_sym(src)) if comm.rank == root \
            else np.empty(src.shape, dtype=src.dtype)
        comm.Bcast(buf, root=root)
        self.ctx._write_sym(dest, buf)

    def collect(self, dest, src) -> None:
        """fcollect: concatenation of every PE's src block."""
        out = np.empty(dest.shape, dtype=dest.dtype).reshape(-1)
        self.ctx.comm.Allgather(
            np.ascontiguousarray(self.ctx._read_sym(src).reshape(-1)),
            out)
        self.ctx._write_sym(dest, out)

    def alltoall(self, dest, src) -> None:
        out = np.empty(dest.shape, dtype=dest.dtype).reshape(-1)
        self.ctx.comm.Alltoall(
            np.ascontiguousarray(self.ctx._read_sym(src).reshape(-1)),
            out)
        self.ctx._write_sym(dest, out)

    def to_all(self, dest, src, op) -> None:
        out = np.empty(dest.shape, dtype=dest.dtype).reshape(-1)
        self.ctx.comm.Allreduce(
            np.ascontiguousarray(self.ctx._read_sym(src).reshape(-1)),
            out, op)
        self.ctx._write_sym(dest, out)


class MpiScollComponent(Component):
    name = "mpi"
    priority = 50

    def query(self, ctx=None):
        if ctx is None:
            return (self.priority, None)
        return (self.priority, MpiScollModule(ctx))


scoll_framework.add_component(MpiScollComponent())

OPS = {"sum": SUM, "max": MAX, "min": MIN, "prod": PROD,
       "and": BAND, "or": BOR, "xor": BXOR}


def select(ctx) -> MpiScollModule:
    best = None
    for comp in scoll_framework.components():
        got = comp.query(ctx)
        if got and got[1] is not None and (
                best is None or got[0] > best[0]):
            best = got
    if best is None:
        raise RuntimeError("no scoll component available")
    return best[1]
