"""coll/inter: two-group collective semantics for intercommunicators.

Re-design of ompi/mca/coll/inter: every collective's data crosses the
bridge — each group receives the other group's contribution.  The
pattern throughout: a LOCAL phase on the intercomm's private local
comm (reduce/gather to the local leader, or bcast from it) and a
BRIDGE phase where the leaders (local rank 0 of each side) exchange
over intercomm p2p (rooted operations address the explicit root
instead).

Rooted operations follow MPI's MPI_ROOT/MPI_PROC_NULL protocol: in
the root group, the sourcing/sinking rank passes ROOT and its peers
PROC_NULL; in the other group every rank passes the root's rank
within the REMOTE group.
"""

from __future__ import annotations

import numpy as np

from ompi_tpu_torch.coll.buffers import IN_PLACE, mpi_dtype_of, typed
from ompi_tpu_torch.coll.framework import CollModule
from ompi_tpu_torch.op.op import Op
from ompi_tpu_torch.pml.request import PROC_NULL

ROOT = -4  # MPI_ROOT

T_INTER = -130  # reserved tag block for inter collectives


def _pml(comm):
    return comm.state.pml


def _send(comm, arr: np.ndarray, dst: int, tag: int = T_INTER) -> None:
    arr = np.ascontiguousarray(arr)
    _pml(comm).send(arr, arr.size, mpi_dtype_of(arr), dst, tag, comm)


def _isend(comm, arr: np.ndarray, dst: int, tag: int = T_INTER):
    arr = np.ascontiguousarray(arr)
    return _pml(comm).isend(arr, arr.size, mpi_dtype_of(arr), dst, tag,
                            comm)


def _recv_into(comm, view: np.ndarray, src: int,
               tag: int = T_INTER) -> None:
    _pml(comm).recv(view, view.size, mpi_dtype_of(view), src, tag, comm)


def _exchange(comm, sarr: np.ndarray, rarr: np.ndarray,
              peer: int) -> None:
    """Leader sendrecv across the bridge (deadlock-free)."""
    req = _isend(comm, sarr, peer)
    _recv_into(comm, rarr, peer)
    req.wait()


class InterCollModule(CollModule):
    """Installed as the whole module stack of every intercomm."""

    name = "inter"

    def barrier(self, comm) -> None:
        lc = comm.local_comm
        lc.Barrier()
        if lc.rank == 0:
            token = np.zeros(1, dtype=np.int8)
            other = np.zeros(1, dtype=np.int8)
            _exchange(comm, token, other, 0)
        lc.Barrier()

    def bcast(self, comm, buf, count, datatype, root) -> None:
        if root == PROC_NULL:
            return
        if root == ROOT:
            tb = typed(buf, count, datatype)
            _send(comm, tb.arr, 0)  # to the remote leader
            return
        tb = typed(buf, count, datatype, writable=True)
        lc = comm.local_comm
        if lc.rank == 0:
            _recv_into(comm, tb.arr, root)
        lc.Bcast(tb.arr, root=0)
        tb.flush()

    def reduce(self, comm, sbuf, rbuf, count, datatype, op: Op,
               root) -> None:
        if root == PROC_NULL:
            return
        if root == ROOT:
            tb = typed(rbuf, count, datatype, writable=True)
            _recv_into(comm, tb.arr, 0)  # from the remote leader
            tb.flush()
            return
        # source group: reduce locally to the leader, leader forwards
        lc = comm.local_comm
        stb = typed(sbuf, count, datatype)
        if lc.rank == 0:
            tmp = np.empty_like(stb.arr)
            lc.Reduce(stb.arr, tmp, op, root=0)
            _send(comm, tmp, root)
        else:
            lc.Reduce(stb.arr, None, op, root=0)

    def allreduce(self, comm, sbuf, rbuf, count, datatype,
                  op: Op) -> None:
        """Each group receives the reduction of the OTHER group."""
        lc = comm.local_comm
        rtb = typed(rbuf, count, datatype, writable=True)
        stb = rtb if sbuf is IN_PLACE else typed(sbuf, count, datatype)
        if lc.rank == 0:
            mine = np.empty_like(stb.arr)
            lc.Reduce(stb.arr.copy() if sbuf is IN_PLACE else stb.arr,
                      mine, op, root=0)
            _exchange(comm, mine, rtb.arr, 0)
        else:
            lc.Reduce(stb.arr.copy() if sbuf is IN_PLACE else stb.arr,
                      None, op, root=0)
        lc.Bcast(rtb.arr, root=0)
        rtb.flush()

    def allgather(self, comm, sbuf, scount, sdt, rbuf, rcount,
                  rdt) -> None:
        """Every rank receives the concatenation of the REMOTE
        group's send buffers."""
        lc = comm.local_comm
        stb = typed(sbuf, scount, sdt)
        rtb = typed(rbuf, rcount * comm.remote_size, rdt, writable=True)
        if lc.rank == 0:
            gathered = np.empty(stb.arr.size * lc.size,
                                dtype=stb.arr.dtype)
            lc.Gather(stb.arr, gathered, root=0)
            _exchange(comm, gathered, rtb.arr, 0)
        else:
            lc.Gather(stb.arr, None, root=0)
        lc.Bcast(rtb.arr, root=0)
        rtb.flush()

    def gather(self, comm, sbuf, scount, sdt, rbuf, rcount, rdt,
               root) -> None:
        if root == PROC_NULL:
            return
        if root == ROOT:
            rtb = typed(rbuf, rcount * comm.remote_size, rdt,
                        writable=True)
            per = rtb.arr.size // comm.remote_size
            reqs = []
            for r in range(comm.remote_size):
                view = rtb.arr[r * per:(r + 1) * per]
                reqs.append(_pml(comm).irecv(
                    view, view.size, mpi_dtype_of(view), r, T_INTER,
                    comm))
            for q in reqs:
                q.wait()
            rtb.flush()
            return
        stb = typed(sbuf, scount, sdt)
        _send(comm, stb.arr, root)

    def scatter(self, comm, sbuf, scount, sdt, rbuf, rcount, rdt,
                root) -> None:
        if root == PROC_NULL:
            return
        if root == ROOT:
            stb = typed(sbuf, scount * comm.remote_size, sdt)
            per = stb.arr.size // comm.remote_size
            reqs = [_isend(comm, stb.arr[r * per:(r + 1) * per], r)
                    for r in range(comm.remote_size)]
            for q in reqs:
                q.wait()
            return
        rtb = typed(rbuf, rcount, rdt, writable=True)
        _recv_into(comm, rtb.arr, root)
        rtb.flush()

    def alltoall(self, comm, sbuf, scount, sdt, rbuf, rcount,
                 rdt) -> None:
        """Block i of my send buffer goes to REMOTE rank i; my recv
        block i comes from remote rank i."""
        stb = typed(sbuf, scount * comm.remote_size, sdt)
        rtb = typed(rbuf, rcount * comm.remote_size, rdt, writable=True)
        sper = stb.arr.size // comm.remote_size
        rper = rtb.arr.size // comm.remote_size
        reqs = []
        for r in range(comm.remote_size):
            view = rtb.arr[r * rper:(r + 1) * rper]
            reqs.append(_pml(comm).irecv(
                view, view.size, mpi_dtype_of(view), r, T_INTER, comm))
        sreqs = [_isend(comm, stb.arr[r * sper:(r + 1) * sper], r)
                 for r in range(comm.remote_size)]
        for q in reqs + sreqs:
            q.wait()
        rtb.flush()

    def reduce_scatter_block(self, comm, sbuf, rbuf, rcount, datatype,
                             op: Op) -> None:
        """Each group reduces the OTHER group's buffers; block i of
        the result lands on local rank i (blocks divided over the
        local group, mirroring the intracomm contract)."""
        lc = comm.local_comm
        rtb = typed(rbuf, rcount, datatype, writable=True)
        total = rtb.arr.size * lc.size
        stb = typed(sbuf, total, datatype)
        if lc.rank == 0:
            mine = np.empty_like(stb.arr)
            lc.Reduce(stb.arr, mine, op, root=0)
            theirs = np.empty_like(mine)
            _exchange(comm, mine, theirs, 0)
            lc.Scatter(theirs, rtb.arr, root=0)
        else:
            lc.Reduce(stb.arr, None, op, root=0)
            lc.Scatter(None, rtb.arr, root=0)
        rtb.flush()
