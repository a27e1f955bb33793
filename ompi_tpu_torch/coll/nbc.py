"""coll/nbc: nonblocking collectives as round-based schedules.

Re-design of ompi/mca/coll/libnbc (ref: nbc.c:42-49 — a nonblocking
collective is compiled into a schedule of rounds, each round a set of
send/recv/local-op entries; rounds are separated by completion
barriers; schedules are progressed by a callback registered with
opal_progress — ompi_coll_libnbc_progress,
coll_libnbc_component.c:261,114).

Here a schedule is a list of rounds; a round is a list of thunks.
Thunks that start communication return a pml Request; local thunks
(copies, reductions) run inline at round start and return None.  The
NBCRequest registers one progress callback per rank (not per
request) that advances every in-flight schedule: a round is done
when all its requests are complete, then the next round starts; after
the last round the request completes and flushes copied-out buffers.

Tag safety: every collective instance on a communicator draws a fresh
tag from a per-comm sequence counter (the reference's per-comm libnbc
tag), so overlapping nonblocking collectives on one comm can't
cross-match — all ranks issue collectives in the same order per MPI
semantics, so the counters agree.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ompi_tpu_torch.coll.buffers import IN_PLACE, mpi_dtype_of, typed
from ompi_tpu_torch.coll.framework import CollComponent, CollModule, coll_framework
from ompi_tpu_torch.op.op import Op
from ompi_tpu_torch.pml.request import Request

NBC_TAG_BASE = -2000  # instance tags count down from here


def _nbc_tag(comm) -> int:
    seq = getattr(comm, "_nbc_seq", 0)
    comm._nbc_seq = seq + 1
    return NBC_TAG_BASE - seq


# ---------------------------------------------------------------------------
# schedule engine
# ---------------------------------------------------------------------------

class _PerRankNbcState:
    """One progress callback per rank drives all active schedules."""

    def __init__(self, progress) -> None:
        self.active: List["NBCRequest"] = []
        self.progress = progress
        self.registered = False

    def add(self, req: "NBCRequest") -> None:
        self.active.append(req)
        if not self.registered:
            self.progress.register(self._sweep)
            self.registered = True

    def _sweep(self) -> int:
        events = 0
        for req in list(self.active):
            if req._advance():
                events += 1
            if req.complete:
                self.active.remove(req)
        if not self.active and self.registered:
            self.progress.unregister(self._sweep)
            self.registered = False
        return events


def _nbc_state(state) -> _PerRankNbcState:
    st = getattr(state, "_nbc", None)
    if st is None:
        st = _PerRankNbcState(state.progress)
        state._nbc = st
    return st


class NBCRequest(Request):
    """A compiled schedule being progressed (ref: NBC_Handle)."""

    def __init__(self, comm, rounds: List[List[Callable]],
                 on_complete: Optional[Callable] = None) -> None:
        super().__init__(comm.state.progress)
        self.comm = comm
        self._rounds = rounds
        self._ri = -1
        self._reqs: List[Request] = []
        self._on_complete = on_complete
        self._start_next_round()
        if not self.complete:
            _nbc_state(comm.state).add(self)

    def _start_next_round(self) -> None:
        while True:
            self._ri += 1
            if self._ri >= len(self._rounds):
                if self._on_complete is not None:
                    self._on_complete()
                self._complete()
                return
            self._reqs = []
            for thunk in self._rounds[self._ri]:
                r = thunk()
                if r is not None:
                    self._reqs.append(r)
            if self._reqs:
                return  # wait for this round's comms

    def _advance(self) -> bool:
        """One progress step; True if the schedule moved forward."""
        if self.complete:
            return False
        if all(r.complete for r in self._reqs):
            self._start_next_round()
            return True
        return False


# thunk builders --------------------------------------------------------------

def _send(comm, arrfn, dst: int, tag: int):
    """Deferred send: arrfn() evaluated at round start so earlier
    rounds' reductions are visible.  Safety against local mutation
    rests on the round barrier: a schedule never mutates an array in
    the same round that sends it, and send requests complete only
    after the convertor has packed the data."""
    def thunk():
        arr = np.ascontiguousarray(arrfn() if callable(arrfn) else arrfn)
        return comm.state.pml.isend(arr, arr.size, mpi_dtype_of(arr),
                                    dst, tag, comm)
    return thunk


def _recv(comm, view: np.ndarray, src: int, tag: int):
    def thunk():
        return comm.state.pml.irecv(view, view.size, mpi_dtype_of(view),
                                    src, tag, comm)
    return thunk


def _local(fn):
    def thunk():
        fn()
        return None
    return thunk


_zero = np.zeros(0, dtype=np.uint8)


# ---------------------------------------------------------------------------
# schedule builders (flat-array altitude, like coll/base algorithms)
# ---------------------------------------------------------------------------

def sched_barrier(comm, tag: int) -> List[List[Callable]]:
    """Dissemination barrier (ref: nbc_ibarrier.c)."""
    size, rank = comm.size, comm.rank
    rounds = []
    dist = 1
    while dist < size:
        to = (rank + dist) % size
        frm = (rank - dist + size) % size
        rounds.append([_recv(comm, np.empty(0, np.uint8), frm, tag),
                       _send(comm, _zero, to, tag)])
        dist <<= 1
    return rounds


def _binomial_children(rank: int, root: int, size: int):
    """vrank-shifted binomial tree (ref: coll_base_topo.c bmtree)."""
    vrank = (rank - root + size) % size
    children = []
    mask = 1
    while mask < size:
        if vrank & mask:
            parent = ((vrank & ~mask) + root) % size
            return parent, children
        if vrank + mask < size:
            children.append((vrank + mask + root) % size)
        mask <<= 1
    return None, children


def sched_bcast(comm, arr: np.ndarray, root: int, tag: int):
    """Binomial-tree bcast: recv round then send round."""
    parent, children = _binomial_children(comm.rank, root, comm.size)
    rounds: List[List[Callable]] = []
    if parent is not None:
        rounds.append([_recv(comm, arr, parent, tag)])
    if children:
        # children sorted high-mask-first send order matches recv rounds
        rounds.append([_send(comm, arr, c, tag) for c in children])
    return rounds


def sched_reduce(comm, sarr: np.ndarray, rarr: Optional[np.ndarray],
                 op: Op, root: int, tag: int):
    """Binomial fan-in for commutative ops; linear gather-at-root in
    rank order otherwise (preserves MPI's canonical reduction order)."""
    size, rank = comm.size, comm.rank
    if not op.commute:
        return _sched_reduce_linear(comm, sarr, rarr, op, root, tag)
    parent, children = _binomial_children(rank, root, size)
    acc = rarr if (rank == root and rarr is not None) else sarr.copy()
    if rank == root and rarr is not None:
        thunk_init = _local(lambda: acc.__setitem__(slice(None), sarr))
    else:
        thunk_init = None
    rounds: List[List[Callable]] = []
    if thunk_init is not None:
        rounds.append([thunk_init])
    tmps = {c: np.empty_like(sarr) for c in children}
    if children:
        rounds.append([_recv(comm, tmps[c], c, tag) for c in children])
        def reduce_all():
            for c in children:
                res = op.reduce(tmps[c], acc)
                acc[:] = res
        rounds.append([_local(reduce_all)])
    if parent is not None:
        rounds.append([_send(comm, lambda: acc, parent, tag)])
    return rounds


def _sched_reduce_linear(comm, sarr, rarr, op: Op, root: int, tag: int):
    size, rank = comm.size, comm.rank
    rounds: List[List[Callable]] = []
    if rank != root:
        rounds.append([_send(comm, sarr, root, tag)])
        return rounds
    tmps = [np.empty_like(sarr) if r != rank else None for r in range(size)]
    rounds.append([_recv(comm, tmps[r], r, tag)
                   for r in range(size) if r != rank])
    def reduce_ordered():
        # canonical left-associative order: ((buf0 op buf1) op buf2)...
        acc = (sarr if rank == 0 else tmps[0]).copy()
        for r in range(1, size):
            contrib = sarr if r == rank else tmps[r]
            acc = op.reduce(acc, contrib.copy())
        rarr[:] = acc
    rounds.append([_local(reduce_ordered)])
    return rounds


def sched_allreduce(comm, sarr: np.ndarray, rarr: np.ndarray, op: Op,
                    tag: int):
    """Recursive doubling on the power-of-two core; extra ranks fold
    into the core first and get the result at the end (ref:
    coll_base_allreduce.c:128 recursivedoubling)."""
    size, rank = comm.size, comm.rank
    rounds: List[List[Callable]] = []
    rounds.append([_local(lambda: rarr.__setitem__(slice(None), sarr))])
    if size == 1:
        return rounds
    pof2 = 1
    while pof2 * 2 <= size:
        pof2 *= 2
    rem = size - pof2
    if rank < 2 * rem:
        if rank % 2 == 0:
            rounds.append([_send(comm, lambda: rarr, rank + 1, tag)])
            newrank = -1
        else:
            tmp = np.empty_like(rarr)
            rounds.append([_recv(comm, tmp, rank - 1, tag)])
            rounds.append([_local(lambda t=tmp: rarr.__setitem__(
                slice(None), op.reduce(t, rarr)))])
            newrank = rank // 2
    else:
        newrank = rank - rem
    if newrank != -1:
        mask = 1
        while mask < pof2:
            newdst = newrank ^ mask
            dst = newdst * 2 + 1 if newdst < rem else newdst + rem
            tmp = np.empty_like(rarr)
            rounds.append([_recv(comm, tmp, dst, tag),
                           _send(comm, lambda: rarr, dst, tag)])
            if op.commute or dst < rank:
                rounds.append([_local(lambda t=tmp: rarr.__setitem__(
                    slice(None), op.reduce(t, rarr)))])
            else:
                # non-commutative: lower-rank data is the left operand
                rounds.append([_local(lambda t=tmp: rarr.__setitem__(
                    slice(None), op.reduce(rarr.copy(), t)))])
            mask <<= 1
    # return results to the folded-out ranks
    if rank < 2 * rem:
        if rank % 2 == 0:
            rounds.append([_recv(comm, rarr, rank + 1, tag)])
        else:
            rounds.append([_send(comm, lambda: rarr, rank - 1, tag)])
    return rounds


def sched_allgather(comm, sarr: np.ndarray, rarr: np.ndarray, bcount: int,
                    tag: int):
    """Ring allgather: P-1 rounds, pass blocks around (ref:
    coll_base_allgather.c ring)."""
    size, rank = comm.size, comm.rank
    blocks = rarr.reshape(size, bcount)
    rounds: List[List[Callable]] = []
    rounds.append([_local(lambda: blocks.__setitem__(rank, sarr))])
    right = (rank + 1) % size
    left = (rank - 1 + size) % size
    for step in range(size - 1):
        sblk = (rank - step + size) % size
        rblk = (rank - step - 1 + size) % size
        rounds.append([
            _recv(comm, blocks[rblk], left, tag),
            _send(comm, lambda b=sblk: blocks[b], right, tag)])
    return rounds


def sched_allgatherv(comm, sarr: np.ndarray, rarr: np.ndarray,
                     rcounts, displs, tag: int):
    size, rank = comm.size, comm.rank
    rounds: List[List[Callable]] = []
    def place_own():
        rarr[displs[rank]: displs[rank] + rcounts[rank]] = sarr
    rounds.append([_local(place_own)])
    right = (rank + 1) % size
    left = (rank - 1 + size) % size
    for step in range(size - 1):
        sblk = (rank - step + size) % size
        rblk = (rank - step - 1 + size) % size
        rounds.append([
            _recv(comm, rarr[displs[rblk]: displs[rblk] + rcounts[rblk]],
                  left, tag),
            _send(comm, lambda b=sblk: rarr[displs[b]: displs[b] + rcounts[b]],
                  right, tag)])
    return rounds


def sched_gather(comm, sarr, rarr, bcount: int, root: int, tag: int):
    size, rank = comm.size, comm.rank
    rounds: List[List[Callable]] = []
    if rank == root:
        blocks = rarr.reshape(size, bcount)
        rnd = [_recv(comm, blocks[r], r, tag)
               for r in range(size) if r != root]
        rounds.append([_local(lambda: blocks.__setitem__(root, sarr))] + rnd)
    else:
        rounds.append([_send(comm, sarr, root, tag)])
    return rounds


def sched_scatter(comm, sarr, rarr, bcount: int, root: int, tag: int):
    size, rank = comm.size, comm.rank
    rounds: List[List[Callable]] = []
    if rank == root:
        blocks = sarr.reshape(size, bcount)
        rnd = [_send(comm, blocks[r], r, tag)
               for r in range(size) if r != root]
        rounds.append([_local(lambda: rarr.__setitem__(slice(None),
                                                       blocks[root]))] + rnd)
    else:
        rounds.append([_recv(comm, rarr, root, tag)])
    return rounds


def sched_alltoall(comm, sarr, rarr, bcount: int, tag: int):
    """Pairwise exchange, one peer pair per round (ref:
    coll_base_alltoall.c:131 pairwise)."""
    size, rank = comm.size, comm.rank
    sb = sarr.reshape(size, bcount)
    rb = rarr.reshape(size, bcount)
    rounds: List[List[Callable]] = []
    rounds.append([_local(lambda: rb.__setitem__(rank, sb[rank]))])
    for step in range(1, size):
        to = (rank + step) % size
        frm = (rank - step + size) % size
        rounds.append([_recv(comm, rb[frm], frm, tag),
                       _send(comm, sb[to], to, tag)])
    return rounds


def sched_alltoallv(comm, sarr, scounts, sdispls, rarr, rcounts, rdispls,
                    tag: int):
    size, rank = comm.size, comm.rank
    rounds: List[List[Callable]] = []
    def own():
        rarr[rdispls[rank]: rdispls[rank] + rcounts[rank]] = \
            sarr[sdispls[rank]: sdispls[rank] + scounts[rank]]
    posts = [_local(own)]
    for step in range(1, size):
        to = (rank + step) % size
        frm = (rank - step + size) % size
        posts.append(_recv(
            comm, rarr[rdispls[frm]: rdispls[frm] + rcounts[frm]], frm, tag))
        posts.append(_send(
            comm, sarr[sdispls[to]: sdispls[to] + scounts[to]], to, tag))
    rounds.append(posts)
    return rounds


def sched_scan(comm, sarr, rarr, op: Op, tag: int, exclusive: bool):
    """Linear scan: recv partial from rank-1, combine, forward."""
    size, rank = comm.size, comm.rank
    rounds: List[List[Callable]] = []
    if not exclusive:
        rounds.append([_local(lambda: rarr.__setitem__(slice(None), sarr))])
    partial = np.empty_like(sarr)
    if rank > 0:
        rounds.append([_recv(comm, partial, rank - 1, tag)])
        if exclusive:
            rounds.append([_local(
                lambda: rarr.__setitem__(slice(None), partial))])
        else:
            rounds.append([_local(lambda: rarr.__setitem__(
                slice(None), op.reduce(partial, rarr)))])
    if rank < size - 1:
        def fwd():
            # forward the inclusive prefix over ranks 0..rank
            if rank == 0:
                return sarr
            return op.reduce(partial, sarr.copy())
        rounds.append([_send(comm, fwd, rank + 1, tag)])
    return rounds


def sched_seq(*scheds) -> List[List[Callable]]:
    """Concatenate schedules (round barrier between them)."""
    out: List[List[Callable]] = []
    for s in scheds:
        out.extend(s)
    return out


# ---------------------------------------------------------------------------
# the coll module: MPI buffer adaptation → schedules
# ---------------------------------------------------------------------------

class NbcModule(CollModule):
    name = "nbc"

    @staticmethod
    def _finish(*tbs):
        def done():
            for tb in tbs:
                if tb is not None:
                    tb.flush()
        return done

    # -- nonblocking device-array collectives ----------------------------
    # Surfaced here (the nbc engine is the nonblocking entry point of
    # the coll stack) but executed by coll/fusion: pending small device
    # payloads coalesce into one rendezvous and one launch per (op,
    # dtype) group instead of a round-based p2p schedule.  Lazy import:
    # fusion pulls coll/device, which this module must not load at
    # import time.

    def iallreduce_arr(self, comm, x, op):
        from ompi_tpu_torch.coll import fusion
        return fusion.iallreduce_arr(comm, x, op)

    def ibcast_arr(self, comm, x, root):
        from ompi_tpu_torch.coll import fusion
        return fusion.ibcast_arr(comm, x, root)

    def ibarrier(self, comm):
        return NBCRequest(comm, sched_barrier(comm, _nbc_tag(comm)))

    def ibcast(self, comm, buf, count, datatype, root):
        tb = typed(buf, count, datatype, writable=True)
        rounds = sched_bcast(comm, tb.arr, root, _nbc_tag(comm))
        fin = self._finish(tb if comm.rank != root else None)
        return NBCRequest(comm, rounds, fin)

    def ireduce(self, comm, sbuf, rbuf, count, datatype, op, root):
        rb = typed(rbuf, count, datatype, writable=True) \
            if comm.rank == root else None
        if sbuf is IN_PLACE:
            sarr = rb.arr.copy()
        else:
            sarr = typed(sbuf, count, datatype).arr
        rounds = sched_reduce(comm, sarr, rb.arr if rb else None, op, root,
                              _nbc_tag(comm))
        return NBCRequest(comm, rounds, self._finish(rb))

    def iallreduce(self, comm, sbuf, rbuf, count, datatype, op):
        rb = typed(rbuf, count, datatype, writable=True)
        sarr = rb.arr.copy() if sbuf is IN_PLACE \
            else typed(sbuf, count, datatype).arr
        rounds = sched_allreduce(comm, sarr, rb.arr, op, _nbc_tag(comm))
        return NBCRequest(comm, rounds, self._finish(rb))

    def iallgather(self, comm, sbuf, scount, sdt, rbuf, rcount, rdt):
        rb = typed(rbuf, rcount * comm.size, rdt, writable=True)
        if sbuf is IN_PLACE:
            bcount = rb.nprim // comm.size
            sarr = rb.arr.reshape(comm.size, bcount)[comm.rank].copy()
        else:
            sarr = typed(sbuf, scount, sdt).arr
        rounds = sched_allgather(comm, sarr, rb.arr,
                                 rb.nprim // comm.size, _nbc_tag(comm))
        return NBCRequest(comm, rounds, self._finish(rb))

    def iallgatherv(self, comm, sbuf, scount, sdt, rbuf, rcounts, displs,
                    rdt):
        total = max(d + c for d, c in zip(displs, rcounts))
        rb = typed(rbuf, total, rdt, writable=True)
        scale = rdt.size // rb.prim.itemsize
        pc = [c * scale for c in rcounts]
        pd = [d * scale for d in displs]
        if sbuf is IN_PLACE:
            sarr = rb.arr[pd[comm.rank]: pd[comm.rank] + pc[comm.rank]].copy()
        else:
            sarr = typed(sbuf, scount, sdt).arr
        rounds = sched_allgatherv(comm, sarr, rb.arr, pc, pd, _nbc_tag(comm))
        return NBCRequest(comm, rounds, self._finish(rb))

    def igatherv(self, comm, sbuf, scount, sdt, rbuf, rcounts, displs,
                 rdt, root):
        """Linear schedule with per-rank counts/displacements."""
        tag = _nbc_tag(comm)
        if comm.rank == root:
            total = max(d + c for d, c in zip(displs, rcounts))
            rb = typed(rbuf, total, rdt, writable=True)
            scale = rdt.size // rb.prim.itemsize
            pc = [c * scale for c in rcounts]
            pd = [d * scale for d in displs]
            sarr = rb.arr[pd[root]: pd[root] + pc[root]].copy() \
                if sbuf is IN_PLACE else typed(sbuf, scount, sdt).arr
            me = rb.arr[pd[root]: pd[root] + pc[root]]
            rnd = [_recv(comm, rb.arr[pd[r]: pd[r] + pc[r]], r, tag)
                   for r in range(comm.size) if r != root and pc[r]]
            rounds = [[_local(lambda: me.__setitem__(slice(None),
                                                     sarr))] + rnd]
            return NBCRequest(comm, rounds, self._finish(rb))
        sarr = typed(sbuf, scount, sdt).arr
        if sarr.size == 0:  # root skips zero-count recvs symmetrically
            return NBCRequest(comm, [[]])
        return NBCRequest(comm, [[_send(comm, sarr, root, tag)]])

    def iscatterv(self, comm, sbuf, scounts, displs, sdt, rbuf, rcount,
                  rdt, root):
        tag = _nbc_tag(comm)
        rb = typed(rbuf, rcount, rdt, writable=True)
        if comm.rank == root:
            total = max(d + c for d, c in zip(displs, scounts))
            sb = typed(sbuf, total, sdt)
            scale = sdt.size // sb.prim.itemsize
            pc = [c * scale for c in scounts]
            pd = [d * scale for d in displs]
            mine = sb.arr[pd[root]: pd[root] + pc[root]]
            rnd = [_send(comm, sb.arr[pd[r]: pd[r] + pc[r]], r, tag)
                   for r in range(comm.size) if r != root and pc[r]]
            rounds = [[_local(lambda: rb.arr.__setitem__(slice(None),
                                                         mine))] + rnd]
        elif rb.arr.size == 0:  # root skips zero-count sends
            rounds = [[]]
        else:
            rounds = [[_recv(comm, rb.arr, root, tag)]]
        return NBCRequest(comm, rounds, self._finish(rb))

    def igather(self, comm, sbuf, scount, sdt, rbuf, rcount, rdt, root):
        if comm.rank == root:
            rb = typed(rbuf, rcount * comm.size, rdt, writable=True)
            sarr = rb.arr.reshape(comm.size, -1)[comm.rank].copy() \
                if sbuf is IN_PLACE else typed(sbuf, scount, sdt).arr
            rounds = sched_gather(comm, sarr, rb.arr,
                                  rb.nprim // comm.size, root, _nbc_tag(comm))
            return NBCRequest(comm, rounds, self._finish(rb))
        sarr = typed(sbuf, scount, sdt).arr
        rounds = sched_gather(comm, sarr, None, 0, root, _nbc_tag(comm))
        return NBCRequest(comm, rounds)

    def iscatter(self, comm, sbuf, scount, sdt, rbuf, rcount, rdt, root):
        if comm.rank == root and rbuf is IN_PLACE:
            # root keeps its own block in place; only send to others
            sb = typed(sbuf, scount * comm.size, sdt)
            blocks = sb.arr.reshape(comm.size, sb.nprim // comm.size)
            tag = _nbc_tag(comm)
            rounds = [[_send(comm, blocks[r], r, tag)
                       for r in range(comm.size) if r != root]]
            return NBCRequest(comm, rounds)
        rb = typed(rbuf, rcount, rdt, writable=True)
        if comm.rank == root:
            sb = typed(sbuf, scount * comm.size, sdt)
            rounds = sched_scatter(comm, sb.arr, rb.arr,
                                   sb.nprim // comm.size, root,
                                   _nbc_tag(comm))
        else:
            rounds = sched_scatter(comm, None, rb.arr, rb.nprim, root,
                                   _nbc_tag(comm))
        return NBCRequest(comm, rounds, self._finish(rb))

    def ialltoall(self, comm, sbuf, scount, sdt, rbuf, rcount, rdt):
        rb = typed(rbuf, rcount * comm.size, rdt, writable=True)
        if sbuf is IN_PLACE:
            sarr = rb.arr.copy()
        else:
            sarr = typed(sbuf, scount * comm.size, sdt).arr
        rounds = sched_alltoall(comm, sarr, rb.arr, rb.nprim // comm.size,
                                _nbc_tag(comm))
        return NBCRequest(comm, rounds, self._finish(rb))

    def ialltoallv(self, comm, sbuf, scounts, sdispls, sdt, rbuf, rcounts,
                   rdispls, rdt):
        total = max(d + c for d, c in zip(rdispls, rcounts))
        rb = typed(rbuf, total, rdt, writable=True)
        rs = rdt.size // rb.prim.itemsize
        if sbuf is IN_PLACE:
            # send data and layout come from the receive buffer
            sarr = rb.arr.copy()
            scounts, sdispls, ss = rcounts, rdispls, rs
        else:
            stotal = max(d + c for d, c in zip(sdispls, scounts))
            sb = typed(sbuf, stotal, sdt)
            sarr = sb.arr
            ss = sdt.size // sb.prim.itemsize
        rounds = sched_alltoallv(
            comm, sarr, [c * ss for c in scounts],
            [d * ss for d in sdispls], rb.arr, [c * rs for c in rcounts],
            [d * rs for d in rdispls], _nbc_tag(comm))
        return NBCRequest(comm, rounds, self._finish(rb))

    def ireduce_scatter(self, comm, sbuf, rbuf, rcounts, datatype, op,
                        sdtype=None):
        """reduce-to-0 + scatterv, one schedule (ref: nbc's default)."""
        size, rank = comm.size, comm.rank
        total = sum(rcounts)
        rb = typed(rbuf, rcounts[rank], datatype, writable=True)
        sarr = typed(sbuf, total, sdtype or datatype).arr if sbuf is not \
            IN_PLACE else typed(rbuf, total, datatype).arr.copy()
        scale = datatype.size // rb.prim.itemsize
        pc = [c * scale for c in rcounts]
        pd = np.concatenate([[0], np.cumsum(pc)[:-1]]).tolist()
        tag = _nbc_tag(comm)
        acc = np.empty_like(sarr) if rank == 0 else None
        red = sched_reduce(comm, sarr, acc, op, 0, tag)
        if size == 1:
            rounds = red + [[_local(lambda: rb.arr.__setitem__(
                slice(None), sarr))]]
            return NBCRequest(comm, rounds, self._finish(rb))
        tag2 = _nbc_tag(comm)
        if rank == 0:
            scat = [[_local(lambda: rb.arr.__setitem__(
                slice(None), acc[pd[0]: pd[0] + pc[0]]))] +
                [_send(comm, lambda r=r: acc[pd[r]: pd[r] + pc[r]], r, tag2)
                 for r in range(1, size) if pc[r]]]
        else:
            scat = [[_recv(comm, rb.arr, 0, tag2)]] if pc[rank] else []
        return NBCRequest(comm, sched_seq(red, scat), self._finish(rb))

    def ireduce_scatter_block(self, comm, sbuf, rbuf, rcount, datatype, op):
        return self.ireduce_scatter(
            comm, sbuf, rbuf, [rcount] * comm.size, datatype, op)

    def iscan(self, comm, sbuf, rbuf, count, datatype, op):
        rb = typed(rbuf, count, datatype, writable=True)
        sarr = rb.arr.copy() if sbuf is IN_PLACE \
            else typed(sbuf, count, datatype).arr
        rounds = sched_scan(comm, sarr, rb.arr, op, _nbc_tag(comm), False)
        return NBCRequest(comm, rounds, self._finish(rb))

    def iexscan(self, comm, sbuf, rbuf, count, datatype, op):
        rb = typed(rbuf, count, datatype, writable=True)
        sarr = rb.arr.copy() if sbuf is IN_PLACE \
            else typed(sbuf, count, datatype).arr
        rounds = sched_scan(comm, sarr, rb.arr, op, _nbc_tag(comm), True)
        return NBCRequest(comm, rounds, self._finish(rb))


class NbcComponent(CollComponent):
    name = "nbc"
    priority = 20

    def comm_query(self, comm):
        return (self.priority, NbcModule())


coll_framework.add_component(NbcComponent())
