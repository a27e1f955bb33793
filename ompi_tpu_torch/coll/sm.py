"""coll/sm analog: single-meeting collectives for co-resident
thread-ranks.

Re-design of ompi/mca/coll/sm (ref: coll_sm_module.c:102,167 — ranks
on one node collect through a shared segment instead of exchanging
point-to-point messages).  Here the co-resident ranks are THREADS
of one process (a thread world, or the rank-threads of one app
shell), so the "shared segment" is literal shared memory: every
member deposits its buffer (reference) at the per-communicator
Rendezvous (coll/device's meeting machinery — device and host
collectives interleave safely because MPI orders collective calls
identically on every member; a host deposit carries no CUDA event, so
the meeting's stream fence takes its host branch), the last arriver
computes the result ONCE with vectorized numpy, and each member
copies its output out.  A p2p algorithm costs
O(size * log size) matched messages through the pml; this costs one
meeting — the dominant win for latency-bound small collectives in
hybrid launches.

Eligibility is comm-consistent: every member a local thread-rank
(fixed per comm, cached) and op.valid_for(dtype) (op/dtype match
across ranks by MPI).  Reductions fold in rank order — the
deterministic left fold of basic_linear — so results match the p2p
path bit-for-bit, non-commutative ops included.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ompi_tpu_torch.coll.buffers import IN_PLACE, typed
from ompi_tpu_torch.coll.device import _abort_check, meet
from ompi_tpu_torch.coll.framework import CollComponent, coll_framework
from ompi_tpu_torch.coll.tuned import TunedModule
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op.op import Op

_prio_var = registry.register(
    "coll", "sm", "priority", 60, int,
    help="Selection priority of the shared-memory (thread-rank) "
         "collective component (below coll/tpu+hbm, above tuned)")


class SmCollModule(TunedModule):
    """Rendezvous-backed host-buffer collectives; p2p fallback via
    the tuned superclass for ineligible calls."""

    name = "sm"

    def _sm_ok(self, comm) -> bool:
        cached = comm.__dict__.get("_sm_all_local")
        if cached is None:
            world = getattr(comm.state.rte, "world", None)
            cached = bool(
                world is not None and comm.size > 1
                and all(world.is_local(g) for g in comm.group))
            comm.__dict__["_sm_all_local"] = cached
        return cached

    def _meet(self, comm, value, fn):
        return meet(comm, value, fn, _abort_check(comm))

    # -- collectives -----------------------------------------------------
    def barrier(self, comm) -> None:
        if comm.size == 1:
            return
        if not self._sm_ok(comm):
            return super().barrier(comm)
        self._meet(comm, None, lambda slots: [None] * comm.size)

    def bcast(self, comm, buf, count, datatype, root) -> None:
        if comm.size == 1 or count == 0:
            return
        if not self._sm_ok(comm):
            return super().bcast(comm, buf, count, datatype, root)
        tb = typed(buf, count, datatype, writable=True)

        def fn(slots):
            # copy ONCE at the meeting: the root may legally mutate
            # its buffer the moment its own call returns, while slow
            # readers are still copying out
            data = np.array(slots[root], copy=True)
            return [data] * comm.size

        out = self._meet(comm, tb.arr, fn)
        if comm.rank != root:
            tb.arr[:] = out
            tb.flush()

    def _fold(self, slots: List[np.ndarray], op: Op) -> np.ndarray:
        # rank-order left fold (basic_linear order: buf_0 OP buf_1 ...)
        acc = slots[0]
        for s in slots[1:]:
            acc = op.reduce(acc, s)
        if acc is slots[0]:
            acc = np.array(acc, copy=True)
        return acc

    def allreduce(self, comm, sbuf, rbuf, count, datatype,
                  op: Op) -> None:
        rb = typed(rbuf, count, datatype, writable=True)
        sarr = rb.arr.copy() if sbuf is IN_PLACE \
            else typed(sbuf, count, datatype).arr
        if comm.size == 1:
            rb.arr[:] = sarr
            rb.flush()
            return
        if not self._sm_ok(comm) or not op.valid_for(sarr.dtype) \
                or count == 0:
            return super().allreduce(comm, sbuf, rbuf, count,
                                     datatype, op)
        out = self._meet(
            comm, sarr,
            lambda slots: [self._fold(slots, op)] * comm.size)
        rb.arr[:] = out
        rb.flush()

    def reduce(self, comm, sbuf, rbuf, count, datatype, op: Op,
               root) -> None:
        rb = typed(rbuf, count, datatype, writable=True) \
            if comm.rank == root else None
        if sbuf is IN_PLACE:
            sarr = rb.arr.copy()
        else:
            sarr = typed(sbuf, count, datatype).arr
        if comm.size == 1:
            rb.arr[:] = sarr
            rb.flush()
            return
        if not self._sm_ok(comm) or not op.valid_for(sarr.dtype) \
                or count == 0:
            return super().reduce(comm, sbuf, rbuf, count, datatype,
                                  op, root)
        out = self._meet(
            comm, sarr,
            lambda slots: [self._fold(slots, op)] * comm.size)
        if rb is not None:
            rb.arr[:] = out
            rb.flush()

    def allgather(self, comm, sbuf, scount, sdtype, rbuf, rcount,
                  rdtype) -> None:
        if not self._sm_ok(comm):
            return super().allgather(comm, sbuf, scount, sdtype,
                                     rbuf, rcount, rdtype)
        rb = typed(rbuf, rcount * comm.size, rdtype, writable=True)
        n = rb.arr.size // comm.size
        if sbuf is IN_PLACE:
            sarr = rb.arr[comm.rank * n:(comm.rank + 1) * n].copy()
        else:
            sarr = typed(sbuf, scount, sdtype).arr

        def fn(slots):
            data = np.concatenate([np.asarray(s).reshape(-1)
                                   for s in slots])
            return [data] * comm.size

        out = self._meet(comm, sarr, fn)
        rb.arr[:] = out
        rb.flush()

    def alltoall(self, comm, sbuf, scount, sdtype, rbuf, rcount,
                 rdtype) -> None:
        if not self._sm_ok(comm) or sbuf is IN_PLACE:
            return super().alltoall(comm, sbuf, scount, sdtype,
                                    rbuf, rcount, rdtype)
        rb = typed(rbuf, rcount * comm.size, rdtype, writable=True)
        sarr = typed(sbuf, scount * comm.size, sdtype).arr
        n = rb.arr.size // comm.size

        def fn(slots):
            grid = np.stack([np.asarray(s).reshape(comm.size, n)
                             for s in slots])      # (src, dst, n)
            swapped = np.swapaxes(grid, 0, 1)      # (dst, src, n)
            return [swapped[d].reshape(-1).copy()
                    for d in range(comm.size)]

        out = self._meet(comm, sarr, fn)
        rb.arr[:] = out
        rb.flush()


class SmComponent(CollComponent):
    name = "sm"

    @property
    def priority(self) -> int:
        return _prio_var.value

    def comm_query(self, comm):
        world = getattr(comm.state.rte, "world", None)
        if world is None:
            return None
        return (self.priority, SmCollModule())


coll_framework.add_component(SmComponent())
