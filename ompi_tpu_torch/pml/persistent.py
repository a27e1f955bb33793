"""Persistent requests + buffered-send machinery.

Port of the reference's pml/persistent.py, a re-design of the reference's persistent request path (ref:
ompi/mpi/c/send_init.c, recv_init.c, start.c, startall.c — pml ob1
reuses one request descriptor across starts) and the attached-buffer
Bsend engine (ref: ompi/mpi/c/buffer_attach.c, bsend.c;
ompi/runtime/ompi_mpi_preconnect.c-adjacent bsend allocator in
ompi/mca/pml/base/pml_base_bsend.c: user attaches one buffer, sends
carve regions, regions free on completion).

A persistent request here is a restartable wrapper: each start()
launches a fresh pml isend/irecv on the stored argument set; wait/
test delegate to the active inner request.  That matches the MPI
object model (INACTIVE → start → ACTIVE → completion → INACTIVE)
without complicating the ob1 fast path.

Host buffers only, as every pt2pt call of the port: a tensor (on a
card or not) is refused where the communicator parses the buffer
spec, so ``Send_init`` of a card tensor raises as ``Send`` does.
Device payloads take ``send_arr``/``recv_arr`` (btl/tpu).
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from ompi_tpu_torch.pml.request import Request, Status


class PersistentRequest(Request):
    """MPI_Send_init / MPI_Recv_init result; start() re-arms it."""

    KIND_SEND = "send"
    KIND_RECV = "recv"

    def __init__(self, comm, kind: str, buf, count, datatype, peer: int,
                 tag: int, mode=None) -> None:
        super().__init__(comm.state.progress)
        self.persistent = True
        self.active = False
        self.complete = True     # inactive: wait() returns immediately
        self._comm = comm
        self._kind = kind
        self._args = (buf, count, datatype, peer, tag)
        self._mode = mode
        self._inner: Optional[Request] = None

    def start(self) -> "PersistentRequest":
        if self.active and self._inner is not None \
                and not self._inner.complete:
            raise RuntimeError(
                "MPI_Start on an active persistent request")
        buf, count, datatype, peer, tag = self._args
        pml = self._comm.state.pml
        if self._kind == self.KIND_SEND:
            if self._mode == "buffered":
                self._inner = ibsend(self._comm, buf, count, datatype,
                                     peer, tag)
            elif self._mode is not None:
                self._inner = pml.isend(buf, count, datatype, peer, tag,
                                        self._comm, self._mode)
            else:
                self._inner = pml.isend(buf, count, datatype, peer, tag,
                                        self._comm)
        else:
            self._inner = pml.irecv(buf, count, datatype, peer, tag,
                                    self._comm)
        self.active = True
        self.complete = False
        return self

    # delegate completion to the inner request; on completion the
    # persistent request becomes inactive-but-complete (restartable)
    def _sync_inner(self) -> None:
        if self._inner is not None and self._inner.complete \
                and not self.complete:
            self.status = self._inner.status
            self.complete = True
            self.active = False

    def test(self) -> bool:
        if self._inner is not None and not self._inner.complete:
            self._inner.test()
        self._sync_inner()
        return self.complete

    def wait(self, timeout: Optional[float] = None) -> Status:
        if self._inner is not None and not self.complete:
            self._inner.wait(timeout)
            self._sync_inner()
        return self.status

    def cancel(self) -> None:
        if self._inner is not None:
            self._inner.cancel()

    def free(self) -> None:
        self._inner = None


def start_all(reqs: List[PersistentRequest]) -> None:
    """MPI_Startall (ref: ompi/mpi/c/startall.c)."""
    for r in reqs:
        r.start()


# ---------------------------------------------------------------------------
# buffered sends (MPI_Buffer_attach / MPI_Bsend)
# ---------------------------------------------------------------------------

BSEND_OVERHEAD = 64  # per-message bookkeeping allowance (MPI_BSEND_OVERHEAD)


class BsendBuffer:
    """The single attached buffer; regions are carved per Bsend and
    recycled when the underlying send completes (swept on demand,
    like pml_base_bsend's allocator)."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._in_use = 0
        self._pending: List[tuple] = []  # (nbytes, request)
        self._lock = threading.Lock()

    def _sweep(self) -> None:
        done = [(n, r) for n, r in self._pending if r.complete]
        for item in done:
            self._pending.remove(item)
            self._in_use -= item[0]

    def alloc(self, nbytes: int, progress) -> bool:
        with self._lock:
            self._sweep()
            total = nbytes + BSEND_OVERHEAD
            if self._in_use + total > self.capacity:
                # one progress push, then retry once — completions may
                # be sitting unswept
                progress.progress()
                self._sweep()
                if self._in_use + total > self.capacity:
                    return False
            self._in_use += total
            return True

    def record(self, nbytes: int, req) -> None:
        with self._lock:
            self._pending.append((nbytes + BSEND_OVERHEAD, req))

    def release(self, nbytes: int) -> None:
        """Back out a reservation whose send never launched."""
        with self._lock:
            self._in_use -= nbytes + BSEND_OVERHEAD

    def drain(self) -> None:
        """Block until every buffered send completes (detach rule)."""
        while True:
            with self._lock:
                self._sweep()
                pending = list(self._pending)
            if not pending:
                return
            pending[0][1].wait()


def attach_buffer(state, size_or_buf) -> None:
    """MPI_Buffer_attach: one buffer per process (rank)."""
    if getattr(state, "bsend_buffer", None) is not None:
        raise RuntimeError("a bsend buffer is already attached "
                           "(MPI_ERR_BUFFER)")
    size = size_or_buf if isinstance(size_or_buf, int) \
        else np.asarray(size_or_buf).nbytes
    state.bsend_buffer = BsendBuffer(size)


def detach_buffer(state) -> int:
    """MPI_Buffer_detach: blocks until pending buffered sends drain."""
    buf = getattr(state, "bsend_buffer", None)
    if buf is None:
        raise RuntimeError("no bsend buffer attached (MPI_ERR_BUFFER)")
    buf.drain()
    state.bsend_buffer = None
    return buf.capacity


def ibsend(comm, buf, count, datatype, dst: int, tag: int) -> Request:
    """Copy into the attached buffer, then a normal isend of the copy
    — the user buffer is reusable the moment this returns."""
    from ompi_tpu_torch.coll.buffers import typed

    state = comm.state
    bb = getattr(state, "bsend_buffer", None)
    if bb is None:
        raise RuntimeError("MPI_Bsend without an attached buffer "
                           "(MPI_ERR_BUFFER)")
    tb = typed(buf, count, datatype)
    nbytes = tb.arr.nbytes
    if not bb.alloc(nbytes, state.progress):
        raise RuntimeError(
            f"bsend buffer exhausted: need {nbytes + BSEND_OVERHEAD} "
            f"bytes (MPI_ERR_BUFFER)")
    # typed() already packed strided/derived buffers into a fresh
    # array; only a zero-copy contiguous view needs the defensive copy
    copy = tb.arr if tb._copied else np.array(tb.arr, copy=True)
    from ompi_tpu_torch.coll.buffers import mpi_dtype_of
    try:
        req = state.pml.isend(copy, copy.size, mpi_dtype_of(copy), dst,
                              tag, comm)
    except BaseException:
        bb.release(nbytes)  # the reservation would otherwise leak
        raise
    bb.record(nbytes, req)
    return req


def bsend(comm, buf, count, datatype, dst: int, tag: int) -> None:
    ibsend(comm, buf, count, datatype, dst, tag)
    # MPI_Bsend returns once the message is buffered — it already is
