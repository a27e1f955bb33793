"""One-sided communication (MPI-3 RMA windows): the host AM window.

Port of the reference package's osc/window.py (ref: ompi/mca/osc/pt2pt
active-message protocol; osc/rdma lock algorithms osc_rdma_lock.h:18-49;
API surface ompi/mpi/c/put.c:81, win.c).  Every RMA op is an eager
control message (+payload) on a *dup'ed* communicator, applied by the
target inside its progress loop.  This window is the pt2pt component
and the base class of the device window (osc/device.py), whose lock,
unlock and PSCW control rides the same AM engine.

Completion leans on the pml's per-(src,dst) FIFO ordering:
- UNLOCK/FLUSH acks are sent by the target after processing, so the
  ack proves every earlier op from that origin was applied;
- PSCW COMPLETE messages arrive after all the origin's ops, so
  Win_wait just counts COMPLETEs;
- fence exchanges per-target op counts (alltoall) and waits until the
  cumulative applied counter reaches the cumulative expectation (the
  osc/pt2pt fence algorithm).

Atomicity of accumulate/fetch-ops comes free: the AM handler applies
messages serially in the target's progress loop.

Window memory is host memory: a contiguous numpy array, or a tensor on
the CPU (the window then works on its memory in place).  A card tensor
is refused: it belongs to the device window, and nothing of it is
staged through the host here.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import errhandler as _eh
from ompi_tpu_torch import obs as _obs
from ompi_tpu_torch import ft_inject
from ompi_tpu_torch.datatype import engine as dtmod
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as opmod

# message types
(PUT, GET, ACC, GET_ACC, CAS, LOCK, UNLOCK, FLUSH, PSCW_COMPLETE,
 PSCW_POST) = range(1, 11)

# reserved tags on the window's dup'ed comm
T_CTRL = -451
T_DATA = -452
_REPLY_BASE = -500
_REPLY_SPAN = 1000

LOCK_SHARED = 1
LOCK_EXCLUSIVE = 2

HDR_N = 10  # int64 header words: [mtype, origin, disp, count, dtnum,
#             opcode, reply_tag, payload_bytes, extra, reserved]

# wire op table (index = wire opcode)
_WIRE_OPS: List[opmod.Op] = [
    opmod.SUM, opmod.PROD, opmod.MAX, opmod.MIN, opmod.BAND, opmod.BOR,
    opmod.BXOR, opmod.LAND, opmod.LOR, opmod.LXOR, opmod.MAXLOC,
    opmod.MINLOC, opmod.REPLACE, opmod.NO_OP,
]
_OP_CODE = {id(op): i for i, op in enumerate(_WIRE_OPS)}

# numpy dtype <-> wire code (dtype.num is numpy-internal; use our own)
_WIRE_DTYPES = [np.dtype(t) for t in (
    np.uint8, np.int8, np.int16, np.uint16, np.int32, np.uint32,
    np.int64, np.uint64, np.float32, np.float64, np.complex64,
    np.complex128, np.bool_)]
_DT_CODE = {dt: i for i, dt in enumerate(_WIRE_DTYPES)}


# osc pvar surface, shared by BOTH components (pt2pt and device):
# band-scoped (ompi_tpu_torch/obs), so resident sessions get exact
# per-session attribution.
pv_puts = _obs.scoped_pvar(
    "osc", "", "puts", help="RMA put/rput operations issued")
pv_gets = _obs.scoped_pvar(
    "osc", "", "gets", help="RMA get/rget operations issued")
pv_accs = _obs.scoped_pvar(
    "osc", "", "accs",
    help="RMA accumulate/get_accumulate/fetch_and_op operations issued")
pv_cas = _obs.scoped_pvar(
    "osc", "", "cas", help="RMA compare_and_swap operations issued")
pv_bytes_put = _obs.scoped_pvar(
    "osc", "", "bytes_put", help="Origin bytes moved by put/rput")
pv_bytes_got = _obs.scoped_pvar(
    "osc", "", "bytes_got", help="Origin bytes moved by get/rget")
pv_lock_wait = registry.register_pvar(
    "osc", "", "lock_wait_us", var_class="highwatermark",
    help="Worst time (us) an origin waited for a passive-target lock "
         "grant")
_pv_lock = threading.Lock()  # pv_lock_wait's read-modify-write


def bump(pv: _obs.ScopedPvar, n: int = 1) -> None:
    """Add ``n`` to a scoped osc counter, in the calling rank's band."""
    pv.add(n, _obs.current_band())


def _op_code(op: opmod.Op) -> int:
    code = _OP_CODE.get(id(op))
    if code is None:
        raise ValueError(f"op {op} not supported on RMA windows "
                         "(user-defined ops are not addressable on the wire)")
    return code


def host_array(arr, what: str) -> np.ndarray:
    """``arr`` as a numpy array over the same memory where it is a CPU
    tensor; a card tensor raises (the host window stages nothing of a
    card through the host)."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise NotImplementedError(
                f"the host (pt2pt) RMA window takes host buffers; {what} "
                f"is a tensor on {arr.device} (use the device window: a "
                "comm whose ranks own distinct devices)")
        return arr.detach().numpy()
    return arr


class _Pending:
    """An incoming message whose payload recv is in flight."""

    __slots__ = ("hdr", "src", "buf", "req")

    def __init__(self, hdr, src, buf, req) -> None:
        self.hdr = hdr
        self.src = src
        self.buf = buf
        self.req = req


class Window:
    """MPI_Win over a local memory region (ref: ompi/win/win.c)."""

    def __init__(self, comm, memory, disp_unit: int = 1, name: str = "",
                 info=None) -> None:
        if memory is None:
            memory = np.zeros(0, dtype=np.uint8)
        arr = host_array(memory, "window memory")
        if not (isinstance(arr, np.ndarray) and arr.flags.c_contiguous):
            raise ValueError("window memory must be a contiguous ndarray")
        base = comm.dup(name or f"win-{id(self):x}")
        self.comm = base
        self.rank = base.rank
        self.size = base.size
        self.errhandler = _eh.ERRORS_RETURN
        self.attrs = {}
        self.info = info
        self.state = comm.state  # errhandler dispatch needs the rte
        self._dynamic = False
        self._attached: List[Tuple[int, np.ndarray]] = []
        self._mem = arr.reshape(-1).view(np.uint8)
        self.memory = memory
        self.disp_unit = disp_unit
        # AM engine state
        self._hdr_buf = np.empty(HDR_N, dtype=np.int64)
        self._hdr_req = None
        self._pending: Optional[_Pending] = None
        self._applied_total = 0
        self._expected_total = 0
        self._pscw_complete: Dict[int, int] = {}
        self._pscw_posted: Dict[int, int] = {}
        # lock state (target side)
        self._lock_mode = 0
        self._lock_holders: set = set()
        self._lock_queue: Deque[Tuple[int, int, int]] = deque()
        # origin-side epoch tracking
        self._ops_sent = np.zeros(self.size, dtype=np.int64)
        self._out_reqs: List[Any] = []
        self._reply_ctr = 0
        self._post_group: Optional[List[int]] = None
        self._start_group: Optional[List[int]] = None
        self._freed = False
        self._progress = base.state.progress
        self._inj = ft_inject.rma_injector(base.rank)
        self._post_hdr_recv()
        self._progress.register(self._am_progress)
        base.Barrier()  # window exists everywhere before any op

    # -- wire helpers ----------------------------------------------------

    def _pml(self):
        return self.comm.state.pml

    def _post_hdr_recv(self) -> None:
        self._hdr_req = self._pml().irecv(
            self._hdr_buf, HDR_N, dtmod.INT64_T, -1, T_CTRL, self.comm)

    def _send_hdr(self, target: int, mtype: int, disp: int = 0,
                  count: int = 0, dtnum: int = 0, opcode: int = 0,
                  reply_tag: int = 0, payload: Optional[np.ndarray] = None,
                  extra: int = 0) -> None:
        nbytes = 0 if payload is None else payload.nbytes
        hdr = np.array([mtype, self.rank, disp, count, dtnum, opcode,
                        reply_tag, nbytes, extra, 0], dtype=np.int64)
        self._out_reqs.append(self._pml().isend(
            hdr, HDR_N, dtmod.INT64_T, target, T_CTRL, self.comm))
        if payload is not None and nbytes:
            pb = np.ascontiguousarray(payload).view(np.uint8).reshape(-1)
            self._out_reqs.append(self._pml().isend(
                pb, pb.size, dtmod.BYTE, target, T_DATA, self.comm))

    def _new_reply_tag(self) -> int:
        self._reply_ctr += 1
        return _REPLY_BASE - (self._reply_ctr % _REPLY_SPAN)

    def _recv_reply(self, nbytes: int, src: int, tag: int):
        buf = np.empty(max(nbytes, 0), dtype=np.uint8)
        req = self._pml().irecv(buf, buf.size, dtmod.BYTE, src, tag,
                                self.comm)
        return buf, req

    # -- target-side apply ----------------------------------------------

    def _am_progress(self) -> int:
        events = 0
        while True:
            if self._pending is not None:
                if not self._pending.req.complete:
                    return events
                p, self._pending = self._pending, None
                self._apply(p.hdr, p.src, p.buf)
                self._post_hdr_recv()
                events += 1
                continue
            if self._hdr_req is None or not self._hdr_req.complete:
                return events
            if self._hdr_req.status.error:
                # a peer died while the wildcard header receive was
                # parked (ulfm_sweep error-completes it, buffer
                # untouched): the window cannot make progress until
                # recovery frees or abandons it — park instead of
                # parsing a zeroed header as an RMA message
                self._hdr_req = None
                return events
            hdr = self._hdr_buf.copy()
            src = self._hdr_req.status.source
            self._hdr_req = None
            nbytes = int(hdr[7])
            if nbytes:
                buf, req = self._recv_reply(nbytes, src, T_DATA)
                self._pending = _Pending(hdr, src, buf, req)
                continue
            self._apply(hdr, src, None)
            self._post_hdr_recv()
            events += 1

    def _region(self, disp: int, count: int, dtnum: int) -> np.ndarray:
        dt = _WIRE_DTYPES[dtnum]
        need = count * dt.itemsize
        if self._dynamic:
            # dynamic windows (ref: osc MPI_Win_create_dynamic):
            # disp is the target-side ABSOLUTE address (from
            # MPI_Get_address); resolve against attached regions
            for base, arr in self._attached:
                if base <= disp and disp + need <= base + arr.nbytes:
                    off = disp - base
                    return arr.reshape(-1).view(np.uint8)[
                        off:off + need].view(dt)
            raise ValueError(
                f"RMA at address {disp} hits no attached region "
                "(MPI_ERR_RMA_RANGE)")
        off = disp * self.disp_unit
        view = self._mem[off: off + need]
        return view.view(dt)

    # -- dynamic windows (ref: ompi/mpi/c/win_create_dynamic.c) ---------
    def attach(self, memory: np.ndarray) -> None:
        if not self._dynamic:
            raise ValueError("attach on a non-dynamic window "
                             "(MPI_ERR_RMA_ATTACH)")
        if not (isinstance(memory, np.ndarray)
                and memory.flags.c_contiguous):
            # a non-contiguous view would make _region's flat view a
            # COPY and remote stores would vanish silently
            raise ValueError("attached memory must be a contiguous "
                             "ndarray (MPI_ERR_RMA_ATTACH)")
        self._attached.append((memory.ctypes.data, memory))

    def detach(self, memory: np.ndarray) -> None:
        base = memory.ctypes.data
        self._attached = [(b, a) for b, a in self._attached
                          if b != base]

    def _apply(self, hdr: np.ndarray, src: int,
               payload: Optional[np.ndarray]) -> None:
        if self._inj is not None:
            d = self._inj.maybe_delay()
            if d:
                time.sleep(d)  # ft_inject rma_delay: slow AM apply
        mtype = int(hdr[0])
        origin, disp, count = int(hdr[1]), int(hdr[2]), int(hdr[3])
        dtnum, opcode = int(hdr[4]), int(hdr[5])
        reply_tag = int(hdr[6])
        if payload is None and mtype in (PUT, ACC, GET_ACC, CAS):
            payload = np.empty(0, dtype=np.uint8)  # zero-count op
        if mtype == PUT:
            region = self._region(disp, count, dtnum)
            region[:] = payload.view(_WIRE_DTYPES[dtnum])
            self._applied_total += 1
        elif mtype == GET:
            region = self._region(disp, count, dtnum)
            data = np.ascontiguousarray(region).view(np.uint8).reshape(-1)
            self._pml().isend(data.copy(), data.size, dtmod.BYTE, origin,
                              reply_tag, self.comm)
            self._applied_total += 1
        elif mtype == ACC:
            region = self._region(disp, count, dtnum)
            incoming = payload.view(_WIRE_DTYPES[dtnum])
            op = _WIRE_OPS[opcode]
            region[:] = op.reduce(incoming, region.copy())
            self._applied_total += 1
        elif mtype == GET_ACC:
            region = self._region(disp, count, dtnum)
            old = np.ascontiguousarray(region).copy()
            op = _WIRE_OPS[opcode]
            incoming = payload.view(_WIRE_DTYPES[dtnum])
            region[:] = op.reduce(incoming, region.copy())
            ob = old.view(np.uint8).reshape(-1)
            self._pml().isend(ob, ob.size, dtmod.BYTE, origin, reply_tag,
                              self.comm)
            self._applied_total += 1
        elif mtype == CAS:
            region = self._region(disp, 1, dtnum)
            dt = _WIRE_DTYPES[dtnum]
            cmp_val = payload[: dt.itemsize].view(dt)
            new_val = payload[dt.itemsize:].view(dt)
            old = region.copy()
            if old[0] == cmp_val[0]:
                region[0] = new_val[0]
            ob = old.view(np.uint8).reshape(-1)
            self._pml().isend(ob, ob.size, dtmod.BYTE, origin, reply_tag,
                              self.comm)
            self._applied_total += 1
        elif mtype == LOCK:
            self._lock_request(origin, opcode, reply_tag)
        elif mtype == UNLOCK:
            self._unlock_request(origin, reply_tag)
        elif mtype == FLUSH:
            # FIFO ordering: everything the origin sent before this
            # flush has been applied already — ack immediately
            self._pml().isend(np.zeros(0, np.uint8), 0, dtmod.BYTE,
                              origin, reply_tag, self.comm)
        elif mtype == PSCW_COMPLETE:
            self._pscw_complete[origin] = \
                self._pscw_complete.get(origin, 0) + 1
        elif mtype == PSCW_POST:
            self._pscw_posted[origin] = \
                self._pscw_posted.get(origin, 0) + 1
        else:
            raise RuntimeError(f"bad RMA message type {mtype}")

    # -- target-side lock service (ref: osc_rdma_lock.h queueing) --------

    def _grant(self, origin: int, reply_tag: int) -> None:
        self._pml().isend(np.zeros(0, np.uint8), 0, dtmod.BYTE, origin,
                          reply_tag, self.comm)

    def _lock_request(self, origin: int, mode: int, reply_tag: int) -> None:
        if mode == LOCK_SHARED:
            if self._lock_mode != LOCK_EXCLUSIVE and not self._lock_queue:
                self._lock_mode = LOCK_SHARED
                self._lock_holders.add(origin)
                self._grant(origin, reply_tag)
                return
        else:
            if self._lock_mode == 0:
                self._lock_mode = LOCK_EXCLUSIVE
                self._lock_holders.add(origin)
                self._grant(origin, reply_tag)
                return
        self._lock_queue.append((origin, mode, reply_tag))

    def _unlock_request(self, origin: int, reply_tag: int) -> None:
        self._lock_holders.discard(origin)
        if not self._lock_holders:
            self._lock_mode = 0
        self._grant(origin, reply_tag)  # unlock ack
        # grant waiters: one exclusive, or a run of shareds
        while self._lock_queue:
            o, m, rt = self._lock_queue[0]
            if m == LOCK_EXCLUSIVE:
                if self._lock_mode == 0:
                    self._lock_queue.popleft()
                    self._lock_mode = LOCK_EXCLUSIVE
                    self._lock_holders.add(o)
                    self._grant(o, rt)
                break
            if self._lock_mode == LOCK_EXCLUSIVE:
                break
            self._lock_queue.popleft()
            self._lock_mode = LOCK_SHARED
            self._lock_holders.add(o)
            self._grant(o, rt)

    # -- origin-side ops -------------------------------------------------

    @staticmethod
    def _as_wire(arr) -> Tuple[np.ndarray, int, int]:
        a = np.ascontiguousarray(host_array(arr, "the origin buffer"))
        code = _DT_CODE.get(a.dtype)
        if code is None:
            raise TypeError(f"dtype {a.dtype} not supported on windows")
        return a, a.size, code

    def _check_target(self, target: int) -> None:
        if not 0 <= target < self.size:
            raise ValueError(f"bad target rank {target}")

    def put(self, arr, target: int, disp: int = 0) -> None:
        self._check_target(target)
        a, count, code = self._as_wire(arr)
        self._send_hdr(target, PUT, disp, count, code, payload=a)
        self._ops_sent[target] += 1
        bump(pv_puts)
        bump(pv_bytes_put, a.nbytes)

    def get(self, arr, target: int, disp: int = 0) -> None:
        """Fills `arr` (completes before return — stronger than MPI
        requires; rget gives the deferred form)."""
        self._wait_req(self.rget(arr, target, disp))

    def rget(self, arr, target: int, disp: int = 0):
        self._check_target(target)
        arr = host_array(arr, "the get buffer")
        if not (isinstance(arr, np.ndarray) and arr.flags.c_contiguous):
            raise ValueError("get target must be a contiguous ndarray")
        code = _DT_CODE[arr.dtype]
        tag = self._new_reply_tag()
        buf = arr.view(np.uint8).reshape(-1)
        req = self._pml().irecv(buf, buf.size, dtmod.BYTE, target, tag,
                                self.comm)
        self._send_hdr(target, GET, disp, arr.size, code, reply_tag=tag)
        self._ops_sent[target] += 1
        self._out_reqs.append(req)
        bump(pv_gets)
        bump(pv_bytes_got, arr.nbytes)
        return req

    def accumulate(self, arr, target: int, disp: int = 0,
                   op: opmod.Op = opmod.SUM) -> None:
        self._check_target(target)
        a, count, code = self._as_wire(arr)
        self._send_hdr(target, ACC, disp, count, code, _op_code(op),
                       payload=a)
        self._ops_sent[target] += 1
        bump(pv_accs)

    # request-form RMA (ref: ompi/mpi/c/rput.c, raccumulate.c): the AM
    # payload is snapshotted at issue, so local completion is
    # immediate — the returned request is born complete (stronger than
    # MPI requires; remote completion still needs flush/unlock)
    def rput(self, arr, target: int, disp: int = 0):
        from ompi_tpu_torch.pml.request import CompletedRequest
        self.put(arr, target, disp)
        return CompletedRequest(self._progress)

    def raccumulate(self, arr, target: int, disp: int = 0,
                    op: opmod.Op = opmod.SUM):
        from ompi_tpu_torch.pml.request import CompletedRequest
        self.accumulate(arr, target, disp, op)
        return CompletedRequest(self._progress)

    def rget_accumulate(self, arr, result, target: int,
                        disp: int = 0, op: opmod.Op = opmod.SUM):
        """Returns the reply request (completes when `result` holds
        the pre-accumulate target data)."""
        self._check_target(target)
        a, count, code = self._as_wire(arr)
        result = host_array(result, "the result buffer")
        tag = self._new_reply_tag()
        rbuf = result.view(np.uint8).reshape(-1)
        req = self._pml().irecv(rbuf, rbuf.size, dtmod.BYTE, target, tag,
                                self.comm)
        self._send_hdr(target, GET_ACC, disp, count, code, _op_code(op),
                       reply_tag=tag, payload=a)
        self._ops_sent[target] += 1
        bump(pv_accs)
        return req

    def get_accumulate(self, arr, result, target: int,
                       disp: int = 0, op: opmod.Op = opmod.SUM) -> None:
        self._wait_req(self.rget_accumulate(arr, result, target, disp, op))

    def fetch_and_op(self, value, result, target: int,
                     disp: int = 0, op: opmod.Op = opmod.SUM) -> None:
        result = host_array(result, "the result buffer")
        self.get_accumulate(np.atleast_1d(np.asarray(
            value, dtype=result.dtype)), result, target, disp, op)

    def compare_and_swap(self, compare, new, result,
                         target: int, disp: int = 0) -> None:
        self._check_target(target)
        result = host_array(result, "the result buffer")
        dt = result.dtype
        payload = np.concatenate([
            np.atleast_1d(np.asarray(compare, dtype=dt)),
            np.atleast_1d(np.asarray(new, dtype=dt))])
        code = _DT_CODE[np.dtype(dt)]
        tag = self._new_reply_tag()
        rbuf = result.view(np.uint8).reshape(-1)
        req = self._pml().irecv(rbuf, rbuf.size, dtmod.BYTE, target, tag,
                                self.comm)
        self._send_hdr(target, CAS, disp, 1, code, reply_tag=tag,
                       payload=payload)
        self._ops_sent[target] += 1
        bump(pv_cas)
        self._wait_req(req)

    # -- synchronization -------------------------------------------------

    def _check_alive(self) -> None:
        """Raise instead of spinning when the job aborted, a peer of
        the window's comm died, or the epoch was revoked
        (ERR_PROC_FAILED / ERR_REVOKED): every blocking RMA wait loop
        polls this, so a window on a dead comm raises rather than
        hangs."""
        world = getattr(self.state.rte, "world", None)
        aborted = getattr(world, "aborted", None)
        if aborted is not None and aborted[0] != self.state.rank:
            raise _eh.MPIException(
                _eh.ERR_OTHER, f"peer rank {aborted[0]} aborted: "
                f"{aborted[2]}")
        ulfm = self.state.ulfm
        if ulfm is not None and ulfm.active:
            ulfm.poll()
            ulfm.check_comm(self.comm)

    def _wait_req(self, req) -> None:
        """Reply/ack wait that stays failure-aware: a peer death
        error-completes the request (or surfaces via check_comm), and
        either way the caller gets an exception, never a hang."""
        while not req.complete:
            self._check_alive()
            if self._progress.progress() == 0:
                self._progress.idle_tick()
        if req.status.error:
            raise _eh.MPIException(
                _eh.ERR_PROC_FAILED,
                "RMA peer failed while a reply was outstanding")

    def _drain_out(self) -> None:
        for r in self._out_reqs:
            r.wait()
        self._out_reqs.clear()

    def _wait_applied(self, goal: int) -> None:
        while self._applied_total < goal:
            self._check_alive()
            if self._progress.progress() == 0:
                self._progress.idle_tick()

    def fence(self) -> None:
        """Collective epoch boundary (osc/pt2pt fence: alltoall the
        per-target op counts, wait for the cumulative expectation)."""
        self._check_alive()
        counts = self._ops_sent.copy()
        expected = np.empty(self.size, dtype=np.int64)
        self.comm.Alltoall(counts, expected)
        self._expected_total += int(expected.sum())
        self._wait_applied(self._expected_total)
        self._drain_out()
        self._ops_sent[:] = 0
        self.comm.Barrier()

    def lock(self, target: int, mode: int = LOCK_EXCLUSIVE) -> None:
        self._check_target(target)
        tag = self._new_reply_tag()
        buf, req = self._recv_reply(0, target, tag)
        self._send_hdr(target, LOCK, opcode=mode, reply_tag=tag)
        t0 = time.perf_counter()
        self._wait_req(req)
        with _pv_lock:
            pv_lock_wait.update_max(int((time.perf_counter() - t0) * 1e6))

    def unlock(self, target: int) -> None:
        tag = self._new_reply_tag()
        buf, req = self._recv_reply(0, target, tag)
        self._send_hdr(target, UNLOCK, reply_tag=tag)
        self._wait_req(req)  # ack ⇒ every prior op at target applied
        self._drain_out()
        # _ops_sent is NOT reset: fence counting must stay consistent
        # with the target's _applied_total, which includes passive ops

    def lock_all(self) -> None:
        for t in range(self.size):
            self.lock(t, LOCK_SHARED)

    def unlock_all(self) -> None:
        for t in range(self.size):
            self.unlock(t)

    def flush(self, target: int) -> None:
        tag = self._new_reply_tag()
        buf, req = self._recv_reply(0, target, tag)
        self._send_hdr(target, FLUSH, reply_tag=tag)
        self._wait_req(req)

    def flush_all(self) -> None:
        for t in range(self.size):
            self.flush(t)

    def flush_local(self, target: int) -> None:
        self._drain_out()

    def sync(self) -> None:
        self._progress.progress()

    # -- PSCW (generalized active target) --------------------------------

    def start(self, group_ranks: List[int]) -> None:
        """Blocks until every target has post()ed — RMA ops from this
        access epoch may not touch a window before its exposure epoch
        opens (MPI-3 §11.5.2)."""
        self._start_group = list(group_ranks)
        while any(self._pscw_posted.get(t, 0) < 1
                  for t in self._start_group):
            self._check_alive()
            if self._progress.progress() == 0:
                self._progress.idle_tick()
        for t in self._start_group:
            self._pscw_posted[t] -= 1

    def complete(self) -> None:
        if self._start_group is None:
            raise RuntimeError("complete() without start() (MPI_ERR_RMA_SYNC)")
        for t in self._start_group:
            self._send_hdr(t, PSCW_COMPLETE)
        self._drain_out()
        self._start_group = None

    def post(self, group_ranks: List[int]) -> None:
        self._post_group = list(group_ranks)
        for o in self._post_group:
            self._send_hdr(o, PSCW_POST)

    def wait(self) -> None:
        """FIFO ordering ⇒ counting COMPLETEs is enough: each arrives
        after every op its origin issued in the epoch."""
        if self._post_group is None:
            raise RuntimeError("wait() without post() (MPI_ERR_RMA_SYNC)")
        need = {o: 1 for o in self._post_group}
        while any(self._pscw_complete.get(o, 0) < n
                  for o, n in need.items()):
            self._check_alive()
            if self._progress.progress() == 0:
                self._progress.idle_tick()
        for o in need:
            self._pscw_complete[o] -= 1
        self._post_group = None

    def test(self) -> bool:
        if self._post_group is None:
            return True
        self._progress.progress()
        if all(self._pscw_complete.get(o, 0) >= 1
               for o in self._post_group):
            for o in self._post_group:
                self._pscw_complete[o] -= 1
            self._post_group = None
            return True
        return False

    # -- lifecycle -------------------------------------------------------

    def free(self) -> None:
        if self._freed:
            return
        self.comm.Barrier()  # all ops everywhere done
        self._freed = True
        self._progress.unregister(self._am_progress)
        if self._hdr_req is not None:
            self._hdr_req.cancel()
            self._hdr_req = None
        self.comm.free()

    def abandon(self) -> None:
        """LOCAL teardown for fault paths: stop polling and receiving
        on this window without the collective handshake ``free``
        needs (peers may be gone).  Cancelling the wildcard header
        receive matters beyond hygiene: the dup'd comm's cid can be
        reused by a later communicator, and a live wildcard irecv on
        the dead window would steal — and misparse — its traffic."""
        if self._freed:
            return
        self._freed = True
        self._progress.unregister(self._am_progress)
        if self._hdr_req is not None:
            self._hdr_req.cancel()
            self._hdr_req = None
        self._pending = None

    def __repr__(self) -> str:
        return (f"Window({self.comm.name}, rank={self.rank}/{self.size}, "
                f"{self._mem.size}B, disp_unit={self.disp_unit})")


def create(comm, memory, disp_unit: Optional[int] = None,
           name: str = "", info=None) -> Window:
    """MPI_Win_create (ref: ompi/mpi/c/win_create.c)."""
    if disp_unit is None:
        disp_unit = host_array(memory, "window memory").dtype.itemsize \
            if getattr(memory, "nbytes", 0) else 1
    return Window(comm, memory, disp_unit, name, info=info)


def allocate(comm, nbytes: int, disp_unit: int = 1, name: str = "") -> Window:
    """MPI_Win_allocate: window-owned zeroed memory."""
    return Window(comm, np.zeros(nbytes, dtype=np.uint8), disp_unit, name)


def create_dynamic(comm, info=None, name: str = "") -> Window:
    """MPI_Win_create_dynamic: no initial memory; regions come and go
    via attach/detach, addressed by absolute address."""
    win = Window(comm, np.zeros(0, dtype=np.uint8), 1, name, info=info)
    win._dynamic = True
    return win


def allocate_shared(comm, nbytes: int, disp_unit: int = 1,
                    name: str = "") -> Window:
    """MPI_Win_allocate_shared (ref: osc/sm): one file-backed segment
    mapped by every co-located rank; rank r's window memory is its
    slice, and shared_query exposes any peer's slice for direct
    load/store.  The segment file lives in the temporary directory
    and is unlinked once every rank has mapped it."""
    import mmap as mmap_mod

    rte = comm.state.rte
    my_node = getattr(rte, "node_id", 0)
    for g in comm.group:
        if comm._peer_state(g) is None \
                and rte.modex_get(g, "node_id") != my_node:
            raise ValueError(
                "MPI_Win_allocate_shared needs co-located ranks "
                "(MPI_ERR_RMA_SHARED)")
    path = os.path.join(
        tempfile.gettempdir(),
        f"winshared_{os.getpid()}_{id(rte.world):x}_{min(comm.group)}_"
        f"{comm.cid}.buf")
    total = max(1, nbytes) * comm.size
    if comm.rank == 0:
        tmp = f"{path}.tmp"
        fd = os.open(tmp, os.O_CREAT | os.O_RDWR, 0o600)
        os.ftruncate(fd, total)
        os.close(fd)
        os.rename(tmp, path)
    comm.Barrier()
    fd = os.open(path, os.O_RDWR)
    mm = mmap_mod.mmap(fd, total)
    os.close(fd)
    comm.Barrier()
    if comm.rank == 0:
        os.unlink(path)
    seg = np.frombuffer(mm, dtype=np.uint8)
    mine = seg[comm.rank * nbytes: comm.rank * nbytes + nbytes]
    win = Window(comm, mine, disp_unit, name)
    win._shared_seg = seg
    win._shared_nbytes = nbytes
    win._shared_disp_unit = disp_unit
    return win


def shared_query(win: Window, rank: int):
    """(size, disp_unit, local view of `rank`'s segment)."""
    seg = getattr(win, "_shared_seg", None)
    if seg is None:
        raise ValueError("not a shared window (MPI_ERR_WIN)")
    n = win._shared_nbytes
    return n, win._shared_disp_unit, seg[rank * n: rank * n + n]


_eh.attach_api(Window)
