"""Device-memory one-sided RMA: the osc/device component.

Port of the reference's osc/device.py (a re-design of
ompi/mca/osc/rdma for the thread-rank world): window memory lives on
the devices of the comm's members (one uint8 shard a rank, on the
rank's device, ``comm.mesh()``) and the DATA PLANE never touches the
host AM path or the target's thread.  The ORIGIN thread alone enqueues
each op on the target's device, exactly as osc/rdma's btl put/get
bypasses the target CPU (ref: osc_rdma_comm.c put/get paths).

Lowering (``--mca osc_device_dma``, default 1):

    put/get/read_local   dma 1: copy-engine copies (``Tensor.copy_`` on
                         a slice of the shard, peer to peer across
                         cards); dma 0: one K8 ``rma_copy`` launch
    accumulate, get_accumulate, fetch_and_op
                         one K9 ``rma_acc`` launch on the target's
                         device, in both modes and for every wire dtype
    compare_and_swap     one K10 ``rma_cas`` launch, likewise

(The reference's DMA mode does the read-modify-write ops on the host,
and its kernel mode does so for 8-byte, complex and bool dtypes; the
port reads or modifies a shard on the host nowhere.)  Every op is one
launch or one copy whatever its size: no buckets, no segments.

Ordering and completion.  One lock (the shard table's) serialises every
data-plane op on a window, and every op on target t is enqueued on ONE
stream the window owns for t's device, never the caller's current
stream: launches on a target run in lock order, which is what makes
accumulate and compare-and-swap atomic with no device atomics.  Before
an op, that stream waits on an event recorded on the origin's current
stream (a card-tensor origin or result written just before is read
after the write); after it, a done event is recorded, and every tensor
the stream read or wrote gets ``record_stream``.  A numpy origin is
uploaded to the target's device before the call returns; a numpy
result is filled after the stream has finished the op; a card-tensor
result makes the caller's current stream wait on the done event.
fence, flush*, unlock*, complete wait on every done event this origin
recorded (the completion point, where the reference decouples its
zero-copy puts): MPI forbids touching an origin buffer before them.
``memory``, get and ``read_local`` of the owner go through the same
stream, so a target reading its ``memory`` after a fence sees the puts
of every origin.

lock/unlock/PSCW are inherited unchanged from the host AM window:
control stays on the host, payloads stay on the devices.

On the CPU (the tests) the shards are CPU tensors, each op runs under
the lock at once, and the kernel wrappers take their plain versions.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import numpy as np
import torch

from ompi_tpu_torch import trace as _trace
from ompi_tpu_torch.kernels import rma as _rma
from ompi_tpu_torch.kernels.stacked import require_peer
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as opmod
from ompi_tpu_torch.osc import window as _host
from ompi_tpu_torch.osc.window import _DT_CODE, Window, _op_code, bump

# trace ids as module constants (the data-plane entries are hot)
_CAT_RMA = _trace.CAT_RMA
_NAME_RMA_PUT = _trace.NAME_RMA_PUT
_NAME_RMA_GET = _trace.NAME_RMA_GET
_NAME_RMA_ACC = _trace.NAME_RMA_ACC

_dma_var = registry.register(
    "osc", "device", "dma", 1, int,
    help="1 = put/get/read_local are copy-engine copies (Tensor.copy_, "
         "peer to peer across cards); 0 = each is one launch of the "
         "rma_copy kernel.  Accumulate and compare-and-swap launch their "
         "kernels on the target's device either way")

#: window capacity alignment: max wire itemsize (complex128)
_ALIGN = 16


def _norm(dev) -> torch.device:
    """A torch device as its tensors report it: a card with its index
    spelled out (a bare "cuda" is card 0, as
    ``runtime.init.device_index`` reads it), the CPU without one."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev


class _ShardTable:
    """The per-window cross-rank state in world.shared: every rank's
    shard, one lock serialising all data-plane ops (which is what makes
    accumulate atomic), and the window's stream for each card a shard
    lies on."""

    __slots__ = ("arrs", "lock", "streams")

    def __init__(self, size: int) -> None:
        self.arrs: List[Optional[torch.Tensor]] = [None] * size
        self.lock = threading.RLock()
        self.streams = {}

    def stream(self, dev: torch.device):
        """The window's stream on card ``dev`` (None on the CPU).
        Caller holds the lock."""
        if dev.type != "cuda":
            return None
        s = self.streams.get(dev)
        if s is None:
            s = self.streams[dev] = torch.cuda.Stream(dev)
        return s


class DeviceWindow(Window):
    """MPI_Win whose memory is one shard a rank on the comm's devices."""

    def __init__(self, comm, memory=None, disp_unit: int = 1,
                 name: str = "", info=None) -> None:
        mesh = comm.mesh()
        if mesh is None:
            raise ValueError(
                "osc/device window needs a comm whose ranks own "
                "distinct devices (comm.mesh() is None)")
        self._devs = [_norm(d) for d in mesh]
        self._dev = self._devs[comm.rank]
        #: target device -> done event of this origin's last op there
        self._done = {}

        if memory is None:
            memory = np.zeros(0, dtype=np.uint8)
        if isinstance(memory, torch.Tensor):
            self._check_mine(memory, "window memory")
            src = memory.contiguous()
        else:
            src = torch.from_numpy(np.ascontiguousarray(memory))
        self._shape = tuple(src.shape)
        self._view_dtype = src.dtype
        flat = src.reshape(-1).view(torch.uint8)
        self._win_bytes = flat.numel()
        self._cap = max(_ALIGN, -(-self._win_bytes // _ALIGN) * _ALIGN)

        # cross-rank shard table: windows are created collectively in
        # the same order on every rank, so a per-comm sequence number
        # names this window uniquely; the parent constructor's closing
        # Barrier publishes every rank's deposit
        seq = comm.__dict__.get("_osc_win_seq", 0)
        comm.__dict__["_osc_win_seq"] = seq + 1
        self._world = comm.state.rte.world
        self._table_key = ("osc_devwin", comm.cid, tuple(comm.group), seq)
        with self._world.shared_lock:
            tab = self._world.shared.get(self._table_key)
            if tab is None:
                tab = _ShardTable(comm.size)
                self._world.shared[self._table_key] = tab
        self._tab = tab
        with self._on(comm.rank, src):
            # allocated on the window's stream, which every later op
            # on this shard runs on; a copy of the caller's memory
            shard = torch.zeros(self._cap, dtype=torch.uint8,
                                device=self._dev)
            shard[: self._win_bytes].copy_(flat)
            tab.arrs[comm.rank] = shard

        super().__init__(comm, np.zeros(0, dtype=np.uint8), disp_unit,
                         name, info=info)

    # the parent constructor assigns ``self.memory``; the device
    # window serves it as a fresh copy of the live shard instead
    @property
    def memory(self) -> torch.Tensor:
        """A copy of this rank's window memory on its device, with the
        dtype and shape the window was created with (the reference
        returns a host copy)."""
        out = torch.empty(self._win_bytes, dtype=torch.uint8,
                          device=self._dev)
        if self._win_bytes:
            with self._on(self.rank, out):
                out.copy_(self._tab.arrs[self.rank][: self._win_bytes])
            self._caller_waits(self.rank)
        return out.view(self._view_dtype).reshape(self._shape)

    @memory.setter
    def memory(self, value) -> None:
        pass  # parent __init__ writes its placeholder; shard is truth

    # -- plumbing ---------------------------------------------------------

    def _check_mine(self, t: torch.Tensor, what: str) -> None:
        if _norm(t.device) != self._dev:
            raise ValueError(f"{what} lies on {t.device}, not on the "
                             f"origin rank's device {self._dev}")

    @contextlib.contextmanager
    def _on(self, target: int, *tensors):
        """Run the body under the table lock on the window's stream for
        ``target``'s device.  ``tensors``: the caller's tensors the body
        reads or writes (they lie on this rank's device); the stream
        waits for the caller's work on them first and keeps them alive
        until it is done with them.  Records this origin's done event
        for the device."""
        dev = self._devs[target]
        with self._tab.lock:
            ws = self._tab.stream(dev)
            if ws is None:
                yield
                return
            cards = [t for t in tensors if t is not None and t.is_cuda]
            if cards:
                for t in cards:
                    require_peer(dev, t.device)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(self._dev))
                ws.wait_event(ev)
            with torch.cuda.device(dev), torch.cuda.stream(ws):
                yield
            for t in cards:
                t.record_stream(ws)
            done = torch.cuda.Event()
            done.record(ws)
            self._done[dev] = done

    def _caller_waits(self, target: int) -> None:
        """The caller's current stream waits for this origin's last op
        on ``target``'s device (a card-tensor result is read there)."""
        done = self._done.get(self._devs[target])
        if done is not None:
            torch.cuda.current_stream(self._dev).wait_event(done)

    def _origin(self, arr, what: str):
        """A tensor on this rank's device (contiguous), or a contiguous
        numpy array, of a wire dtype."""
        if isinstance(arr, torch.Tensor):
            self._check_mine(arr, what)
            if arr.dtype not in _rma.WIRE_DTYPES:
                raise TypeError(f"dtype {arr.dtype} not supported on "
                                "windows")
            return arr.contiguous()
        a = np.ascontiguousarray(arr)
        if _DT_CODE.get(a.dtype) is None:
            raise TypeError(f"dtype {a.dtype} not supported on windows")
        return a

    def _result(self, result, what: str):
        """A writable result buffer: a contiguous tensor on this rank's
        device or a writable contiguous numpy array."""
        if isinstance(result, torch.Tensor):
            self._check_mine(result, what)
            if not result.is_contiguous():
                raise ValueError(f"{what} must be contiguous")
            return result
        if not (isinstance(result, np.ndarray)
                and result.flags.c_contiguous and result.flags.writeable):
            raise ValueError(f"{what} must be a writable contiguous "
                             "ndarray or a tensor")
        return result

    @staticmethod
    def _bytes(x) -> torch.Tensor:
        """The raw bytes of a tensor or numpy array, as a flat uint8
        tensor over the same memory."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x.reshape(-1).view(np.uint8))
        return x.reshape(-1).view(torch.uint8)

    def _on_target(self, x, target: int) -> torch.Tensor:
        """``x`` where the target's device can read it: a tensor as it
        is, a numpy array uploaded to that device (one host-to-device
        copy on the window's stream; call inside ``_on``)."""
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(x).to(self._devs[target])

    def _range_check(self, start: int, nbytes: int) -> None:
        if start < 0 or start + nbytes > self._win_bytes:
            raise ValueError(
                f"RMA range [{start}, {start + nbytes}) outside the "
                f"{self._win_bytes}-byte window (MPI_ERR_RMA_RANGE)")

    # -- data plane: put / get -------------------------------------------

    def put(self, arr, target: int, disp: int = 0) -> None:
        tr = self.state.tracer
        if tr is None:
            nbytes = self._put_impl(arr, target, disp)
        else:
            t0 = tr.start_sampled(_CAT_RMA)
            nbytes = self._put_impl(arr, target, disp)
            if t0:
                tr.end(t0, _NAME_RMA_PUT, _CAT_RMA, self.comm.cid,
                       target, nbytes)
        bump(_host.pv_puts)
        bump(_host.pv_bytes_put, nbytes)

    def get(self, arr, target: int, disp: int = 0) -> None:
        tr = self.state.tracer
        if tr is None:
            nbytes = self._get_impl(arr, target, disp)
        else:
            t0 = tr.start_sampled(_CAT_RMA)
            nbytes = self._get_impl(arr, target, disp)
            if t0:
                tr.end(t0, _NAME_RMA_GET, _CAT_RMA, self.comm.cid,
                       target, nbytes)
        bump(_host.pv_gets)
        bump(_host.pv_bytes_got, nbytes)

    def _put_impl(self, arr, target: int, disp: int) -> int:
        self._check_target(target)
        src = self._origin(arr, "the origin buffer")
        nbytes = src.nbytes
        start = disp * self.disp_unit
        self._range_check(start, nbytes)
        if nbytes == 0:
            return 0
        shard = self._tab.arrs[target]
        card = src if isinstance(src, torch.Tensor) else None
        with self._on(target, card):
            if _dma_var.value:
                shard[start:start + nbytes].copy_(self._bytes(src))
            else:
                _rma.rma_copy(shard, start,
                              self._bytes(self._on_target(src, target)), 0,
                              nbytes, device=self._devs[target])
        return nbytes

    def _get_impl(self, arr, target: int, disp: int) -> int:
        self._check_target(target)
        dst = self._result(arr, "get target")
        nbytes = dst.nbytes
        start = disp * self.disp_unit
        self._range_check(start, nbytes)
        if nbytes == 0:
            return 0
        shard = self._tab.arrs[target]
        dev = self._devs[target]
        card = isinstance(dst, torch.Tensor)
        with self._on(target, dst if card else None):
            if card or _dma_var.value:
                out = self._bytes(dst)
            else:  # K8 into the target's device, then one copy home
                out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            if _dma_var.value:
                out.copy_(shard[start:start + nbytes])
            else:
                _rma.rma_copy(out, 0, shard, start, nbytes, device=dev)
                if not card:
                    self._bytes(dst).copy_(out)
        if card:
            self._caller_waits(target)
        return nbytes

    def rput(self, arr, target: int, disp: int = 0):
        from ompi_tpu_torch.pml.request import CompletedRequest
        self.put(arr, target, disp)
        return CompletedRequest(self._progress)

    def rget(self, arr, target: int, disp: int = 0):
        from ompi_tpu_torch.pml.request import CompletedRequest
        self.get(arr, target, disp)
        return CompletedRequest(self._progress)

    # -- data plane: accumulate family -----------------------------------

    def accumulate(self, arr, target: int, disp: int = 0,
                   op: opmod.Op = opmod.SUM) -> None:
        self._acc_entry(arr, None, target, disp, op)

    def raccumulate(self, arr, target: int, disp: int = 0,
                    op: opmod.Op = opmod.SUM):
        from ompi_tpu_torch.pml.request import CompletedRequest
        self.accumulate(arr, target, disp, op)
        return CompletedRequest(self._progress)

    def get_accumulate(self, arr, result, target: int, disp: int = 0,
                       op: opmod.Op = opmod.SUM) -> None:
        self._acc_entry(arr, result, target, disp, op)

    def rget_accumulate(self, arr, result, target: int, disp: int = 0,
                        op: opmod.Op = opmod.SUM):
        from ompi_tpu_torch.pml.request import CompletedRequest
        self.get_accumulate(arr, result, target, disp, op)
        return CompletedRequest(self._progress)

    def fetch_and_op(self, value, result, target: int, disp: int = 0,
                     op: opmod.Op = opmod.SUM) -> None:
        dt = _torch_dtype(result)
        if isinstance(value, torch.Tensor):
            origin = value.reshape(-1).to(dt)
        else:
            origin = np.atleast_1d(np.asarray(value, dtype=_np_dtype(dt)))
        self.get_accumulate(origin, result, target, disp, op)

    def _acc_entry(self, arr, result, target, disp, op) -> None:
        tr = self.state.tracer
        if tr is None:
            nbytes = self._acc_impl(arr, result, target, disp, op)
        else:
            t0 = tr.start_sampled(_CAT_RMA)
            nbytes = self._acc_impl(arr, result, target, disp, op)
            if t0:
                tr.end(t0, _NAME_RMA_ACC, _CAT_RMA, self.comm.cid,
                       target, nbytes)
        bump(_host.pv_accs)

    def _acc_impl(self, arr, result, target: int, disp: int,
                  op: opmod.Op) -> int:
        self._check_target(target)
        src = self._origin(arr, "the origin buffer")
        dt = _torch_dtype(src)
        _op_code(op)  # user-defined ops are not addressable on the wire
        if not _rma.acc_supported(dt, op.name):
            raise TypeError(f"{op.name} is not valid for {dt} on a device "
                            "window")
        if result is not None:
            result = self._result(result, "get_accumulate result")
            if _torch_dtype(result) != dt:
                raise TypeError("get_accumulate origin/result dtype "
                                "mismatch")
            if result.nbytes != src.nbytes:
                raise ValueError("get_accumulate origin and result sizes "
                                 "differ")
        nbytes = src.nbytes
        start = disp * self.disp_unit
        self._range_check(start, nbytes)
        if nbytes == 0:
            return 0
        shard = self._tab.arrs[target]
        card = isinstance(result, torch.Tensor)
        with self._on(target, *(x for x in (src, result)
                                if isinstance(x, torch.Tensor))):
            s = self._on_target(src, target)
            if result is None:
                _rma.rma_acc(shard, start, s, op.name)
            elif card:
                _rma.rma_acc(shard, start, s, op.name, old=result)
            else:
                old = torch.empty(s.numel(), dtype=dt,
                                  device=self._devs[target])
                _rma.rma_acc(shard, start, s, op.name, old=old)
                self._bytes(result).copy_(old.view(torch.uint8))
        if card:
            self._caller_waits(target)
        return nbytes

    def compare_and_swap(self, compare, new, result, target: int,
                         disp: int = 0) -> None:
        self._check_target(target)
        result = self._result(result, "compare_and_swap result")
        dt = _torch_dtype(result)
        if dt not in _rma.WIRE_DTYPES or result.nbytes != result.itemsize:
            raise TypeError("compare_and_swap takes one element of a wire "
                            "dtype")
        start = disp * self.disp_unit
        self._range_check(start, result.itemsize)
        shard = self._tab.arrs[target]
        card = isinstance(result, torch.Tensor)
        values = [v.reshape(1).to(dt) for v in (compare, new)
                  if isinstance(v, torch.Tensor)]
        if values and len(values) != 2:
            raise TypeError("compare_and_swap: compare and new must both "
                            "be tensors or both be host values")
        for v in values:
            self._check_mine(v, "compare_and_swap value")
        with self._on(target, result if card else None, *values):
            if values:
                c, n = values
            else:  # one host-to-device copy of the (compare, new) pair
                npdt = _np_dtype(dt)
                pair = self._on_target(np.concatenate([
                    np.atleast_1d(np.asarray(compare, dtype=npdt)),
                    np.atleast_1d(np.asarray(new, dtype=npdt))]), target)
                c, n = pair[0:1], pair[1:2]
            old = result.reshape(1) if card else torch.empty(
                1, dtype=dt, device=self._devs[target])
            _rma.rma_cas(shard, start, c, n, old)
            if not card:
                self._bytes(result).copy_(old.view(torch.uint8))
        if card:
            self._caller_waits(target)
        bump(_host.pv_cas)

    # -- local access (the oshmem heap reads ride this) ------------------

    def read_local(self, start: int, nbytes: int) -> torch.Tensor:
        """A copy of bytes [start, start + nbytes) of this rank's shard,
        as a uint8 tensor on its device (the reference returns a host
        copy): a copy-engine copy in DMA mode, one K8 launch in kernel
        mode."""
        self._range_check(start, nbytes)
        out = torch.empty(nbytes, dtype=torch.uint8, device=self._dev)
        if nbytes == 0:
            return out
        shard = self._tab.arrs[self.rank]
        with self._on(self.rank, out):
            if _dma_var.value:
                out.copy_(shard[start:start + nbytes])
            else:
                _rma.rma_copy(out, 0, shard, start, nbytes, device=self._dev)
        self._caller_waits(self.rank)
        return out

    # -- synchronization --------------------------------------------------

    def _materialize(self) -> None:
        """The completion point of this origin's ops: wait for the done
        event of its last op on every device (so its origin buffers
        are free and its ops have landed).  Every sync entry point
        (fence / flush* / unlock* / complete) runs it first."""
        for ev in self._done.values():
            ev.synchronize()
        self._done.clear()

    def fence(self) -> None:
        """Active-target epoch boundary: this origin's ops complete,
        then the collective Barrier."""
        self._check_alive()
        self._materialize()
        self._drain_out()
        self._ops_sent[:] = 0
        self.comm.Barrier()

    def flush(self, target: int) -> None:
        # device ops never ride the AM path, so there is nothing
        # outstanding at the target beyond this origin's own ops
        self._check_alive()
        self._materialize()
        self._drain_out()

    def flush_all(self) -> None:
        self._check_alive()
        self._materialize()
        self._drain_out()

    def flush_local(self, target: int) -> None:
        self._materialize()
        self._drain_out()

    def unlock(self, target: int) -> None:
        self._materialize()
        super().unlock(target)

    def unlock_all(self) -> None:
        self._materialize()
        super().unlock_all()

    def complete(self) -> None:
        self._materialize()
        super().complete()

    # -- lifecycle --------------------------------------------------------

    def _drop_table(self) -> None:
        with self._world.shared_lock:
            self._world.shared.pop(self._table_key, None)

    def free(self) -> None:
        if self._freed:
            return
        self._materialize()
        super().free()
        self._drop_table()

    def abandon(self) -> None:
        if self._freed:
            return
        super().abandon()
        self._drop_table()

    def __repr__(self) -> str:
        return (f"DeviceWindow({self.comm.name}, "
                f"rank={self.rank}/{self.size}, {self._win_bytes}B@"
                f"{self._dev}, disp_unit={self.disp_unit})")


def _torch_dtype(x) -> torch.dtype:
    if isinstance(x, torch.Tensor):
        return x.dtype
    return torch.from_numpy(np.empty(0, dtype=x.dtype)).dtype


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def create(comm, memory, disp_unit: Optional[int] = None,
           name: str = "", info=None) -> DeviceWindow:
    if disp_unit is None:
        disp_unit = memory.element_size() if memory.numel() else 1
    return DeviceWindow(comm, memory, disp_unit, name, info=info)


def allocate(comm, nbytes: int, disp_unit: int = 1,
             name: str = "") -> DeviceWindow:
    return DeviceWindow(comm, np.zeros(nbytes, dtype=np.uint8),
                        disp_unit, name)
