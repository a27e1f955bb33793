"""OpenSHMEM-analog PGAS layer.

Port of the reference's shmem/ package, a re-design of the oshmem
project (ref: oshmem/runtime/oshmem_shmem_init.c:142,233,272-328 —
init opens spml → scoll → sshmem → memheap; §2.7): a symmetric heap +
one-sided put/get/atomics + PE collectives.  The collapse: the **spml
data plane is the osc window machinery**, the **sshmem backing segment
is the window's memory**, scoll reuses the per-communicator coll
stack, and remote atomics are window fetch-ops.

The backing window comes from real osc component selection: on a comm
whose ranks own distinct devices (one card a rank, or logical devices
of one card) ``osc.allocate`` mints a device window, so the symmetric
heap lives in device memory and puts/gets/atomics lower to its
launches — K8 ``rma_copy`` (put/get with ``osc_device_dma`` 0), K9
``rma_acc`` (the atomics and the lock's ticket), K10 ``rma_cas`` —
with numpy values copied to and from the card by the window.
``ctx.device`` is then True, the heap has no host alias, and
``SymArray.local`` is a read-only snapshot (a self-get).  Otherwise it
is the host AM window over a numpy heap.

Symmetry: every PE performs the same allocation sequence
(shmem_malloc is collective in OpenSHMEM), so a deterministic
allocator yields identical offsets everywhere — a remote address is
(pe, my_offset), exactly the memheap model (ref: oshmem/mca/memheap).

A context with no communicator takes ``ompi_tpu_torch.init()``'s
world, as the reference's does (a process rank under mpirun, or a
singleton); a thread world passes the comm its rank function gets.

    from ompi_tpu_torch import shmem
    from ompi_tpu_torch.testing import logical_devices, run_ranks

    def pe(comm):
        shmem.init(comm)
        x = shmem.malloc(8, np.int64)
        shmem.put(x, np.arange(8), pe=(shmem.my_pe() + 1) % shmem.n_pes())
        shmem.barrier_all()
        print(x.local)
        shmem.finalize()

    run_ranks(4, pe, device_map=logical_devices("cpu"))
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op.op import (BAND, BOR, BXOR, MAX, MIN, PROD,
                                  REPLACE, SUM)
from ompi_tpu_torch.shmem import memheap as memheap_mod
from ompi_tpu_torch.shmem import scoll as scoll_mod

_heap_var = registry.register(
    "shmem", "memheap", "size", 1 << 22, int,
    help="Symmetric heap size in bytes (memheap analog)")


class SymArray:
    """A symmetric allocation: same offset on every PE."""

    __slots__ = ("ctx", "offset", "shape", "dtype")

    def __init__(self, ctx: "ShmemCtx", offset: int, shape, dtype) -> None:
        self.ctx = ctx
        self.offset = offset
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.dtype.itemsize

    @property
    def local(self) -> np.ndarray:
        """My PE's backing memory: a writable view into the host heap,
        or a read-only snapshot of the device shard (a device heap has
        no live host alias — stores go through put/atomics)."""
        return self.ctx._read_sym(self)

    def _disp(self, index: int = 0) -> int:
        return self.offset + index * self.dtype.itemsize


class ShmemCtx:
    """One PE's shmem state (the oshmem_group_all-rooted world)."""

    def __init__(self, comm=None, heap_size: Optional[int] = None) -> None:
        import ompi_tpu_torch
        from ompi_tpu_torch import osc as oscmod

        self.comm = comm if comm is not None else ompi_tpu_torch.init()
        self.heap_size = heap_size or _heap_var.value
        # sshmem backing segment through real osc selection: a
        # mesh-capable comm mints a device shard, so the symmetric heap
        # LIVES in device memory and every put/get/atomic below lowers
        # to the device component's launches; otherwise the host AM
        # window over a numpy heap
        self.win = oscmod.allocate(self.comm, self.heap_size,
                                   disp_unit=1, name="shmem-heap")
        self.device = hasattr(self.win, "read_local")
        self.heap = None if self.device else self.win.memory
        self.win.lock_all()  # passive epoch for the life of the ctx
        # MCA-selected components: the memheap allocator (buddy by
        # default, ref oshmem/mca/memheap/buddy) and the scoll module
        # (scoll/mpi: PE collectives ride the comm's coll stack)
        self.memheap = memheap_mod.select(self.heap_size)
        self.scoll = scoll_mod.select(self)
        self._finalized = False
        # shmem_ptr: co-resident thread-rank PEs can address each
        # other's heaps directly — publish mine where peers look
        world = getattr(self.comm.state.rte, "world", None)
        if world is not None and hasattr(world, "shared"):
            with world.shared_lock:
                # keyed by (comm cid, global rank): a second ctx over
                # a sub-communicator must not shadow the world ctx —
                # a peer resolving offsets against the wrong heap
                # would read real-looking garbage
                world.shared[("shmem_ctx", self.comm.cid,
                              self.comm.state.rank)] = self

    # -- memheap allocator (ref: oshmem/mca/memheap) --------------------
    def malloc(self, shape, dtype=np.uint8) -> SymArray:
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        try:
            off = self.memheap.malloc(nbytes)
        except MemoryError:
            raise MemoryError(
                f"symmetric heap exhausted ({nbytes} wanted; raise "
                f"--mca shmem_memheap_size)") from None
        return SymArray(self, off, shape, dtype)

    def free(self, arr: SymArray) -> None:
        self.memheap.free(arr.offset)

    # -- local symmetric-memory access ----------------------------------
    # Host heap: the block is a live writable numpy view.  Device heap:
    # the block is rank-local device memory behind the window — reads
    # are self-gets on the window's stream (behind every earlier op on
    # the device) into a read-only numpy snapshot; writes are
    # self-puts, so both serialize with remote ops under the same
    # window machinery.
    def _read_sym(self, arr: SymArray) -> np.ndarray:
        if self.heap is not None:
            raw = self.heap[arr.offset: arr.offset + arr.nbytes]
            return raw.view(arr.dtype).reshape(arr.shape)
        out = np.empty(arr.shape, dtype=arr.dtype)
        self.win.get(out.reshape(-1).view(np.uint8), self.comm.rank,
                     disp=arr.offset)
        out.flags.writeable = False
        return out

    def _write_sym(self, arr: SymArray, values) -> None:
        a = np.ascontiguousarray(
            np.asarray(values, dtype=arr.dtype)).reshape(-1)
        self._check_fit(arr, a.nbytes)
        if self.heap is not None:
            self._read_sym(arr).reshape(-1)[: a.size] = a
            return
        self.win.put(a, self.comm.rank, disp=arr.offset)
        self.win.flush_local(self.comm.rank)

    # -- spml data plane (ref: oshmem/mca/spml) -------------------------
    @staticmethod
    def _check_fit(dest: SymArray, nbytes: int, index: int = 0) -> None:
        room = dest.nbytes - index * dest.dtype.itemsize
        if nbytes > room:
            raise ValueError(
                f"put of {nbytes} bytes overruns the {room}-byte "
                f"symmetric allocation (would corrupt the target's "
                f"heap)")

    def put(self, dest: SymArray, value, pe: int) -> None:
        a = np.ascontiguousarray(np.asarray(value, dtype=dest.dtype))
        self._check_fit(dest, a.nbytes)
        self.win.put(a, pe, disp=dest._disp())
        self.win.flush_local(pe)

    def get(self, src: SymArray, pe: int) -> np.ndarray:
        out = np.empty(src.shape, dtype=src.dtype)
        self.win.get(out.reshape(-1), pe, disp=src._disp())
        return out

    def p(self, dest: SymArray, index: int, value, pe: int) -> None:
        """Single-element put (shmem_p)."""
        a = np.array([value], dtype=dest.dtype)
        self._check_fit(dest, a.nbytes, index)
        self.win.put(a, pe, disp=dest._disp(index))
        self.win.flush_local(pe)

    def g(self, src: SymArray, index: int, pe: int):
        """Single-element get (shmem_g)."""
        out = np.empty(1, dtype=src.dtype)
        self.win.get(out, pe, disp=src._disp(index))
        return out[0]

    @staticmethod
    def _check_strides(tst: int, sst: int) -> None:
        # the OpenSHMEM precondition: strides are >= 1.  Zero or
        # negative strides would address BELOW the allocation (and a
        # negative heap index wraps to the END of the numpy slice) —
        # silent corruption of neighboring symmetric allocations.
        if tst < 1 or sst < 1:
            raise ValueError(
                f"shmem_iput/iget strides must be >= 1 "
                f"(got tst={tst}, sst={sst})")

    def iput(self, dest: SymArray, source, tst: int, sst: int,
             nelems: int, pe: int) -> None:
        """Strided put (shmem_iput, ref: oshmem/shmem/c/shmem_iput.c:1):
        element i of the LOCAL ``source`` stream (stride ``sst``)
        lands at remote index i*``tst`` of ``dest``."""
        self._check_strides(tst, sst)
        src = np.asarray(source, dtype=dest.dtype).reshape(-1)
        if nelems:
            self._check_fit(dest, dest.dtype.itemsize,
                            (nelems - 1) * tst)
        for i in range(nelems):
            a = np.array([src[i * sst]], dtype=dest.dtype)
            self.win.put(a, pe, disp=dest._disp(i * tst))
        self.win.flush_local(pe)

    def iget(self, target, src: SymArray, tst: int, sst: int,
             nelems: int, pe: int) -> None:
        """Strided get (shmem_iget): remote index i*``sst`` of ``src``
        lands at index i*``tst`` of the LOCAL ``target`` array.
        Issues every fetch, then waits once (nelems serial RTTs would
        scale wall-clock by latency)."""
        self._check_strides(tst, sst)
        if not (isinstance(target, np.ndarray)
                and target.flags.c_contiguous
                and target.flags.writeable):
            # np.asarray would hand the stores to a silently-dropped
            # COPY for lists / non-contiguous views (same contract as
            # Window.rget)
            raise ValueError(
                "iget target must be a writable contiguous ndarray")
        if nelems:
            self._check_fit(src, src.dtype.itemsize,
                            (nelems - 1) * sst)
        t = target.reshape(-1)
        stage = np.empty((nelems, 1), dtype=src.dtype)
        reqs = [self.win.rget(stage[i], pe, disp=src._disp(i * sst))
                for i in range(nelems)]
        for r in reqs:
            r.wait()
        for i in range(nelems):
            t[i * tst] = stage[i, 0]

    # -- distributed locks (ref: oshmem/shmem/c/shmem_lock.c:37+) -------
    # The lock is ONE symmetric integer cell, interpreted as a ticket
    # lock packed into 64 bits: low 32 = now-serving, high 32 = next
    # ticket.  Acquisition queues FIFO (the fairness the reference's
    # MCS-style server queue provides) through osc fetch ops on the
    # cell's HOME PE (PE 0 — every PE must agree, and the spec makes
    # the lock symmetric so any deterministic home works).

    _LOCK_HOME = 0

    def set_lock(self, lock: SymArray, timeout: float = 120.0) -> None:
        old = self.atomic_fetch_add(lock, 0, np.int64(1) << 32,
                                    self._LOCK_HOME)
        my_ticket = int(old) >> 32
        deadline = time.monotonic() + timeout
        progress = self.comm.state.progress
        spins = 0
        while True:
            cur = int(self.atomic_fetch(lock, 0, self._LOCK_HOME))
            if (cur & 0xFFFFFFFF) == my_ticket:
                return
            spins += 1
            if progress.progress() == 0:
                # back off: the holder needs the core to release
                time.sleep(min(0.002, 50e-6 * spins))
            if time.monotonic() > deadline:
                self._retire_ticket(lock, my_ticket)
                raise TimeoutError(
                    f"shmem_set_lock: ticket {my_ticket} never served "
                    f"(holder dead?)")

    def _retire_ticket(self, lock: SymArray, my_ticket: int) -> None:
        """A timed-out waiter must not leave its ticket in the queue:
        once now-serving reaches it nobody would ever bump past it and
        every later PE wedges forever.  Two retirement
        paths: (a) no later ticket was issued — CAS the allocation
        back so our number is never served; (b) our ticket is already
        (or just became) the one being served — pass the grant
        straight to the next waiter, exactly like clear_lock."""
        cur = int(self.atomic_fetch(lock, 0, self._LOCK_HOME))
        if (cur >> 32) == my_ticket + 1 \
                and (cur & 0xFFFFFFFF) <= my_ticket:
            got = int(self.atomic_compare_swap(
                lock, 0, cur, cur - (np.int64(1) << 32),
                self._LOCK_HOME))
            if got == cur:
                return  # allocation rolled back; nobody will serve us
            cur = int(self.atomic_fetch(lock, 0, self._LOCK_HOME))
        if (cur & 0xFFFFFFFF) == my_ticket:
            # we were granted while abandoning: release immediately
            self.atomic_add(lock, 0, 1, self._LOCK_HOME)
            self.win.flush(self._LOCK_HOME)

    def clear_lock(self, lock: SymArray) -> None:
        # quiet FIRST: every put/atomic issued inside the critical
        # section must be remotely complete EVERYWHERE before the
        # next holder can observe the lock free — releasing first
        # would let it read pre-critical-section values on third
        # PEs (the reference quiets before release too)
        self.quiet()
        # increment now-serving: hands the lock to the next ticket
        self.atomic_add(lock, 0, 1, self._LOCK_HOME)
        self.win.flush(self._LOCK_HOME)

    def test_lock(self, lock: SymArray) -> bool:
        """True = lock acquired (the OpenSHMEM return convention is
        0 on success; the Python surface speaks bool).  Acquires only
        when nobody holds or waits — a queued test would block."""
        cur = int(self.atomic_fetch(lock, 0, self._LOCK_HOME))
        if (cur >> 32) != (cur & 0xFFFFFFFF):
            return False  # held or contended
        got = int(self.atomic_compare_swap(
            lock, 0, cur, cur + (np.int64(1) << 32), self._LOCK_HOME))
        return got == cur

    # -- shmem_ptr (ref: oshmem/shmem/c/shmem_ptr.c) --------------------
    def ptr(self, arr: SymArray, pe: int) -> Optional[np.ndarray]:
        """Direct load/store access to PE ``pe``'s symmetric memory,
        or None when the peer's heap is not addressable from here.
        Thread-rank PEs share one address space, so the peer's heap
        view is real; process ranks get None (their heaps are private
        — the reference likewise returns NULL without a mapped
        sm/xpmem segment)."""
        if pe == self.comm.rank:
            return arr.local
        world = getattr(self.comm.state.rte, "world", None)
        if world is None:
            return None
        peer_ctx = getattr(world, "shared", {}).get(
            ("shmem_ctx", self.comm.cid, self.comm.group[pe]))
        if peer_ctx is None or peer_ctx.heap is None:
            # device heaps have no host alias to hand out (the
            # reference likewise returns NULL without a mapped
            # segment); use put/get
            return None
        raw = peer_ctx.heap[arr.offset: arr.offset + arr.nbytes]
        return raw.view(arr.dtype).reshape(arr.shape)

    # -- ordering (ref: oshmem quiet/fence semantics) -------------------
    def quiet(self) -> None:
        """Remote completion of all my puts/atomics everywhere."""
        self.win.flush_all()

    def fence(self) -> None:
        """Ordering between my puts to each PE.  The osc AM rides the
        pml's per-(src,dst) FIFO, so delivery order already matches
        issue order; fence is a no-op kept for API fidelity."""

    def barrier_all(self) -> None:
        self.quiet()
        self.comm.Barrier()

    # -- atomics (ref: oshmem/mca/atomic) -------------------------------
    def atomic_add(self, dest: SymArray, index: int, value, pe: int) -> None:
        a = np.array([value], dtype=dest.dtype)
        self.win.accumulate(a, pe, disp=dest._disp(index), op=SUM)
        self.win.flush_local(pe)

    def atomic_fetch_add(self, dest: SymArray, index: int, value,
                         pe: int):
        old = np.empty(1, dtype=dest.dtype)
        self.win.fetch_and_op(np.array([value], dtype=dest.dtype), old,
                              pe, disp=dest._disp(index), op=SUM)
        return old[0]

    def atomic_inc(self, dest: SymArray, index: int, pe: int) -> None:
        self.atomic_add(dest, index, 1, pe)

    def atomic_fetch_inc(self, dest: SymArray, index: int, pe: int):
        return self.atomic_fetch_add(dest, index, 1, pe)

    def atomic_fetch(self, dest: SymArray, index: int, pe: int):
        return self.g(dest, index, pe)

    def atomic_set(self, dest: SymArray, index: int, value, pe: int) -> None:
        self.p(dest, index, value, pe)
        self.win.flush(pe)  # remote completion at the one target only

    def atomic_swap(self, dest: SymArray, index: int, value, pe: int):
        old = np.empty(1, dtype=dest.dtype)
        self.win.fetch_and_op(np.array([value], dtype=dest.dtype), old,
                              pe, disp=dest._disp(index), op=REPLACE)
        return old[0]

    def atomic_compare_swap(self, dest: SymArray, index: int, cond,
                            value, pe: int):
        old = np.empty(1, dtype=dest.dtype)
        self.win.compare_and_swap(
            np.array([cond], dtype=dest.dtype),
            np.array([value], dtype=dest.dtype), old, pe,
            disp=dest._disp(index))
        return old[0]

    # -- wait (ref: shmem_wait_until) -----------------------------------
    def wait_until(self, arr: SymArray, index: int, cmp: str, value,
                   timeout: float = 60.0) -> None:
        ops = {"eq": np.equal, "ne": np.not_equal, "gt": np.greater,
               "ge": np.greater_equal, "lt": np.less,
               "le": np.less_equal}[cmp]
        deadline = time.monotonic() + timeout
        progress = self.comm.state.progress
        while not bool(ops(arr.local.reshape(-1)[index], value)):
            if progress.progress() == 0:
                progress.idle_tick()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"shmem_wait_until({cmp}, {value}) timed out")

    # -- scoll (oshmem/mca/scoll framework; see shmem/scoll.py) ---------
    def broadcast(self, dest: SymArray, src: SymArray, root: int) -> None:
        self.scoll.broadcast(dest, src, root)

    def collect(self, dest: SymArray, src: SymArray) -> None:
        """fcollect: concatenation of every PE's src block."""
        self.scoll.collect(dest, src)

    def alltoall(self, dest: SymArray, src: SymArray) -> None:
        self.scoll.alltoall(dest, src)

    def _to_all(self, dest: SymArray, src: SymArray, op) -> None:
        self.scoll.to_all(dest, src, op)

    def sum_to_all(self, dest, src):
        self._to_all(dest, src, SUM)

    def max_to_all(self, dest, src):
        self._to_all(dest, src, MAX)

    def min_to_all(self, dest, src):
        self._to_all(dest, src, MIN)

    def prod_to_all(self, dest, src):
        self._to_all(dest, src, PROD)

    def and_to_all(self, dest, src):
        self._to_all(dest, src, BAND)

    def or_to_all(self, dest, src):
        self._to_all(dest, src, BOR)

    def xor_to_all(self, dest, src):
        self._to_all(dest, src, BXOR)

    # -- teardown --------------------------------------------------------
    def finalize(self) -> None:
        if self._finalized:
            return
        self.barrier_all()
        world = getattr(self.comm.state.rte, "world", None)
        if world is not None and hasattr(world, "shared"):
            with world.shared_lock:
                world.shared.pop(
                    ("shmem_ctx", self.comm.cid,
                     self.comm.state.rank), None)
        self.win.unlock_all()
        self.win.free()
        self._finalized = True


# -- module-level API (the flat shmem_* C surface) ---------------------------

_tls = threading.local()


def _ctx() -> ShmemCtx:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        raise RuntimeError("shmem is not initialized (call shmem.init())")
    return ctx


def init(comm=None, heap_size: Optional[int] = None) -> ShmemCtx:
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None and not ctx._finalized:
        # explicit arguments that conflict with the live ctx must not
        # be silently ignored
        if (comm is not None and comm is not ctx.comm) or \
                (heap_size is not None and heap_size != ctx.heap_size):
            raise RuntimeError(
                "shmem is already initialized with a different "
                "comm/heap_size; finalize() first")
        return ctx
    ctx = ShmemCtx(comm, heap_size)
    _tls.ctx = ctx
    return ctx


def finalize() -> None:
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        ctx.finalize()
        _tls.ctx = None


def my_pe() -> int:
    return _ctx().comm.rank


def n_pes() -> int:
    return _ctx().comm.size


def malloc(shape, dtype=np.uint8) -> SymArray:
    return _ctx().malloc(shape, dtype)


def free(arr: SymArray) -> None:
    _ctx().free(arr)


def put(dest, value, pe):
    _ctx().put(dest, value, pe)


def get(src, pe):
    return _ctx().get(src, pe)


def p(dest, index, value, pe):
    _ctx().p(dest, index, value, pe)


def g(src, index, pe):
    return _ctx().g(src, index, pe)


def quiet():
    _ctx().quiet()


def fence():
    _ctx().fence()


def barrier_all():
    _ctx().barrier_all()


def atomic_add(dest, index, value, pe):
    _ctx().atomic_add(dest, index, value, pe)


def atomic_fetch_add(dest, index, value, pe):
    return _ctx().atomic_fetch_add(dest, index, value, pe)


def atomic_inc(dest, index, pe):
    _ctx().atomic_inc(dest, index, pe)


def atomic_fetch_inc(dest, index, pe):
    return _ctx().atomic_fetch_inc(dest, index, pe)


def atomic_fetch(dest, index, pe):
    return _ctx().atomic_fetch(dest, index, pe)


def atomic_set(dest, index, value, pe):
    _ctx().atomic_set(dest, index, value, pe)


def atomic_swap(dest, index, value, pe):
    return _ctx().atomic_swap(dest, index, value, pe)


def atomic_compare_swap(dest, index, cond, value, pe):
    return _ctx().atomic_compare_swap(dest, index, cond, value, pe)


def wait_until(arr, index, cmp, value, timeout: float = 60.0):
    _ctx().wait_until(arr, index, cmp, value, timeout)


def broadcast(dest, src, root):
    _ctx().broadcast(dest, src, root)


def collect(dest, src):
    _ctx().collect(dest, src)


def alltoall(dest, src):
    _ctx().alltoall(dest, src)


def sum_to_all(dest, src):
    _ctx().sum_to_all(dest, src)


def max_to_all(dest, src):
    _ctx().max_to_all(dest, src)


def min_to_all(dest, src):
    _ctx().min_to_all(dest, src)


def prod_to_all(dest, src):
    _ctx().prod_to_all(dest, src)


def and_to_all(dest, src):
    _ctx().and_to_all(dest, src)


def or_to_all(dest, src):
    _ctx().or_to_all(dest, src)


def xor_to_all(dest, src):
    _ctx().xor_to_all(dest, src)


def iput(dest, source, tst, sst, nelems, pe):
    _ctx().iput(dest, source, tst, sst, nelems, pe)


def iget(target, src, tst, sst, nelems, pe):
    _ctx().iget(target, src, tst, sst, nelems, pe)


def set_lock(lock, timeout: float = 120.0):
    _ctx().set_lock(lock, timeout)


def clear_lock(lock):
    _ctx().clear_lock(lock)


def test_lock(lock):
    return _ctx().test_lock(lock)


def ptr(arr, pe):
    return _ctx().ptr(arr, pe)
