"""coll/seg: shared-segment collectives for same-node PROCESS ranks.

Re-design of ompi/mca/coll/sm for the process-rank side (ref:
coll_sm_module.c:102,167 and coll_sm_bcast.c — ranks on one node
meet in a shared segment of per-rank "fan-in/fan-out" slots guarded
by operation flags, instead of exchanging point-to-point messages).
The thread-rank analog is ompi_tpu_torch/coll/sm (a Python-object
rendezvous); this component is its mmap twin for ranks that are
separate PROCESSES on one host, where a p2p collective pays
6 sequential pml hops (3-4 ms for a 4-byte 8-rank allreduce on an
oversubscribed host — each hop is a full scheduler round trip).
Here every collective is one segment visit per rank: write your
slot, flag it, wait for the flags you need, read.  On a 1-core host
that is ~P scheduler wakeups total instead of ~2 log P sequential
round trips through the matching engine.

Segment protocol (per communicator, double-banked):

  * Each op gets a generation number g (a local counter — MPI orders
    collectives identically on every member).  Slot data and seq
    flags are double-banked by g parity: a fast rank in op g+1 works
    the other bank while a slow rank still reads op g.
  * write bank[g%2], THEN seq[me][g%2] = g (x86 TSO + numpy 8-byte
    aligned stores keep the order and atomicity; same discipline as
    the shm btl ring indices).
  * done[me] = g published when the rank has fully LEFT op g
    (including reads) — before touching a bank for op g, a rank
    waits all done >= g-2, which proves nobody still reads that
    bank (it was last used in op g-2).  A rank can never be 2 ops
    ahead: completing op g+1 needs flags my op-g state has not
    produced.
  * Blocked waits keep the pml progress engine turning (the
    opal_progress discipline — passive-target RMA may target a rank
    parked in a collective) and sleep briefly between polls: on an
    oversubscribed host a polling spin burns the very quantum the
    flag-writer needs.

Eligibility (cached per comm at first use, identical on every
member): every member's modex (node_id, session_dir) equals ours —
same host AND same mpirun session (a dpm connect/accept peer from a
different job has a different session dir and no shared segment).
Payloads larger than the slot fall back per-call to the tuned p2p
stack (both sides compute the same verdict from count*datatype).

Segment files live in the session directory and are cleaned with it
at job teardown (launcher-owned lifetime, like the shm btl rings).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ompi_tpu_torch.coll.buffers import IN_PLACE, typed
from ompi_tpu_torch.coll.framework import CollComponent, coll_framework
from ompi_tpu_torch.coll.tuned import TunedModule
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op.op import Op

_prio_var = registry.register(
    "coll", "seg", "priority", 55, int,
    help="Selection priority of the shared-segment (same-node "
         "process-rank) collective component (below coll/sm, above "
         "tuned)")
_slot_var = registry.register(
    "coll", "seg", "slot_bytes", 8 * 1024 * 1024, int,
    help="Per-rank segment slot size; allreduce/bcast payloads "
         "larger than this stream through the segment in slot-sized "
         "pieces (each its own generation), other collectives fall "
         "back to the p2p stack")
_poll_var = registry.register(
    "coll", "seg", "poll_us", 50, int,
    help="Sleep between segment flag polls in microseconds (bounds "
         "the scheduler pressure of blocked ranks on oversubscribed "
         "hosts)")
_timeout_var = registry.register(
    "coll", "seg", "timeout", 300.0, float,
    help="Seconds a segment collective may stall before raising "
         "(dead/diverged peer diagnosis)")
_rsag_min_var = registry.register(
    "coll", "seg", "rsag_min_bytes", 1 << 20, int,
    help="Allreduce payloads at least this large use the split-fold "
         "reduce_scatter+allgather segment form instead of the "
         "every-rank-folds single round")
_stride_var = registry.register(
    "coll", "seg", "progress_stride", 16, int,
    help="Run a full pml progress sweep every Nth flag poll: the "
         "sweep costs 10-50x a numpy flag read, and a blocked "
         "collective only needs it for background service (passive "
         "RMA at this rank), not for its own completion")

_MAGIC = 0x5E6C012  # v2: per-bank completion words (posted/left)


class _timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


class _Futex:
    """futex(2) on 32-bit words inside the shared segment: waiters
    park in the kernel and the flag WRITER wakes them directly — the
    wake-to-run path is a scheduler enqueue (~10 us) instead of a
    sleep-poll granularity (~60+ us), and idle waiters cost zero CPU.
    The reference gets this from pthread condition variables in its
    shared segment; raw futexes are the no-pthread-in-Python analog.
    Non-Linux or blocked syscalls degrade to the sleep-poll path."""

    SYS_FUTEX = 202  # x86_64
    WAIT = 0
    WAKE = 1

    def __init__(self) -> None:
        import platform
        if platform.machine() != "x86_64":
            # SYS_futex is 202 only on x86_64; on another arch the
            # number is a DIFFERENT syscall which may "succeed" and
            # make wait() a no-op hot spin.  Degrade to sleep-poll.
            self.ok = False
            return
        try:
            self._libc = ctypes.CDLL(None, use_errno=True)
            self._syscall = self._libc.syscall
            # probe: wake on a private word must not raise
            probe = (ctypes.c_int32 * 1)()
            r = self._syscall(self.SYS_FUTEX, ctypes.byref(probe),
                              self.WAKE, 1, None, None, 0)
            self.ok = r >= 0
        except Exception:
            self.ok = False

    def wait(self, addr: int, expected: int, timeout_s: float) -> None:
        """Park while *addr == expected (racy-safe: a changed value
        returns immediately with EAGAIN)."""
        ts = _timespec(int(timeout_s),
                       int((timeout_s % 1.0) * 1e9))
        self._syscall(self.SYS_FUTEX, ctypes.c_void_p(addr),
                      self.WAIT, ctypes.c_int32(expected),
                      ctypes.byref(ts), None, 0)

    def wake(self, addr: int) -> None:
        self._syscall(self.SYS_FUTEX, ctypes.c_void_p(addr),
                      self.WAKE, (1 << 30), None, None, 0)


_futex = _Futex()


class _Seg:
    """The mapped per-communicator segment: flags + banked slots."""

    def __init__(self, comm, slot: int) -> None:
        size = comm.size
        rte = comm.state.rte
        # layout v2: [magic u64][done u64*P][seq u64*P*2]
        #            [posted u64*2][left u64*2][data P*2*slot]
        # posted[b]/left[b] are gen-valued per-bank completion words:
        # the last poster/leaver (whoever's scan first sees all P
        # flags) publishes the gen and wakes ONE word — waiters park
        # once instead of re-waking on every peer's flag store (the
        # v1 staggered parking cost O(P^2) scheduler slices per op)
        self._off_done = 8
        self._off_seq = self._off_done + 8 * size
        self._off_pl = self._off_seq + 8 * size * 2
        self._off_data = self._off_pl + 32
        total = self._off_data + size * 2 * slot
        gid = f"{comm.cid}_{abs(hash(tuple(comm.group))) & 0xFFFFFFFF:08x}"
        epoch = getattr(comm.state, "ft_epoch", 0)
        if epoch:
            # recovery epoch: a pre-failure segment file holds stale
            # generation counters — attach to a fresh one
            gid += f"_e{epoch}"
        path = os.path.join(rte.session_dir, f"coll_seg_{gid}.buf")
        creator = comm.rank == 0
        if creator and not os.path.exists(path):
            tmp = f"{path}.tmp.{os.getpid()}"
            fd = os.open(tmp, os.O_CREAT | os.O_RDWR, 0o600)
            os.ftruncate(fd, total)
            m = mmap.mmap(fd, total)
            np.frombuffer(m, np.uint64, count=1)[0] = _MAGIC
            m.flush()
            m.close()
            os.close(fd)
            os.rename(tmp, path)  # attachers never see a short file
        else:
            # the creator may still be inside an RMA flush that waits
            # on THIS rank (a passive target): keep the pml turning
            # while the file is missing, as every other seg wait does
            # (the reference sleeps here without progress, and a
            # shmem barrier_all can then deadlock)
            progress = comm.state.progress
            deadline = time.monotonic() + _timeout_var.value
            while True:
                try:
                    if os.path.getsize(path) >= total:
                        break
                except OSError:
                    pass
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"coll/seg segment {path} never appeared "
                        "(creator dead?)")
                progress.progress()
                SegCollModule._ulfm_check(comm)
                time.sleep(200e-6)
        fd = os.open(path, os.O_RDWR)
        self.mm = mmap.mmap(fd, total)
        os.close(fd)
        self.slot = slot
        magic = np.frombuffer(self.mm, np.uint64, count=1)
        assert int(magic[0]) == _MAGIC, "corrupt coll/seg segment"
        self.done = np.frombuffer(self.mm, np.int64, count=size,
                                  offset=self._off_done)
        self.seq = np.frombuffer(self.mm, np.int64, count=size * 2,
                                 offset=self._off_seq).reshape(size, 2)
        self.data = np.frombuffer(self.mm, np.uint8,
                                  offset=self._off_data
                                  ).reshape(size, 2, slot)
        self.gen = 0
        # int32 low-word views of the same counters (little-endian):
        # the futex word the kernel waits on.  Generations are capped
        # well under 2^31 by any real run.
        self.seq32 = np.frombuffer(
            self.mm, np.int32, count=size * 4,
            offset=self._off_seq).reshape(size, 2, 2)[:, :, 0]
        self.done32 = np.frombuffer(
            self.mm, np.int32, count=size * 2,
            offset=self._off_done).reshape(size, 2)[:, 0]
        self.posted = np.frombuffer(self.mm, np.int64, count=2,
                                    offset=self._off_pl)
        self.left = np.frombuffer(self.mm, np.int64, count=2,
                                  offset=self._off_pl + 16)
        self.posted32 = np.frombuffer(
            self.mm, np.int32, count=4,
            offset=self._off_pl).reshape(2, 2)[:, 0]
        self.left32 = np.frombuffer(
            self.mm, np.int32, count=4,
            offset=self._off_pl + 16).reshape(2, 2)[:, 0]
        self._base = ctypes.addressof(ctypes.c_char.from_buffer(self.mm))
        lib = _seg_lib()
        self.fn = lib.tpumpi_seg_coll if lib is not None else None

    def seq_addr(self, p: int, b: int) -> int:
        return self._base + self._off_seq + (p * 2 + b) * 8

    def done_addr(self, p: int) -> int:
        return self._base + self._off_done + p * 8

    def posted_addr(self, b: int) -> int:
        return self._base + self._off_pl + b * 8

    def left_addr(self, b: int) -> int:
        return self._base + self._off_pl + 16 + b * 8

    def publish_posted(self, b: int, g: int) -> None:
        """Publish gen g into posted[b] once every rank's seq flag
        reached it (idempotent: all publishers store the same
        monotonically increasing value)."""
        if self.posted[b] < g and (self.seq[:, b] >= g).all():
            self.posted[b] = g
            if _futex.ok:
                _futex.wake(self.posted_addr(b))

    def publish_left(self, b: int, g: int) -> None:
        if self.left[b] < g and (self.done >= g).all():
            self.left[b] = g
            if _futex.ok:
                _futex.wake(self.left_addr(b))

    def flag_seq(self, rank: int, b: int, g: int,
                 wake: bool = False) -> None:
        """``wake``: only the bcast ROOT's flag has per-word waiters
        in v2 (everyone else parks on posted[b]) — unconditional wakes
        were ~1 syscall per rank per op with nobody listening."""
        self.seq[rank, b] = g
        if wake and _futex.ok:
            _futex.wake(self.seq_addr(rank, b))
        self.publish_posted(b, g)

    def flag_done(self, rank: int, g: int) -> None:
        self.done[rank] = g
        self.publish_left(g & 1, g)


def _get_seg(comm) -> Optional[_Seg]:
    seg = comm.__dict__.get("_coll_seg")
    if seg is None:
        seg = _Seg(comm, _slot_var.value)
        comm.__dict__["_coll_seg"] = seg
    return seg


# ---------------------------------------------------------------------------
# native fast path: one reentrant C call per collective (collseg.cpp).
# The Python protocol below costs ~133 us of cache-cold interpreter
# work per rank per op under process rotation; the C path touches
# only the protocol words.  Python and C speak the SAME segment
# protocol, so ranks may mix paths (e.g. one rank's native build
# failed) without divergence.
# ---------------------------------------------------------------------------

_K_BARRIER, _K_BCAST, _K_ALLREDUCE, _K_REDUCE = 0, 1, 2, 3
_K_ALLGATHER, _K_ALLTOALL, _K_REDUCE_SCATTER = 4, 5, 6

_NAT_DT = {np.dtype(t): i for i, t in enumerate(
    (np.float32, np.float64, np.int8, np.uint8, np.int16, np.uint16,
     np.int32, np.uint32, np.int64, np.uint64))}
_NAT_OP = {"MPI_SUM": 0, "MPI_PROD": 1, "MPI_MAX": 2, "MPI_MIN": 3,
           "MPI_BAND": 4, "MPI_BOR": 5, "MPI_BXOR": 6,
           "MPI_LAND": 7, "MPI_LOR": 8, "MPI_LXOR": 9}
_REDUCTIONS = (_K_ALLREDUCE, _K_REDUCE, _K_REDUCE_SCATTER)


def _seg_lib():
    from ompi_tpu_torch import native
    return native.load()


_nat_cache: Dict[tuple, Optional[tuple]] = {}

# visit counters: a bench/test can ASSERT the C hot path engages for
# mpirun process ranks instead of assuming it (optimizing a path that
# silently fell back to Python would be noise)
_pvar_native = registry.register_pvar(
    "coll", "seg", "native_ops",
    help="Segment collectives completed through the native C path")
_pvar_python = registry.register_pvar(
    "coll", "seg", "python_ops",
    help="Segment collectives run through the Python protocol "
         "(no native lib, unsupported op/dtype, or mixed-path peer)")


def _nat_codes(kind: int, op: Optional[Op], dtype) -> Optional[tuple]:
    """(dt_code, op_code) when the C path supports the combination,
    else None (Python protocol fallback).  Deterministic in (kind,
    op, dtype) so every rank picks the same eligibility — though the
    protocol tolerates mixed paths anyway.  Cached: this sits on the
    per-op hot path."""
    # keyed on op.name, not id(op): ids are recycled after gc, and a
    # stale hit would silently run the WRONG reduction in C.  The
    # verdict depends only on (name, dtype) anyway — user op names
    # are monotonic MPI_USER_<n>, never a reused identity.
    key = (kind in _REDUCTIONS,
           getattr(op, "name", None) if op is not None else None,
           str(dtype))
    hit = _nat_cache.get(key, _nat_cache)
    if hit is not _nat_cache:
        return hit
    if not key[0]:
        out = (0, 99)
    else:
        dtc = _NAT_DT.get(np.dtype(dtype))
        opc = _NAT_OP.get(op.name) if op is not None else None
        if dtc is None or opc is None or (dtc <= 1 and opc > 3):
            out = None  # float ops: SUM/PROD/MAX/MIN only
        else:
            out = (dtc, opc)
    _nat_cache[key] = out
    return out


class SegCollModule(TunedModule):
    """Shared-segment collectives; p2p fallback via the tuned
    superclass for ineligible comms/payloads."""

    name = "seg"

    def _seg_ok(self, comm) -> bool:
        cached = comm.__dict__.get("_seg_eligible")
        if cached is not None:
            return cached
        ok = False
        rte = comm.state.rte
        session = getattr(rte, "session_dir", None)
        world = getattr(rte, "world", None)
        if comm.size > 1 and session and not getattr(
                comm, "is_inter", False):
            # thread-rank-only comms are served better by coll/sm
            # (object rendezvous, no copies); seg earns its keep when
            # at least one member is a separate process
            all_threads = bool(
                world is not None
                and all(world.is_local(g) for g in comm.group))
            if not all_threads:
                try:
                    me = (rte.modex_get(comm.state.rank, "node_id"),
                          rte.modex_get(comm.state.rank, "seg_session"))
                    ok = all(
                        (rte.modex_get(g, "node_id"),
                         rte.modex_get(g, "seg_session")) == me
                        for g in comm.group)
                except Exception:
                    ok = False  # missing modex: deterministic on all
        comm.__dict__["_seg_eligible"] = ok
        return ok

    # -- segment machinery -----------------------------------------------
    @staticmethod
    def _ulfm_check(comm) -> None:
        """Failure-aware parking: a ULFM failure record naming a
        member of this comm (or a revoke) turns a parked seg wait into
        ERR_PROC_FAILED/ERR_REVOKED now, instead of a generic stall
        RuntimeError after the full timeout.  One is-None check when
        ULFM is off or no failure has ever been recorded."""
        u = comm.state.ulfm
        if u is not None and u.active:
            u.poll()
            u.check_comm(comm)

    def _wait(self, comm, cond, what: str) -> None:
        """Poll ``cond`` with a cheap flag read per iteration, a brief
        sleep between polls (oversubscribed hosts: the flag-writer
        needs the core), and a full progress sweep every Nth poll so
        background pml traffic (passive-target RMA at this rank) is
        still serviced while blocked."""
        if cond():
            return
        progress = comm.state.progress
        sleep_s = _poll_var.value * 1e-6
        stride = max(1, _stride_var.value)
        deadline = time.monotonic() + _timeout_var.value
        spins = 0
        while True:
            spins += 1
            if spins % stride == 0:
                progress.progress()
                self._ulfm_check(comm)
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"coll/seg stalled >{_timeout_var.value}s "
                        f"({what}; peer dead or diverged?)")
            if cond():
                return
            if spins > 2:
                time.sleep(sleep_s)

    def _wait_ge(self, comm, vals32: np.ndarray, addr_fn, g: int,
                 what: str) -> None:
        """Wait until every counter in ``vals32`` (int32 segment
        views) reaches ``g``: futex-park on the first laggard's word
        so the writer's flag store wakes us directly; on timeout
        sweep the pml (passive-target RMA may target this rank) and
        check the stall clock.  Falls back to sleep-polling when the
        futex syscall is unavailable."""
        if not _futex.ok:
            return self._wait(
                comm, lambda: bool((vals32 >= g).all()), what)
        if (vals32 >= g).all():
            return
        progress = comm.state.progress
        park = 0.002
        deadline = time.monotonic() + _timeout_var.value
        me = comm.rank
        k = len(vals32)
        while True:
            pend = np.nonzero(vals32 < g)[0]
            if pend.size == 0:
                return
            # stagger: each waiter parks on a DIFFERENT laggard's
            # word (first pending index after my own rank, cyclic) —
            # if everyone watched the same word, every flag write
            # would wake the whole herd, O(P^2) scheduler wakeups
            # per op instead of O(P)
            after = pend[pend > me]
            i = int(after[0] if after.size else pend[0])
            cur = int(vals32[i])
            if cur >= g:
                continue
            t0 = time.monotonic()
            _futex.wait(addr_fn(i), cur, park)
            now = time.monotonic()
            if vals32[i] < g and now - t0 >= park / 2:
                # timed out, not event-woken: background service
                progress.progress()
                self._ulfm_check(comm)
            # stall check OUTSIDE the timed-out branch: a wait() that
            # returns instantly without progress (e.g. a broken futex
            # probe) must still reach the dead-peer diagnosis instead
            # of hot-spinning forever
            if now > deadline and vals32[i] < g:
                raise RuntimeError(
                    f"coll/seg stalled >{_timeout_var.value}s "
                    f"({what}; peer dead or diverged?)")

    def _wait_word(self, comm, word64, word32, addr: int,
                   g: int, publish, what: str) -> None:
        """Park on ONE gen-valued completion word until it reaches
        ``g``.  ``publish`` re-scans the underlying flags before every
        park: any waiter can become the publisher, so a racing pair of
        posters can never strand the bank.  Falls back to sleep-poll
        when futex is unavailable."""
        def cond():
            if word64[0] >= g:
                return True
            publish()
            return word64[0] >= g

        if cond():
            return
        if not _futex.ok:
            return self._wait(comm, cond, what)
        progress = comm.state.progress
        park = 0.002
        deadline = time.monotonic() + _timeout_var.value
        while True:
            if cond():
                return
            cur = int(word32[0])
            if cur >= g:
                continue
            t0 = time.monotonic()
            _futex.wait(addr, cur, park)
            now = time.monotonic()
            if word64[0] < g and now - t0 >= park / 2:
                progress.progress()
                self._ulfm_check(comm)
            if now > deadline and not cond():
                raise RuntimeError(
                    f"coll/seg stalled >{_timeout_var.value}s "
                    f"({what}; peer dead or diverged?)")

    def _wait_posted(self, comm, seg, b: int, g: int,
                     what: str) -> None:
        self._wait_word(comm, seg.posted[b:b + 1],
                        seg.posted32[b:b + 1], seg.posted_addr(b), g,
                        lambda: seg.publish_posted(b, g), what)

    def _wait_left(self, comm, seg, b: int, g: int, what: str) -> None:
        self._wait_word(comm, seg.left[b:b + 1],
                        seg.left32[b:b + 1], seg.left_addr(b), g,
                        lambda: seg.publish_left(b, g), what)

    def _enter(self, comm) -> tuple:
        """Begin op: bump gen, prove nobody still reads this bank."""
        _pvar_python.add(1)
        seg = _get_seg(comm)
        seg.gen += 1
        g = seg.gen
        if g >= 2:
            # gen g-2 shares this bank (same parity)
            self._wait_left(comm, seg, g & 1, g - 2,
                            f"bank reuse guard gen {g}")
        return seg, g, g & 1

    def _native_run(self, comm, kind: int, root: int,
                    inp: Optional[np.ndarray],
                    out: Optional[np.ndarray], nbytes: int,
                    codes: tuple) -> bool:
        """Run one collective through the C segment path; True when
        handled.  Reentry loop: a return of 1 means the C side parked
        once without completion — sweep the pml (passive-target RMA
        may target this blocked rank) and re-enter.  The happy path
        (op completed within one park) costs one ctypes call and no
        clock reads — every microsecond here is multiplied by P
        scheduler visits per op on an oversubscribed host."""
        seg = comm.__dict__.get("_coll_seg")
        if seg is None:
            if _seg_lib() is None:
                return False
            seg = _get_seg(comm)
        fn = seg.fn
        if fn is None:
            return False
        seg.gen += 1
        g = seg.gen
        dtc, opc = codes
        call = (seg._base, comm.size, seg.slot, comm.rank, g, kind,
                root, inp.ctypes.data if inp is not None else None,
                out.ctypes.data if out is not None else None,
                nbytes, dtc, opc, 2000)
        r = fn(*call)
        if r == 0:
            _pvar_native.add(1)
            return True
        if r < 0:
            # unsupported probe fires before any segment mutation;
            # undo the gen and let Python take over
            seg.gen -= 1
            return False
        self._native_reenter(comm, seg, g, call)
        return True

    def _native_reenter(self, comm, seg, g, call) -> None:
        """Shared incomplete-park retry loop: the C side parked once
        without completion — sweep the pml (passive-target RMA may
        target this blocked rank) and re-enter until done."""
        progress = comm.state.progress
        deadline = time.monotonic() + _timeout_var.value
        while True:
            progress.progress()
            self._ulfm_check(comm)
            r = seg.fn(*call)
            if r == 0:
                _pvar_native.add(1)
                return
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"coll/seg stalled >{_timeout_var.value}s "
                    f"(native gen {g}; peer dead or diverged?)")

    def _post(self, seg, comm, g, b, arr: Optional[np.ndarray],
              wake: bool = False) -> None:
        """Write my slot (optional) and flag it."""
        if arr is not None:
            view = np.ascontiguousarray(arr).view(np.uint8).reshape(-1)
            seg.data[comm.rank, b, :view.size] = view
        seg.flag_seq(comm.rank, b, g, wake=wake)

    def _slot_of(self, seg, peer: int, b: int, nbytes: int,
                 dtype) -> np.ndarray:
        return seg.data[peer, b, :nbytes].view(dtype)

    def _fold(self, arrs: List[np.ndarray], op: Op) -> np.ndarray:
        # one ufunc reduction over the stacked slots when the op has
        # one (SUM/MAX/... are numpy ufuncs): P-1 Python-level reduce
        # calls collapse to a single C loop.  Ops without a ufunc
        # (pair types, user ops) keep the rank-order left fold; ufunc
        # .reduce is the same left-to-right order, so results stay
        # bit-identical across paths.
        red = getattr(op.np_fn, "reduce", None)
        if red is not None and arrs[0].dtype.fields is None:
            return red(np.stack(arrs), axis=0)
        acc = np.array(arrs[0], copy=True)
        for s in arrs[1:]:
            acc = op.reduce(acc, s)
        return acc

    # one-generation protocol rounds, native-or-Python per RANK: the
    # round STRUCTURE (op kind + generation count) is decided only by
    # deterministic inputs, so ranks with and without the native lib
    # interoperate piece for piece
    def _rs_round(self, comm, piece_in, stripe, op, codes) -> None:
        nb = piece_in.nbytes
        if self._native_run(comm, _K_REDUCE_SCATTER, 0, piece_in,
                            stripe, nb, codes):
            return
        seg, g, b = self._enter(comm)
        self._post(seg, comm, g, b, piece_in)
        self._wait_posted(comm, seg, b, g, f"rs round gen {g}")
        k = stripe.size
        lo, hi = comm.rank * k, (comm.rank + 1) * k
        arrs = [self._slot_of(seg, p, b, nb,
                              piece_in.dtype).reshape(-1)[lo:hi]
                for p in range(comm.size)]
        stripe[:] = self._fold(arrs, op)
        seg.flag_done(comm.rank, g)

    def _ag_round(self, comm, stripe, out) -> None:
        if self._native_run(comm, _K_ALLGATHER, 0, stripe, out,
                            stripe.nbytes, (0, 99)):
            return
        seg, g, b = self._enter(comm)
        self._post(seg, comm, g, b, stripe)
        self._wait_posted(comm, seg, b, g, f"ag round gen {g}")
        k = stripe.size
        for p in range(comm.size):
            out[p * k:(p + 1) * k] = \
                self._slot_of(seg, p, b, stripe.nbytes, stripe.dtype)
        seg.flag_done(comm.rank, g)

    def _allreduce_round(self, comm, piece_in, out, op, codes) -> None:
        nb = piece_in.nbytes
        if codes is not None and self._native_run(
                comm, _K_ALLREDUCE, 0, piece_in, out, nb, codes):
            return
        seg, g, b = self._enter(comm)
        self._post(seg, comm, g, b, piece_in)
        self._wait_posted(comm, seg, b, g,
                          f"chunked allreduce gen {g}")
        arrs = [self._slot_of(seg, p, b, nb, piece_in.dtype)
                for p in range(comm.size)]
        out[:] = self._fold(arrs, op).reshape(-1)
        seg.flag_done(comm.rank, g)

    def _chunked_allreduce(self, comm, sarr, rb, op: Op) -> bool:
        """Slot-sized pieces; each P-divisible piece runs as
        reduce_scatter + allgather so the fold work is SPLIT across
        ranks (the rabenseifner decomposition on a shared segment):
        every-rank-folds costs ~(P+1)*nb of memory traffic per rank
        per piece, the split form ~4*nb — the difference between a
        214 ms and a ~38 ms 8 MiB software allreduce on a 1-core
        host.  Non-divisible tails take the plain allreduce round.
        Returns False (caller falls back) when the slot cannot hold
        even one P-element piece."""
        P = comm.size
        slot = _slot_var.value
        flat_in = np.ascontiguousarray(sarr).reshape(-1)
        per = (slot // flat_in.itemsize) // P * P
        if per < P:
            return False  # slot too small for any P-divisible piece
        contig_out = rb.arr.reshape(-1)  # typed() arrs are contiguous
        codes = _nat_codes(_K_ALLREDUCE, op, flat_in.dtype)
        for lo in range(0, flat_in.size, per):
            hi = min(lo + per, flat_in.size)
            n = hi - lo
            # tail audit (count % segsize != 0, any dtype): only the
            # ragged REMAINDER (< P elements) may take the every-rank-
            # folds round — a non-divisible tail piece still runs its
            # P-divisible head as rs+ag.  head/n depend only on
            # (count, slot, P): identical on every rank, so the round
            # structure stays comm-consistent.
            head = n // P * P
            if codes is not None and head >= P:
                piece_in = np.ascontiguousarray(flat_in[lo:lo + head])
                stripe = np.empty(head // P, flat_in.dtype)
                self._rs_round(comm, piece_in, stripe, op, codes)
                self._ag_round(comm, stripe, contig_out[lo:lo + head])
                lo += head
                n -= head
            if n:
                self._allreduce_round(
                    comm, np.ascontiguousarray(flat_in[lo:hi]),
                    contig_out[lo:hi], op, codes)
        rb.flush()
        return True

    def _chunked_bcast(self, comm, tb, root: int) -> bool:
        slot = _slot_var.value
        buf = tb.arr.reshape(-1)  # typed() arrs are contiguous
        per = slot // buf.itemsize
        if per < 1:
            return False  # slot smaller than one element
        for lo in range(0, buf.size, per):
            hi = min(lo + per, buf.size)
            piece = np.ascontiguousarray(buf[lo:hi])
            nb = piece.nbytes
            if comm.rank == root:
                handled = self._native_run(
                    comm, _K_BCAST, root, piece, None, nb, (0, 99))
            else:
                handled = self._native_run(
                    comm, _K_BCAST, root, None, piece, nb, (0, 99))
            if not handled:
                seg, g, b = self._enter(comm)
                if comm.rank == root:
                    self._post(seg, comm, g, b, piece, wake=True)
                else:
                    self._wait_ge(comm, seg.seq32[root:root + 1, b],
                                  lambda i: seg.seq_addr(root, b), g,
                                  f"chunked bcast gen {g}")
                    piece[:] = self._slot_of(seg, root, b, nb,
                                             piece.dtype)
                seg.flag_done(comm.rank, g)
            # piece is a VIEW of contiguous buf: non-root receives
            # landed in place already
        return True

    # -- collectives -----------------------------------------------------
    def barrier(self, comm) -> None:
        if comm.size == 1:
            return
        if not self._seg_ok(comm):
            return super().barrier(comm)
        if self._native_run(comm, _K_BARRIER, 0, None, None, 0,
                            (0, 99)):
            return
        seg, g, b = self._enter(comm)
        self._post(seg, comm, g, b, None)
        self._wait_posted(comm, seg, b, g, f"barrier gen {g}")
        seg.flag_done(comm.rank, g)

    def _fits(self, nbytes: int) -> bool:
        return nbytes <= _slot_var.value

    def bcast(self, comm, buf, count, datatype, root) -> None:
        if comm.size == 1 or count == 0:
            return
        nbytes = count * datatype.size
        if not self._seg_ok(comm):
            return super().bcast(comm, buf, count, datatype, root)
        if not self._fits(nbytes):
            tb = typed(buf, count, datatype, writable=True)
            if self._chunked_bcast(comm, tb, root):
                tb.flush()
                return
            return super().bcast(comm, buf, count, datatype, root)
        tb = typed(buf, count, datatype, writable=True)
        if _seg_lib() is not None:
            if comm.rank == root:
                src_c = np.ascontiguousarray(tb.arr)
                handled = self._native_run(
                    comm, _K_BCAST, root, src_c, None, nbytes, (0, 99))
            else:
                out_c = tb.arr if tb.arr.flags.c_contiguous \
                    else np.empty_like(tb.arr)
                handled = self._native_run(
                    comm, _K_BCAST, root, None, out_c, nbytes, (0, 99))
                if handled:
                    if out_c is not tb.arr:
                        tb.arr[:] = out_c
                    tb.flush()
            if handled:
                return
        seg, g, b = self._enter(comm)
        if comm.rank == root:
            self._post(seg, comm, g, b, tb.arr, wake=True)
            # root is NOT done until its payload is flagged; readers'
            # bank-reuse guard (done >= g-2) protects the data
            seg.flag_done(comm.rank, g)
        else:
            self._wait_ge(comm, seg.seq32[root:root + 1, b],
                          lambda i: seg.seq_addr(root, b), g,
                          f"bcast gen {g}")
            flat = self._slot_of(seg, root, b, nbytes, np.uint8)
            tb.arr.view(np.uint8).reshape(-1)[:] = flat
            tb.flush()
            seg.flag_done(comm.rank, g)

    def _fast_allreduce(self, comm, plan, sbuf, rbuf) -> bool:
        """Repeat small allreduce with the SAME (datatype, op, count)
        on plain contiguous arrays: one cached-plan C call, none of
        the typed()/eligibility/codes machinery.  On a 1-core host
        the per-rank CPython prologue is serialized P times per op —
        it IS the small-message latency."""
        (dt_ref, op_ref, count, prim, nbytes, dtc, opc, seg,
         size, slot, rank) = plan
        if not (type(sbuf) is np.ndarray and type(rbuf) is np.ndarray
                and sbuf.dtype == prim and rbuf.dtype == prim
                and sbuf.size == count and rbuf.size == count
                and sbuf.flags.c_contiguous
                and rbuf.flags.c_contiguous):
            return False
        seg.gen += 1
        g = seg.gen
        call = (seg._base, size, slot, rank, g, _K_ALLREDUCE, 0,
                sbuf.ctypes.data, rbuf.ctypes.data, nbytes, dtc, opc,
                2000)
        r = seg.fn(*call)
        if r == 0:
            _pvar_native.add(1)
            return True
        if r < 0:
            seg.gen -= 1
            return False
        self._native_reenter(comm, seg, g, call)
        return True

    def allreduce(self, comm, sbuf, rbuf, count, datatype,
                  op: Op) -> None:
        plan = comm.__dict__.get("_seg_ar_plan")
        if plan is not None and plan[0] is datatype and plan[1] is op \
                and plan[2] == count \
                and self._fast_allreduce(comm, plan, sbuf, rbuf):
            return
        nbytes = count * datatype.size
        rb = typed(rbuf, count, datatype, writable=True)
        sarr = rb.arr.copy() if sbuf is IN_PLACE \
            else typed(sbuf, count, datatype).arr
        if comm.size == 1:
            rb.arr[:] = sarr
            rb.flush()
            return
        if not self._seg_ok(comm) or not op.valid_for(sarr.dtype) \
                or count == 0:
            return super().allreduce(comm, sbuf, rbuf, count,
                                     datatype, op)
        if not self._fits(nbytes) or nbytes >= _rsag_min_var.value:
            # split-fold form (reduce_scatter + allgather pieces):
            # above ~1 MiB the every-rank-folds single round wastes
            # (P-1)x fold traffic; on an oversubscribed host this
            # still beats 2 log P sequential pml ring rounds by an
            # order of magnitude (the 64 MiB software allreduce was
            # ~0.4 s through the ring, ~0.28 s split)
            if self._chunked_allreduce(comm, sarr, rb, op):
                return
            return super().allreduce(comm, sbuf, rbuf, count,
                                     datatype, op)
        codes = _nat_codes(_K_ALLREDUCE, op, sarr.dtype)
        if codes is not None:
            sc = np.ascontiguousarray(sarr)
            out_c = rb.arr if (rb.arr.flags.c_contiguous
                               and rb.arr.dtype == sc.dtype) \
                else np.empty(sc.size, sc.dtype)
            if self._native_run(comm, _K_ALLREDUCE, 0, sc, out_c,
                                nbytes, codes):
                if out_c is not rb.arr:
                    rb.arr.reshape(-1)[:] = out_c.reshape(-1)
                rb.flush()
                # the native path worked for this (datatype, op,
                # count) on this comm: install the repeat fast path.
                # Holding the datatype/op refs pins their identity
                # (an `is` check can never alias a recycled id).
                seg = comm.__dict__.get("_coll_seg")
                if seg is not None and seg.fn is not None:
                    comm.__dict__["_seg_ar_plan"] = (
                        datatype, op, count, sc.dtype, nbytes,
                        codes[0], codes[1], seg, comm.size, seg.slot,
                        comm.rank)
                return
        seg, g, b = self._enter(comm)
        self._post(seg, comm, g, b, sarr)
        self._wait_posted(comm, seg, b, g, f"allreduce gen {g}")
        # every rank folds locally in rank order (deterministic left
        # fold = basic_linear order, bit-identical across members)
        arrs = [self._slot_of(seg, p, b, nbytes, sarr.dtype)
                for p in range(comm.size)]
        out = self._fold(arrs, op)
        rb.arr.reshape(-1)[:] = out.reshape(-1)
        rb.flush()
        seg.flag_done(comm.rank, g)

    def reduce(self, comm, sbuf, rbuf, count, datatype, op: Op,
               root) -> None:
        nbytes = count * datatype.size
        rb = typed(rbuf, count, datatype, writable=True) \
            if comm.rank == root else None
        sarr = rb.arr.copy() if sbuf is IN_PLACE \
            else typed(sbuf, count, datatype).arr
        if comm.size == 1:
            rb.arr[:] = sarr
            rb.flush()
            return
        if not self._seg_ok(comm) or not self._fits(nbytes) \
                or not op.valid_for(sarr.dtype) or count == 0:
            return super().reduce(comm, sbuf, rbuf, count, datatype,
                                  op, root)
        codes = _nat_codes(_K_REDUCE, op, sarr.dtype)
        if codes is not None:
            sc = np.ascontiguousarray(sarr)
            out_c = None
            if comm.rank == root:
                out_c = rb.arr if (rb.arr.flags.c_contiguous
                                   and rb.arr.dtype == sc.dtype) \
                    else np.empty(sc.size, sc.dtype)
            if self._native_run(comm, _K_REDUCE, root, sc, out_c,
                                nbytes, codes):
                if rb is not None:
                    if out_c is not rb.arr:
                        rb.arr.reshape(-1)[:] = out_c.reshape(-1)
                    rb.flush()
                return
        seg, g, b = self._enter(comm)
        self._post(seg, comm, g, b, sarr)
        if comm.rank == root:
            self._wait_posted(comm, seg, b, g, f"reduce gen {g}")
            arrs = [self._slot_of(seg, p, b, nbytes, sarr.dtype)
                    for p in range(comm.size)]
            out = self._fold(arrs, op)
            rb.arr.reshape(-1)[:] = out.reshape(-1)
            rb.flush()
        seg.flag_done(comm.rank, g)

    def allgather(self, comm, sbuf, scount, sdtype, rbuf, rcount,
                  rdtype) -> None:
        if not self._seg_ok(comm):
            return super().allgather(comm, sbuf, scount, sdtype,
                                     rbuf, rcount, rdtype)
        rb = typed(rbuf, rcount * comm.size, rdtype, writable=True)
        n = rb.arr.size // comm.size
        if sbuf is IN_PLACE:
            sarr = rb.arr.reshape(-1)[comm.rank * n:(comm.rank + 1) * n].copy()
        else:
            sarr = typed(sbuf, scount, sdtype).arr
        nbytes = sarr.size * sarr.itemsize
        if not self._fits(nbytes):
            return super().allgather(comm, sbuf, scount, sdtype,
                                     rbuf, rcount, rdtype)
        if _seg_lib() is not None:
            sc = np.ascontiguousarray(sarr)
            contig = rb.arr.flags.c_contiguous
            flat = rb.arr.reshape(-1) if contig \
                else np.empty(rb.arr.size, rb.arr.dtype)
            if self._native_run(comm, _K_ALLGATHER, 0, sc, flat,
                                nbytes, (0, 99)):
                if not contig:
                    rb.arr.reshape(-1)[:] = flat
                rb.flush()
                return
        seg, g, b = self._enter(comm)
        self._post(seg, comm, g, b, sarr)
        self._wait_posted(comm, seg, b, g,
                              f"allgather gen {g}")
        flat = rb.arr.reshape(-1)
        for p in range(comm.size):
            flat[p * n:(p + 1) * n] = \
                self._slot_of(seg, p, b, nbytes, sarr.dtype)
        rb.flush()
        seg.flag_done(comm.rank, g)

    def alltoall(self, comm, sbuf, scount, sdtype, rbuf, rcount,
                 rdtype) -> None:
        if not self._seg_ok(comm) or sbuf is IN_PLACE:
            return super().alltoall(comm, sbuf, scount, sdtype,
                                    rbuf, rcount, rdtype)
        sarr = typed(sbuf, scount * comm.size, sdtype).arr
        nbytes = sarr.size * sarr.itemsize
        if not self._fits(nbytes):
            return super().alltoall(comm, sbuf, scount, sdtype,
                                    rbuf, rcount, rdtype)
        rb = typed(rbuf, rcount * comm.size, rdtype, writable=True)
        n = rb.arr.size // comm.size
        if _seg_lib() is not None:
            sc = np.ascontiguousarray(sarr)
            contig = rb.arr.flags.c_contiguous
            flat = rb.arr.reshape(-1) if contig \
                else np.empty(rb.arr.size, rb.arr.dtype)
            if self._native_run(comm, _K_ALLTOALL, 0, sc, flat,
                                nbytes, (0, 99)):
                if not contig:
                    rb.arr.reshape(-1)[:] = flat
                rb.flush()
                return
        seg, g, b = self._enter(comm)
        self._post(seg, comm, g, b, sarr)  # my full P-block row
        self._wait_posted(comm, seg, b, g,
                              f"alltoall gen {g}")
        flat = rb.arr.reshape(-1)
        for p in range(comm.size):
            row = self._slot_of(seg, p, b, nbytes, sarr.dtype)
            flat[p * n:(p + 1) * n] = \
                row.reshape(comm.size, n)[comm.rank]
        rb.flush()
        seg.flag_done(comm.rank, g)

    def reduce_scatter_block(self, comm, sbuf, rbuf, rcount,
                             datatype, op: Op) -> None:
        if not self._seg_ok(comm) or sbuf is IN_PLACE:
            return super().reduce_scatter_block(comm, sbuf, rbuf,
                                                rcount, datatype, op)
        sarr = typed(sbuf, rcount * comm.size, datatype).arr
        nbytes = sarr.size * sarr.itemsize
        if not self._fits(nbytes) or not op.valid_for(sarr.dtype):
            return super().reduce_scatter_block(comm, sbuf, rbuf,
                                                rcount, datatype, op)
        rb = typed(rbuf, rcount, datatype, writable=True)
        n = rb.arr.size
        codes = _nat_codes(_K_REDUCE_SCATTER, op, sarr.dtype)
        if codes is not None:
            sc = np.ascontiguousarray(sarr)
            out_c = rb.arr if (rb.arr.flags.c_contiguous
                               and rb.arr.dtype == sc.dtype) \
                else np.empty(rb.arr.size, sc.dtype)
            if self._native_run(comm, _K_REDUCE_SCATTER, 0, sc, out_c,
                                nbytes, codes):
                if out_c is not rb.arr:
                    rb.arr.reshape(-1)[:] = out_c.reshape(-1)
                rb.flush()
                return
        seg, g, b = self._enter(comm)
        self._post(seg, comm, g, b, sarr)
        self._wait_posted(comm, seg, b, g,
                              f"reduce_scatter_block gen {g}")
        lo, hi = comm.rank * n, (comm.rank + 1) * n
        arrs = [self._slot_of(seg, p, b, nbytes,
                              sarr.dtype).reshape(-1)[lo:hi]
                for p in range(comm.size)]
        out = self._fold(arrs, op)
        rb.arr.reshape(-1)[:] = out
        rb.flush()
        seg.flag_done(comm.rank, g)


class SegComponent(CollComponent):
    name = "seg"

    @property
    def priority(self) -> int:
        return _prio_var.value

    def comm_query(self, comm):
        rte = comm.state.rte
        if not getattr(rte, "session_dir", None):
            return None
        # publish once per rank: eligibility compares every member's
        # (node, session) pair — a dpm peer from another mpirun job
        # shares neither the session dir nor its segments
        st = comm.state
        if not getattr(st, "_seg_modex_done", False):
            try:
                rte.modex_put("seg_session", rte.session_dir)
                st._seg_modex_done = True
            except Exception:
                return None
        return (self.priority, SegCollModule())


coll_framework.add_component(SegComponent())
