"""Shared-memory BTL: mmap'd SPSC byte rings between co-located
process-ranks.

Re-design of the vader btl (ref: opal/mca/btl/vader/btl_vader_module.c
— per-peer fast boxes in a shared segment; segment mgmt ref:
opal/mca/shmem mmap component).  Each ordered pair (src → dst) owns
one ring file in the session directory:

    [0:8)   head — producer write cursor (monotonic, bytes)
    [8:16)  tail — consumer read cursor (monotonic, bytes)
    [16:)   data — capacity ring, frames of 4-byte length + payload

Single producer / single consumer, so the only ordering requirement
is data-before-head on the producer and data-read-before-tail on the
consumer — x86 TSO plus numpy's single-store index updates satisfy
it (the C++ native ring in native/ is the hardened version).

Frames carry wire-codec frags (ompi_tpu_torch/btl/wire): a fixed binary
header + raw payload written into the ring as two parts, so payload
bytes are copied exactly once producer-side (into the ring) and once
consumer-side (out of it) — no serialization copies.
"""

from __future__ import annotations

import mmap
import os
import struct
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ompi_tpu_torch.mca.params import registry
from . import wire
from .base import BTLComponent, BTLModule, btl_framework

_ring_var = registry.register(
    "btl", "shm", "ring_size", 8 * 1024 * 1024, int,
    help="Per-direction ring capacity in bytes")
_eager_var = registry.register(
    "btl", "shm", "eager_limit", 32 * 1024, int,
    help="Max bytes sent eagerly over shared memory")
_max_send_var = registry.register(
    "btl", "shm", "max_send_size", 256 * 1024, int,
    help="Rendezvous segment size over shared memory")

_HDR = 16


class Ring:
    """One direction of a pair; producer or consumer view.

    Uses the native C++ ring (ompi_tpu_torch.native, real acquire/release
    atomics) when built; byte layout is identical either way, so a
    native producer interoperates with a Python consumer."""

    def __init__(self, path: str, create: bool) -> None:
        self.cap = _ring_var.value
        total = _HDR + self.cap
        if create:
            # atomic create: size the file under a temp name, then
            # rename — attachers poll for existence (dpm peers attach
            # at arbitrary times) and must never see a short file
            tmp = f"{path}.tmp.{os.getpid()}"
            fd = os.open(tmp, os.O_CREAT | os.O_RDWR, 0o600)
            os.ftruncate(fd, total)
            os.rename(tmp, path)
        else:
            fd = os.open(path, os.O_RDWR)
            if os.fstat(fd).st_size < total:
                os.close(fd)
                raise FileNotFoundError(f"ring {path} not ready")
        self.mm = mmap.mmap(fd, total)
        os.close(fd)
        self.idx = np.frombuffer(self.mm, dtype=np.uint64, count=2)
        self.data = np.frombuffer(self.mm, dtype=np.uint8, offset=_HDR)
        from ompi_tpu_torch import native as _native
        self._lib = _native.load()
        if self._lib is not None:
            import ctypes
            u8p = ctypes.POINTER(ctypes.c_uint8)
            self._cbase = ctypes.cast(
                ctypes.addressof(ctypes.c_uint8.from_buffer(self.mm)), u8p)
            self._u8p = u8p
            self._ctypes = ctypes

    def push_native(self, frame: bytes) -> bool:
        ct = self._ctypes
        buf = ct.cast(ct.c_char_p(frame), self._u8p)
        return bool(self._lib.tpumpi_ring_push(
            self._cbase, self.cap, buf, len(frame)))

    def push2_native(self, hdr: bytes, payload: bytes) -> bool:
        ct = self._ctypes
        b1 = ct.cast(ct.c_char_p(hdr), self._u8p)
        b2 = ct.cast(ct.c_char_p(payload), self._u8p)
        return bool(self._lib.tpumpi_ring_push2(
            self._cbase, self.cap, b1, len(hdr), b2, len(payload)))

    def pop_native(self) -> Optional[bytes]:
        ln = self._lib.tpumpi_ring_peek(self._cbase, self.cap)
        if ln < 0:
            return None
        out = bytearray(ln)
        ct = self._ctypes
        optr = ct.cast(ct.addressof(ct.c_uint8.from_buffer(out)),
                       self._u8p) if ln else ct.cast(0, self._u8p)
        if not self._lib.tpumpi_ring_pop(self._cbase, self.cap, optr, ln):
            return None
        return bytes(out)

    @property
    def head(self) -> int:
        return int(self.idx[0])

    @property
    def tail(self) -> int:
        return int(self.idx[1])

    def free_space(self) -> int:
        return self.cap - (self.head - self.tail)

    def push(self, frame: bytes) -> bool:
        return self.push_parts(frame, b"")

    def push_parts(self, hdr: bytes, payload) -> bool:
        """Write one frame given as header + payload parts, copying
        each part straight into the ring (no concat)."""
        ln = len(hdr) + len(payload)
        if 4 + ln > self.cap:
            raise ValueError(
                f"frame of {ln} bytes can never fit the "
                f"{self.cap}-byte shm ring; raise btl_shm_ring_size, "
                "or lower the producer's frame size "
                "(btl_shm_max_send_size for byte streams, "
                "btl_tpu_chunk_bytes for device-array payloads — "
                "object frags are not split by the btl)")
        if self._lib is not None:
            if not payload:
                return self.push_native(hdr)
            if not isinstance(payload, bytes):
                payload = memoryview(payload).tobytes()
            return self.push2_native(hdr, payload)
        need = 4 + ln
        if need > self.free_space():
            return False
        pos = self.head
        self._write(pos, struct.pack(">I", ln))
        self._write(pos + 4, hdr)
        if len(payload):
            self._write(pos + 4 + len(hdr), payload)
        # data written before the head store (x86 TSO keeps order)
        self.idx[0] = pos + need
        return True

    def _write(self, abspos: int, buf) -> None:
        pos = abspos % self.cap
        n = len(buf)
        src = np.frombuffer(buf, np.uint8) if isinstance(buf, bytes) \
            else np.frombuffer(memoryview(buf).cast("B"), np.uint8)
        first = min(n, self.cap - pos)
        self.data[pos:pos + first] = src[:first]
        if first < n:
            self.data[:n - first] = src[first:]

    def pop(self) -> Optional[bytes]:
        if self._lib is not None:
            return self.pop_native()
        avail = self.head - self.tail
        if avail < 4:
            return None
        pos = self.tail % self.cap
        hdr = self._read(pos, 4)
        (ln,) = struct.unpack(">I", hdr)
        if avail < 4 + ln:
            return None  # frame still being written
        frame = self._read((pos + 4) % self.cap, ln)
        self.idx[1] = self.tail + 4 + ln
        return frame

    def _read(self, pos: int, n: int) -> bytes:
        first = min(n, self.cap - pos)
        out = self.data[pos:pos + first].tobytes()
        if first < n:
            out += self.data[:n - first].tobytes()
        return out


class ShmModule(BTLModule):
    name = "shm"
    exclusivity = 50

    def __init__(self, state) -> None:
        self.state = state
        self.eager_limit = _eager_var.value
        self.max_send_size = _max_send_var.value
        self.session = state.rte.session_dir
        self.rank = state.rank
        self.node = getattr(state.rte, "node_id", 0)
        self._tx: Dict[int, Ring] = {}
        self._rx: Dict[int, Ring] = {}
        self._pending: Dict[int, deque] = {}
        self._peer_nodes: Dict[int, int] = {}
        # create my outbound rings up front (peers attach after fence)
        for peer in range(state.size):
            if peer != self.rank:
                Ring(self._path(self.rank, peer), create=True)
        # Doorbell FIFO: senders write one byte after pushing so a
        # rank parked in the idle selector wakes via the kernel
        # instead of burning scheduler quanta polling (the fd-wakeup
        # analog of vader's "fast box + pending queue" signalling).
        self._db_rfd = -1
        self._db_wfds: Dict[int, int] = {}
        db = self._db_path(self.rank)
        try:
            if not os.path.exists(db):
                os.mkfifo(db, 0o600)
            self._db_rfd = os.open(db, os.O_RDONLY | os.O_NONBLOCK)
            state.progress.register_idle_fd(
                self._db_rfd, drain=self._drain_doorbell)
        except OSError:
            self._db_rfd = -1  # fall back to pure polling
        # Parked flags: one shared byte per rank.  A sender only pays
        # the doorbell write (and its wake-preemption) when the target
        # is actually parked in select(); while it polls, a flag load
        # suffices (futex-style: set flag -> one more sweep -> sleep).
        self._parked = None
        try:
            pf = os.path.join(self.session, "shm_parked.flags")
            fd = os.open(pf, os.O_CREAT | os.O_RDWR, 0o600)
            if os.fstat(fd).st_size < state.size:
                os.ftruncate(fd, state.size)
            self._parked_mm = mmap.mmap(fd, state.size)
            os.close(fd)
            self._parked = self._parked_mm
            state.progress.register_park_hooks(
                self._park_set, self._park_clear)
        except OSError:
            self._parked = None
        state.progress.register(self.progress)
        state.progress.poll_mode = True

    def _db_path(self, rank: int) -> str:
        return os.path.join(self.session, f"shm_db_{rank}.fifo")

    def _drain_doorbell(self) -> None:
        try:
            while os.read(self._db_rfd, 4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def _park_set(self) -> None:
        self._parked[self.rank] = 1

    def _park_clear(self) -> None:
        self._parked[self.rank] = 0

    def _ring_doorbell(self, peer: int) -> None:
        if self._parked is not None and peer < len(self._parked) \
                and not self._parked[peer]:
            return  # peer is awake and polling; no syscall needed
        fd = self._db_wfds.get(peer)
        if fd is None:
            try:
                fd = os.open(self._db_path(peer),
                             os.O_WRONLY | os.O_NONBLOCK)
            except OSError:
                return  # peer not parked yet (no reader) or no fifo
            self._db_wfds[peer] = fd
        try:
            os.write(fd, b"\x01")
        except (BlockingIOError, OSError):
            pass  # pipe full = peer has wakeups pending already

    def _path(self, src: int, dst: int) -> str:
        return os.path.join(self.session, f"shm_ring_{src}_{dst}.buf")

    def _tx_ring(self, peer: int) -> Ring:
        r = self._tx.get(peer)
        if r is None:
            r = Ring(self._path(self.rank, peer), create=False)
            self._tx[peer] = r
        return r

    def _rx_ring(self, peer: int) -> Ring:
        r = self._rx.get(peer)
        if r is None:
            path = self._path(peer, self.rank)
            try:
                r = Ring(path, create=False)
            except FileNotFoundError:
                return None  # peer not up yet
            self._rx[peer] = r
        return r

    def reaches(self, peer: int) -> bool:
        if peer == self.rank:
            return True
        node = self._peer_nodes.get(peer)
        if node is None:
            node = self.state.rte.modex_get(peer, "node_id")
            self._peer_nodes[peer] = node
        return node == self.node

    def extend(self, new_size: int) -> None:
        """Dynamic peers (dpm spawn): create my outbound rings toward
        the new universe ranks; inbound rings attach lazily as usual
        (progress polls up to state.size, which the caller updated)."""
        for peer in range(new_size):
            if peer != self.rank:
                path = self._path(self.rank, peer)
                if not os.path.exists(path):
                    Ring(path, create=True)

    def send(self, peer: int, frag) -> None:
        hdr, payload = wire.encode(frag)
        if payload is None:
            payload = b""
        q = self._pending.setdefault(peer, deque())
        if not q and self._tx_ring(peer).push_parts(hdr, payload):
            self._ring_doorbell(peer)
            return
        q.append((hdr, payload))

    def progress(self) -> int:
        events = 0
        # drain pending sends (backpressure released by the consumer)
        for peer, q in self._pending.items():
            ring = self._tx_ring(peer)
            pushed = False
            while q and ring.push_parts(*q[0]):
                q.popleft()
                pushed = True
                events += 1
            if pushed:
                self._ring_doorbell(peer)
        # poll every attached inbound ring
        inbox = self.state.pml.inbox
        for peer in range(self.state.size):
            if peer == self.rank:
                continue
            ring = self._rx_ring(peer)
            if ring is None:
                continue
            while True:
                frame = ring.pop()
                if frame is None:
                    break
                inbox.append(wire.decode(frame, copy=False))
                events += 1
        return events

    def ft_reset(self, epoch: int) -> bool:
        """Live-recovery epoch reset: the shm module RETIRES.  Its
        rings may still hold pre-epoch frames, and draining a stale
        frame into a reset sequence space would poison matching —
        post-recovery cross-process traffic rides the tcp btl, whose
        socket teardown kills stale bytes for free.  Full teardown
        (finalize clears the parked flag, unhooks the park callbacks
        and doorbell fd, closes rings — recovery drops the module
        from state.btls, so MPI_Finalize would never reach it).
        Returns False: drop this module from service."""
        try:
            self.state.progress.unregister(self.progress)
        except (AttributeError, ValueError):
            pass
        try:
            self.finalize()
        except (OSError, ValueError):
            pass
        return False

    def finalize(self) -> None:
        if self._parked is not None:
            # clear OUR parked byte first: a stale parked=1 flag makes
            # every surviving peer pay the doorbell syscall for a rank
            # that is gone.  Hooks come out of the
            # progress engine BEFORE the mmap closes — a stale hook
            # would dereference the freed mapping on a later park.
            self.state.progress.unregister_park_hooks(
                self._park_set, self._park_clear)
            try:
                self._parked[self.rank] = 0
                self._parked = None
                self._parked_mm.close()
            except (OSError, ValueError):
                pass
        if self._db_rfd >= 0:
            self.state.progress.unregister_idle_fd(self._db_rfd)
            try:
                os.close(self._db_rfd)
                os.unlink(self._db_path(self.rank))
            except OSError:
                pass
        for fd in self._db_wfds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        for peer in range(self.state.size):
            if peer != self.rank:
                try:
                    os.unlink(self._path(self.rank, peer))
                except OSError:
                    pass


class ShmComponent(BTLComponent):
    name = "shm"
    priority = 50

    def init_modules(self, state) -> List[BTLModule]:
        rte = state.rte
        if not hasattr(rte, "kv") or state.size == 1:
            return []
        rte.modex_put("node_id", getattr(rte, "node_id", 0))
        return [ShmModule(state)]


btl_framework.add_component(ShmComponent())
