"""Progress engine: the framework's hot polling loop.

Re-design of opal_progress (ref: opal/runtime/opal_progress.c:183-243)
plus the wait_sync completion primitive used by MPI_Wait
(ref: opal/threads/wait_sync.h:27,40,79-82).

Every rank owns one ``Progress``.  Transports and nonblocking
collective schedules register callbacks; blocking waits spin on
``progress()``.  High-priority callbacks fire every call; low-priority
callbacks every 8th call (the reference's opal_progress_lp_call_ratio
idea).  An optional idle yield keeps oversubscribed thread-ranks and
oversubscribed local processes fair, mirroring opal_progress_yield.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ompi_tpu_torch.mca.params import registry

_yield_var = registry.register(
    "opal", "progress", "yield_when_idle", True, bool,
    help="Call sched_yield (time.sleep(0)) when a progress sweep "
         "finds no events")
_lp_ratio_var = registry.register(
    "opal", "progress", "lp_call_ratio", 8, int,
    help="Low-priority callbacks run every Nth progress call")

import os as _os

# conservative import-time default: local ranks on THIS host vs local
# cores (multi-host jobs export TPUMPI_LOCAL_SIZE per node).  mpi_init
# refines per-state once the real local-rank count is known — env vars
# can't see thread-rank worlds (run_ranks, hostrun app shells).
_OVERSUBSCRIBED = (
    int(_os.environ.get("TPUMPI_LOCAL_SIZE",
                        _os.environ.get("TPUMPI_SIZE", "1")))
    > (_os.cpu_count() or 1))


class Progress:
    def __init__(self) -> None:
        self._callbacks: List[Callable[[], int]] = []
        self._lp_callbacks: List[Callable[[], int]] = []
        # immutable snapshots of the two lists, rebuilt on (un)register.
        # The hot sweep iterates these: no per-sweep list() copy (one
        # less allocation per sweep — Progress.progress is under the
        # hotpath audit), and mutation during a sweep stays safe
        # because the tuple being iterated can't change underneath us.
        self._cbs: tuple = ()
        self._lp_cbs: tuple = ()
        self._counter = 0
        self._lock = threading.Lock()
        # armed by the ft watcher (runtime/ft.py): the next progress
        # sweep raises it out of whatever blocking wait the rank is
        # parked in — the only way to interrupt a collective whose
        # peers died.  Recovery disarms before rebuilding.
        self.interrupt: Optional[BaseException] = None
        # finalize teardown sets this: a JobRecovery armed by the
        # watcher after the app's last collective must not escape
        # MPI_Finalize as an unrelated error — there is nothing left
        # to recover (ADVICE r5 #5).  Once set, armed interrupts are
        # discarded.
        self.suppress_interrupts = False
        # checkpoint writes bump this: the interrupt stays ARMED but
        # is not raised until the counter drops back to zero, so a
        # recovery signal can never tear a half-written checkpoint.
        self.defer_interrupts = 0
        self.oversubscribed = _OVERSUBSCRIBED
        # Doorbell peers ring when they enqueue work for this rank, so
        # a rank parked in WaitSync wakes immediately instead of
        # polling (the wait_sync condvar signal in the reference).
        self.doorbell = threading.Event()
        # poll_mode: at least one transport is poll-only (shm rings,
        # tcp sockets across processes) — nobody can ring the
        # doorbell, so blocked waits must keep polling with short
        # backoff instead of parking.
        self.poll_mode = False
        # Idle selector: transports register kernel-wakeable fds (shm
        # doorbell FIFOs, tcp sockets) so an idle rank BLOCKS in
        # select() and the kernel schedules it the instant a peer
        # enqueues work — the cross-process analog of the reference's
        # libevent-blocking opal_progress when no btl needs polling.
        # Critical on oversubscribed hosts: sched_yield spinning burns
        # whole CFS quanta (~ms) before the rank holding our message
        # runs; an fd wakeup context-switches in ~10 us.
        self._idle_sel = None
        self._idle_drains: dict = {}
        self._wake_wfd = -1  # self-pipe write end (thread wakeups)
        # park hooks: transports publish "this rank is parked" so
        # senders skip the doorbell syscall (and its wake-preemption)
        # while we're awake and polling anyway (futex-style protocol)
        self._park_set: list = []
        self._park_clear: list = []
        # finalize hooks: subsystems with pending deferred work (fused
        # device collectives, the device dispatcher queue) flush here.
        # mpi_finalize runs them BEFORE the finalize fence so a flush
        # that needs a cross-rank rendezvous still has live peers.
        self._finalize_hooks: List[Callable[[], None]] = []
        # span tracer (ompi_tpu_torch/trace): set by mpi_init when
        # trace_enable; every sweep then feeds the progress-tick
        # latency histogram.  None = one is-None check per sweep.
        self.tracer = None
        # telemetry scraper (ompi_tpu_torch/obs): set by obs.attach when
        # obs_scrape_interval_ms > 0 and a tracer is on; ticked only on
        # the tracer's sampled sweeps with the timestamp already read
        self.obs = None
        # fleet controller (ompi_tpu_torch/serve): set by the resident
        # pool on its sessions' ranks; ticked on the same sampled sweeps
        # as the scraper (one extra is-None check), while the pool's
        # heartbeat loop covers the idle pool
        self.ctrl = None

    def deferred_interrupts(self):
        """Context manager: hold any armed ft interrupt until exit.
        Nestable; the pending exception fires on the first progress
        sweep after the outermost exit."""
        import contextlib

        @contextlib.contextmanager
        def _hold():
            self.defer_interrupts += 1
            try:
                yield
            finally:
                self.defer_interrupts -= 1
        return _hold()

    def register_park_hooks(self, set_cb, clear_cb) -> None:
        self._park_set.append(set_cb)
        self._park_clear.append(clear_cb)

    def unregister_park_hooks(self, set_cb, clear_cb) -> None:
        """Transports must remove their hooks at finalize: a stale
        hook dereferences freed transport state on any later idle
        park."""
        if set_cb in self._park_set:
            self._park_set.remove(set_cb)
        if clear_cb in self._park_clear:
            self._park_clear.remove(clear_cb)

    def register_idle_fd(self, fd: int, drain: Callable[[], None] | None = None) -> None:
        import selectors
        if self._idle_sel is None:
            self._idle_sel = selectors.DefaultSelector()
        try:
            self._idle_sel.register(fd, selectors.EVENT_READ)
        except KeyError:
            # stale entry for a reused fd number (a transport socket
            # closed without unregistering — injected sever): replace
            # it, and drop the dead owner's drain hook
            try:
                self._idle_sel.unregister(fd)
                self._idle_sel.register(fd, selectors.EVENT_READ)
            except (KeyError, ValueError, OSError):
                return
            self._idle_drains.pop(fd, None)
        except (ValueError, OSError):
            return
        if drain is not None:
            self._idle_drains[fd] = drain

    def unregister_idle_fd(self, fd: int) -> None:
        if self._idle_sel is not None:
            try:
                self._idle_sel.unregister(fd)
            except (KeyError, ValueError, OSError):
                pass
        self._idle_drains.pop(fd, None)

    def enable_thread_wakeup(self) -> None:
        """Self-pipe so same-process threads (inproc btl) can wake a
        rank parked in idle_wait."""
        if self._wake_wfd >= 0:
            return
        import os
        r, w = os.pipe()
        os.set_blocking(r, False)
        os.set_blocking(w, False)
        self._wake_wfd = w
        self.register_idle_fd(r, drain=lambda: self._drain_pipe(r))

    def _drain_pipe(self, fd: int) -> None:
        import os
        try:
            while os.read(fd, 4096):
                pass
        except (BlockingIOError, OSError):
            pass

    def idle_wait(self, timeout: float) -> None:
        """Block until a registered fd becomes readable (or timeout).
        Drains doorbell bytes; the caller re-sweeps progress()."""
        sel = self._idle_sel
        if sel is None or not sel.get_map():
            time.sleep(min(timeout, 0.0002))
            return
        if self._park_set:
            # publish parked BEFORE the final sweep: a sender that
            # pushes after our sweep will see the flag and ring the
            # doorbell; one that pushed before is caught by the sweep
            for cb in self._park_set:
                cb()
            if self.progress():
                for cb in self._park_clear:
                    cb()
                return
        try:
            for key, _ in sel.select(timeout):
                drain = self._idle_drains.get(key.fd)
                if drain is not None:
                    drain()
        finally:
            for cb in self._park_clear:
                cb()

    @property
    def has_idle_fds(self) -> bool:
        return self._idle_sel is not None and bool(self._idle_sel.get_map())

    def wakeup(self) -> None:
        self.doorbell.set()
        if self._wake_wfd >= 0:
            import os
            try:
                os.write(self._wake_wfd, b"\x01")
            except (BlockingIOError, OSError):
                pass

    def register_finalize_hook(self, cb: Callable[[], None]) -> None:
        """Idempotent: re-registering the same callable is a no-op."""
        with self._lock:
            if cb not in self._finalize_hooks:
                self._finalize_hooks.append(cb)

    def run_finalize_hooks(self) -> None:
        """Run and clear all finalize hooks.  Every hook runs even if
        an earlier one raises; the first error is re-raised after."""
        with self._lock:
            hooks, self._finalize_hooks = self._finalize_hooks, []
        first: Optional[BaseException] = None
        for cb in hooks:
            try:
                cb()
            except BaseException as e:  # noqa: BLE001
                if first is None:
                    first = e
        if first is not None:
            raise first

    def register(self, cb: Callable[[], int], low_priority: bool = False) -> None:
        with self._lock:
            if low_priority:
                self._lp_callbacks.append(cb)
            else:
                self._callbacks.append(cb)
            self._snapshot()

    def unregister(self, cb: Callable[[], int]) -> None:
        with self._lock:
            if cb in self._callbacks:
                self._callbacks.remove(cb)
            if cb in self._lp_callbacks:
                self._lp_callbacks.remove(cb)
            self._snapshot()

    def _snapshot(self) -> None:
        # caller holds self._lock
        self._cbs = tuple(self._callbacks)
        self._lp_cbs = tuple(self._lp_callbacks)

    def progress(self) -> int:
        """One sweep; returns number of events completed.

        Never yields or sleeps: a sweep must cost microseconds so
        blocking loops can spin a few times then park (idle_tick /
        WaitSync).  An implicit sched_yield here costs a whole CFS
        quantum (~200 us measured) per call on oversubscribed hosts.
        """
        if self.interrupt is not None:
            if self.suppress_interrupts:
                self.interrupt = None
            elif not self.defer_interrupts:
                exc = self.interrupt
                self.interrupt = None
                raise exc
        tr = self.tracer
        if tr is not None:
            # SAMPLED tick timing (1 in 16): a blocked rank spins this
            # loop thousands of times a second, and two clock reads
            # per sweep measurably slow every other rank thread
            _t0 = time.perf_counter_ns() if (self._counter & 15) == 0 \
                else 0
        self._counter += 1
        events = 0
        for cb in self._cbs:
            events += cb()
        if self._lp_cbs and self._counter % max(1, _lp_ratio_var.value) == 0:
            for cb in self._lp_cbs:
                events += cb()
        if tr is not None and _t0:
            # the scrape tick rides 1 in 16 of the sampled sweeps (1 in
            # 256 overall), before the tick-end read so that a
            # refresh's copy lands in the progress_tick histogram
            if (self._counter & 255) == 1:
                obs = self.obs
                if obs is not None:
                    obs.tick(_t0)
                ctrl = self.ctrl
                if ctrl is not None:
                    ctrl.tick(_t0)
            tr.tick_ns(time.perf_counter_ns() - _t0)
        return events

    def idle_tick(self, timeout: float = 0.002) -> None:
        """Call after a zero-event sweep in a blocking spin loop:
        parks on the idle selector when transports registered wakeup
        fds, else yields the core (opal_progress_yield analog)."""
        if self.has_idle_fds:
            self.idle_wait(timeout)
        elif _yield_var.value:
            time.sleep(0)


class WaitSync:
    """Completion object a blocking wait parks on.

    The reference spins on opal_progress() single-threaded and blocks
    on a pthread condvar under MPI_THREAD_MULTIPLE
    (ref: opal/threads/wait_sync.c:84).  Here completions may arrive
    from a peer rank-thread (inproc btl) or from our own progress
    sweeps, so we spin on progress with a short adaptive backoff and
    an Event for cross-thread wakeups.
    """

    __slots__ = ("_count",)

    def __init__(self, count: int = 1) -> None:
        # A bare counter, no Event: completions always run in the
        # owning rank's thread (actor model), so the waiter observes
        # the decrement directly; cross-thread producers wake us via
        # the progress doorbell / idle fds, never this object.  Keeps
        # request allocation to one int (requests are per-message).
        self._count = count

    def signal(self, n: int = 1) -> None:
        self._count -= n

    @property
    def done(self) -> bool:
        return self._count <= 0

    def wait(self, progress: Progress, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        park = 2 if progress.oversubscribed else 50
        while self._count > 0:
            if progress.progress() == 0:
                spins += 1
                if progress.has_idle_fds:
                    # kernel-wakeable transports: park in select()
                    # after a short spin; peers ring the fd doorbell
                    # the instant they enqueue (essential on
                    # oversubscribed hosts where yield-spinning
                    # burns whole scheduler quanta)
                    if spins > park:
                        progress.idle_wait(0.002)
                        spins = 0
                elif progress.poll_mode:
                    # poll-only transports.  Oversubscribed hosts
                    # (ranks > cores) need aggressive yielding or every
                    # blocked rank burns a scheduler timeslice before
                    # the rank holding our message runs (the reference
                    # auto-sets yield_when_idle for oversubscription).
                    if progress.oversubscribed:
                        if spins > 4:
                            time.sleep(0)  # sched_yield to peers
                    elif spins > 5000:
                        time.sleep(0.0002)
                        spins = 0
                elif progress.oversubscribed and spins > 4:
                    # thread-ranks sharing too few cores: park early on
                    # the doorbell instead of spinning down a shared
                    # core (the convoy shows up as multi-ms latency
                    # spikes on small messages)
                    progress.doorbell.clear()
                    if progress.progress() == 0 and self._count > 0:
                        progress.doorbell.wait(0.005)
                    spins = 0
                elif spins > 200:
                    # Park on the doorbell; peers ring it when they
                    # enqueue frags for us (cross-thread wakeup).
                    progress.doorbell.clear()
                    if progress.progress() == 0 and self._count > 0:
                        progress.doorbell.wait(0.01)
                    spins = 0
            else:
                spins = 0
            if deadline is not None and time.monotonic() > deadline:
                return self._count <= 0
        return True
