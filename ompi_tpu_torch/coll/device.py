"""Device collectives: coll/hbm (intra-card stacked collectives) and
coll/tpu (the mesh tier, for ranks on distinct devices).

coll/hbm, the co-located analog of the reference's coll/sm (ref:
ompi/mca/coll/sm/coll_sm_module.c:102,167 — ranks on one node collect
in a shared segment): ranks sharing ONE card meet at a per-communicator
**rendezvous**.  Every member thread deposits its shard; the last
arriver runs one stacked kernel over all shards (kernels/stacked.py:
K1 stacked_reduce for the reductions, K2 stacked_copy for alltoall and
allgather) and hands each member its own output tensor.

coll/tpu, the port of the reference's ``TpuCollModule``: the members
own pairwise-distinct devices — cards of one host, or logical devices
of one card (``testing.logical_devices``).  Each collective is a
single-controller program: the last arriver (or the dispatcher thread)
holds every member's tensor, each on its member's device, and launches
the work for every device, each launch reading the peers' buffers
through their pointers (peer access across cards).  A reduction is a
reduce-scatter by pulls — K6 mesh_fold folding the stripe each device
owns in the reference's order — then an allgather of the stripes by
K2 in peer mode; alltoall and allgather are K2 peer launches; bcast
and ppermute are peer copies.  Each kernel takes a destination table,
so a body is ONE launch of each of its kernels a card, for every
member on that card (logical devices of one card share its stream).
On both tiers the cartesian neighbour gather (``neighbor_allgather_arr``)
is one K2 peer launch a member, zero-filling PROC_NULL blocks.

Ordering across rank threads and devices: PyTorch's current stream is
per thread and per device.  A depositor records an event on its
stream; the body's stream on EVERY device the deposits lie on waits on
every deposit's event before the launches and records one done event
after them; each member's stream waits on the done event of its own
device before it touches its output.  A launch that reads a buffer
another device wrote inside the same body (the mesh allreduce's
stripes) waits on that device's stream first (``_cross_fence``).  That
fence replaces the reference's ``_block_ready`` on the data path;
``_block_ready`` waits for its events only to end a traced op's
execute phase.

Large messages (at or above ``coll_pipeline_min_bytes``) take the
tiers of coll/pipeline and coll/plan: an allreduce runs as one plan
(one rendezvous) or, with ``coll_plan_enable`` off, as segments
through the asynchronous rendezvous (``meet_begin`` / ``meet_finish``,
the computation on the process-wide dispatcher thread); an alltoall
(and on the mesh a bcast) runs as segments.  Small nonblocking calls
coalesce in coll/fusion and meet once per batch with a (signature,
tensors) deposit.

Before a deposit enters the rendezvous (``meet``, ``meet_begin``) it
passes, in the reference's order, the ft_inject ``delay`` straggler,
the ``host_slow`` stall of a slow host's residents, the ``rdv_sever``
wedge (``_sever_hold``: the victim holds short of its deposit until
the world is poisoned, bounded by the rendezvous timeout), the
integrity gate (obs/integrity: a sampled op's deposit becomes a
``_Checked`` carrier, its body a checked body that verifies, bisects
and retries) and the ft_inject ``device_sdc`` flip.
``Rendezvous.snapshot`` is the hang doctor's view of a meeting (who
has deposited, who is absent).

Tracing (ompi_tpu_torch/trace): a traced ``meet`` records a ``meet``
span (cat ``coll_dispatch``) and a segment's ``meet_begin`` /
``meet_finish`` a ``seg_meet`` span (cat ``coll_segment``), keyed by
the comm's cid and its device sequence ``_dev_seq``, which every
member ticks in lockstep.  With ``trace_phase_enable`` an op that
samples in builds ONE phase ctx (tracer, cid, seq, nbytes) at the
gate, against the depositing rank's tracer; the rendezvous waits
record ``ph_rdv_wait`` on that tracer, and the body, on the last
arriver's thread or the dispatcher's, records ``ph_dispatch`` (the
launches) and ``ph_execute`` on the triggering rank's tracer; on a
card the deposit's ready event (``_fenced``) is a ``ph_pack`` and the
member's wait on the meeting's done event (``_collect``) a
``ph_unpack`` of the depositing rank (steps the reference has not).  The
execute phase ends when the done events ``_fence`` recorded complete
(``_block_ready``: an event a card, never a device-wide synchronize,
which would time the other rank threads' work too); a sampled-out op
keeps its launches asynchronous.

Not ported yet (ROADMAP.md Queue A): the compiled-executable cache
(``CompiledLRU``) and the monitoring hook of ``meet`` (A9's pml
monitoring).

Only host buffers ever take the host-staged p2p stack (HostArrModule):
structured pair types, which torch cannot hold, and user-defined ops,
which no kernel computes.  A tensor on a card is never staged through
the host: a call the kernels do not take (an invalid op/type pair, a
leading dimension the communicator size does not divide) raises, on
every member, HostArrModule refuses such a tensor outright, and a
communicator whose members partly share devices (8 ranks on 4 cards:
neither one device nor a mesh) is refused by every call.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as np
import torch

from ompi_tpu_torch import convert, ft_inject
from ompi_tpu_torch import trace as _trace
from ompi_tpu_torch.coll import pipeline
from ompi_tpu_torch.coll.framework import (CollComponent, CollModule,
                                           coll_framework)
from ompi_tpu_torch.coll.tuned import TunedModule
from ompi_tpu_torch.kernels import mesh, stacked
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.obs import integrity as _ig
from ompi_tpu_torch.op.op import Op
from ompi_tpu_torch.runtime.init import device_key

# trace ids as module constants: meet() runs once per device
# collective and must not pay module-attribute lookups for them
_CAT_DISP = _trace.CAT_COLL_DISPATCH
_CAT_SEG = _trace.CAT_COLL_SEGMENT
_NAME_MEET = _trace.NAME_MEET
_NAME_SEG_MEET = _trace.NAME_SEG_MEET
_CAT_PHASE = _trace.CAT_PHASE
_NAME_PH_RDV = _trace.NAME_PH_RDV
_NAME_PH_DISPATCH = _trace.NAME_PH_DISPATCH
_NAME_PH_EXECUTE = _trace.NAME_PH_EXECUTE
_NAME_PH_PACK = _trace.NAME_PH_PACK
_NAME_PH_UNPACK = _trace.NAME_PH_UNPACK
_HIST_RDV = _trace.HIST_RDV_WAIT

_prio_tpu = registry.register(
    "coll", "tpu", "priority", 80, int,
    help="Selection priority of the mesh-tier component (ranks on "
         "pairwise-distinct devices: cards, or logical devices)")
_prio_hbm = registry.register(
    "coll", "hbm", "priority", 70, int,
    help="Selection priority of the intra-card collective component")
_rv_poll_var = registry.register(
    "coll", "device", "rendezvous_poll", 0.25, float,
    help="Rendezvous wait poll interval in seconds (bounds abort "
         "latency for device collectives)")
_rv_timeout_var = registry.register(
    "coll", "device", "rendezvous_timeout", 300.0, float,
    help="Seconds a device-collective rendezvous may stall before "
         "raising (dead/diverged peer diagnosis)")
_dispatcher_var = registry.register(
    "coll", "device", "dispatcher", False, bool,
    help="Run every device-collective computation on one dedicated "
         "thread instead of the rendezvous's last arriver (the "
         "segmented pipeline always hands its segments to that "
         "thread)")
# the host fallback of neighbor_allgather_arr
T_NEIGHBOR_ARR = -122

_reduce_as_allreduce_var = registry.register(
    "coll", "device", "reduce_as_allreduce", True, bool,
    help="Lower reduce_arr as an on-device allreduce (computes "
         "everywhere, delivers at the root; keeps the result "
         "device-resident).  False routes reduce_arr to the "
         "host-staged true reduce.")

# ops the reference lowers to a native cross-replica reduction
# (psum/pmax/pmin); K6 folds them in rank order
_XLA_REDUCERS = {"MPI_SUM", "MPI_MAX", "MPI_MIN"}
# ops the reference lowers as all_gather + an on-device fold; K6 folds
# them in rank order too
_GATHER_FOLD = {"MPI_PROD", "MPI_LAND", "MPI_BAND", "MPI_LOR",
                "MPI_BOR", "MPI_LXOR", "MPI_BXOR"}

# dispatch kind -> integrity-plane spec kind
_CK_KINDS = {"allreduce": "allreduce", "reduce_scatter": "redscat",
             "allgather": "gather", "alltoall": "alltoall"}


def _ck(kind: str, opname: str, x, root: int = 0):
    """The integrity check spec of one collective: None when the plane
    is off or the op is not checkable (ppermute, another reduce op, an
    unchecked dtype)."""
    return _ig.spec(_CK_KINDS.get(kind, kind), opname, x, root) \
        if _ig.on else None


def _dtype_of(x) -> Optional[torch.dtype]:
    """The torch dtype of a tensor or numpy-like buffer, None when
    torch has no such dtype (structured pair types)."""
    if isinstance(x, torch.Tensor):
        return x.dtype
    dt = getattr(x, "dtype", None)
    try:
        return convert.torch_dtype(dt if dt is not None
                                   else np.asarray(x).dtype)
    except KeyError:
        return None


def _shape_of(x):
    sh = getattr(x, "shape", None)
    return tuple(sh) if sh is not None else np.asarray(x).shape


def _member_devices(comm) -> Optional[List[tuple]]:
    """Device key of every member (``runtime.init.device_key``: card
    and logical slot), or None when some member owns no device (or
    lives outside this process)."""
    keys = []
    for g in comm.group:
        st = comm._peer_state(g)
        if st is None or st.device is None:
            return None
        keys.append(device_key(st))
    return keys


class _DeviceDispatcher:
    """One thread per process that runs device-collective computations
    handed to it: every segment of the pipelined tier (so the rank
    threads pack the next segment while this thread launches the
    current one), and every meeting when ``coll_device_dispatcher``
    is on."""

    def __init__(self) -> None:
        import queue
        self.q: "queue.SimpleQueue" = queue.SimpleQueue()
        self.closed = False
        self._submit_lock = threading.Lock()
        self.thread = threading.Thread(
            target=self._loop, daemon=True, name="coll-device-dispatch")
        self.thread.start()

    def _loop(self) -> None:
        while True:
            work = self.q.get()
            if work is None:
                return
            work()  # never raises: work wraps its own error capture

    def submit(self, work: Callable[[], None]) -> None:
        # the lock orders submit against close(): a submit that wins
        # the race lands BEFORE the close sentinel and is flushed; one
        # that loses gets the clear error instead of silently dying
        # with the daemon thread
        with self._submit_lock:
            if self.closed:
                raise RuntimeError(
                    "device-collective dispatcher is closed (MPI "
                    "finalized): late collective work rejected — "
                    "pending work was flushed at finalize")
            self.q.put(work)

    def close(self, timeout: float = 10.0) -> None:
        """Drain at finalize: reject new submits, then run everything
        already queued and join the worker.  Pending submitted work
        must complete — rendezvous peers are parked on its results."""
        with self._submit_lock:
            if self.closed:
                return
            self.closed = True
            self.q.put(None)
        self.thread.join(timeout)


_dispatcher_singleton: Optional[_DeviceDispatcher] = None
_dispatcher_lock = threading.Lock()

# rank states that have used the device-collective plane this world;
# the LAST one to finalize drains the dispatcher (thread-rank worlds
# share one process-wide dispatcher across all ranks)
_live_states: Set[Any] = set()
_live_lock = threading.Lock()


def _prune_dead_locked() -> bool:
    """Drop tracked states that can never finalize — their world
    aborted, they were killed (``ulfm_dead``), or they already
    finalized — and report whether any live state remains.  Without
    the prune a killed rank would hold the dispatcher open for the
    rest of the process.  Caller holds _live_lock."""
    for s in list(_live_states):
        w = getattr(s.rte, "world", None)
        if s.finalized or s.ulfm_dead or getattr(w, "aborted", None):
            _live_states.discard(s)
    return bool(_live_states)


def _dispatcher() -> _DeviceDispatcher:
    global _dispatcher_singleton
    d = _dispatcher_singleton
    if d is not None and not d.closed:
        return d
    with _dispatcher_lock:
        d = _dispatcher_singleton
        if d is None or d.closed:
            with _live_lock:
                live = _prune_dead_locked()
            if d is not None and d.closed and not live:
                raise RuntimeError(
                    "device-collective dispatcher used after MPI "
                    "finalize (no live ranks): call MPI_Init first")
            # fresh world in the same process (tests run many): revive
            d = _dispatcher_singleton = _DeviceDispatcher()
    return d


def track_state(state) -> None:
    """First device-collective touch by a rank: register its finalize
    hook so pending fused batches flush and — when the LAST tracked
    rank finalizes — the dispatcher drains instead of dying with the
    daemon thread mid-work (finalize racing a last collective)."""
    if state.extra.get("device_coll_tracked"):
        return
    state.extra["device_coll_tracked"] = True
    with _live_lock:
        _live_states.add(state)
    state.progress.register_finalize_hook(
        functools.partial(_finalize_state, state))


def _finalize_state(state) -> None:
    # flush pending fused batches first: every member rank's hook runs
    # before its finalize fence, so the flush rendezvous still meets
    from ompi_tpu_torch.coll import fusion
    fusion.flush_state(state)
    with _live_lock:
        _live_states.discard(state)
        state.extra["device_coll_tracked"] = False
        last = not _prune_dead_locked()
    if last:
        with _dispatcher_lock:
            d = _dispatcher_singleton
        if d is not None:
            d.close()


# -- phase profiler helpers ----------------------------------------------------
# A "ph ctx" is the tuple (tracer, cid, seq, nbytes) a traced op builds
# ONCE — only when tracer.phase is armed (the zero-cost-when-off gate
# everywhere else is a single attribute check) AND the op samples in
# through the phase category (Tracer.gate_sampled at the build site) —
# and threads through the rendezvous so the waits, the dispatch and
# the fenced device execute decompose the op span into named phases.
# A non-None ctx means every sub-span records, so one op's
# decomposition is always coherent.

def _ph_rdv_start(ph):
    """Open a rendezvous-wait phase span (0 when the ctx is absent —
    a present ctx already sampled in at build time)."""
    if ph is None:
        return 0
    return ph[0].start()


def _ph_rdv_end(ph, t0) -> None:
    """Close a rendezvous-wait phase span and feed the straggler-skew
    histogram (rdv_wait is the one phase with its own gauge — it IS
    the cross-rank skew signal)."""
    tr = ph[0]
    dur = tr.end(t0, _NAME_PH_RDV, _CAT_PHASE, ph[1], ph[2], ph[3])
    tr.hist_add(_HIST_RDV, dur * 1e-9)


def _phase_fn(fn, shards, ph):
    """Run a meeting's body with dispatch/execute phases recorded
    against the triggering rank's tracer.  The execute fence
    (``_block_ready``) runs ONLY for a sampled-in op (ph non-None) —
    a sampled-out op keeps its launches asynchronous."""
    if ph is None:
        return fn(shards)
    tr = ph[0]
    t0 = tr.start()
    res = fn(shards)
    tr.end(t0, _NAME_PH_DISPATCH, _CAT_PHASE, ph[1], ph[2], ph[3])
    t1 = tr.start()
    _block_ready(res)
    tr.end(t1, _NAME_PH_EXECUTE, _CAT_PHASE, ph[1], ph[2], ph[3])
    return res


def _block_ready(res) -> None:
    """Fence a dispatched body to device completion (the execute phase
    boundary): wait for the done events ``_fence`` recorded on the
    body's streams, one a card (none on the CPU, where the body ran to
    its end: a zero-length execute span).  Never a device-wide
    synchronize: the rank threads share the card, and it would time
    their work too.  Raises what the wait raises — a fence that fails
    on the card is a device fault, not a zero-length span (the
    reference's ``_block_ready`` swallows every exception)."""
    last = None
    for _, done in res:
        if done is not None and done is not last:
            done.synchronize()
            last = done


class Rendezvous:
    """Per-communicator meeting point for device collectives.

    Generation-tracked so a fast rank may enter collective g+1 while
    stragglers of generation g are still reading their outputs (MPI
    permits ranks to leave a collective at different times)."""

    _SENTINEL = object()  # a deposited value may legitimately be None

    def __init__(self, size: int) -> None:
        self.size = size
        self.cv = threading.Condition()
        self.slots: List[Any] = [self._SENTINEL] * size
        self.count = 0
        self.gen = 0
        self.results: Dict[int, List[Any]] = {}
        self.errors: Dict[int, BaseException] = {}
        self.readers: Dict[int, int] = {}
        self._progs: Dict[int, Any] = {}  # rank -> Progress (wake targets)

    def _wait_for(self, cond, what: str, abort_check, progress) -> None:
        """Wait (cv held on entry and exit) until cond() holds.  Polls
        at ``coll_device_rendezvous_poll`` (abort flags are checked
        each tick, bounding abort latency) and fails after
        ``coll_device_rendezvous_timeout`` of no progress — a stuck
        peer must become a diagnosable error, not a silent hang.

        A waiter keeps its rank's ``progress`` engine turning while
        blocked (the opal_progress-in-every-blocking-call discipline,
        ref: opal/runtime/opal_progress.c:186), outside the meeting
        lock: p2p traffic aimed at this rank must not starve while it
        sits in a collective.

        The sweep releases the meeting lock, so a notify from the last
        arriver in that window reaches no waiter: ``cond()`` is read
        again under the lock before the waiter parks.  The reference's
        loop parks for its 2 ms timeout without that check
        (``ompi_tpu/coll/device.py`` ``_wait_for``), a lost wake-up the
        port repairs.

        ``cond()`` is also read under the lock before every abort
        check, so a posted result wins over a failure that arrived
        later: a member that dies right after leaving a meeting must
        not make a survivor still inside ``finish`` raise
        MPI_ERR_PROC_FAILED for an op that completed.  The reference
        runs the check first (its unsteady
        ``test_plan_across_shrink_epoch``), a race the port repairs."""
        poll = _rv_poll_var.value
        stall = _rv_timeout_var.value

        def tick(t_start: float) -> None:
            if abort_check:
                abort_check()
            if time.monotonic() - t_start > stall:
                raise RuntimeError(
                    f"device-collective rendezvous stalled >{stall}s "
                    f"({what}; peers dead or diverged? tune "
                    f"coll_device_rendezvous_timeout)")

        t0 = time.monotonic()
        if progress is None:
            while not cond():
                if not self.cv.wait(timeout=poll) and not cond():
                    tick(t0)
            return
        park = min(poll, 0.05)
        first = True
        while not cond():
            if first:
                # fast path: park straight on the condvar — in the
                # common meeting (all peers arrive within a couple
                # ms) the last arriver's notify wakes us with zero
                # progress sweeps
                first = False
                if self.cv.wait(timeout=0.002):
                    continue
            self.cv.release()
            try:
                events = progress.progress()
                if events == 0 and progress.has_idle_fds:
                    progress.idle_wait(park)
            finally:
                self.cv.acquire()
            if cond():
                return
            if events == 0 and not progress.has_idle_fds:
                self.cv.wait(timeout=0.002)
                if cond():
                    return
            tick(t0)

    def begin(self, rank: int, value: Any,
              fn: Callable[[List[Any]], List[Any]],
              abort_check: Optional[Callable[[], None]] = None,
              progress: Any = None,
              dispatch_async: Optional[bool] = None,
              ph: Optional[tuple] = None) -> int:
        """Deposit ``value`` for the next generation; the last arriver
        triggers fn(slots) -> per-rank outputs.  Returns the generation
        token to collect with ``finish``.

        ``dispatch_async=None`` follows the coll_device_dispatcher knob
        (off: the last arriver computes inline, under the meeting
        lock); ``True`` hands fn to the process-wide dispatcher thread
        so begin() returns while the device computes — the hook the
        segmented pipeline uses to pack segment k+1 while segment k
        launches.  Slots recycle as soon as the meeting is full, so
        generation g+1 deposits may land while g still computes."""
        if progress is not None:
            self._progs[rank] = progress
        if dispatch_async is None:
            dispatch_async = _dispatcher_var.value
        with self.cv:
            # wait until my slot from the previous generation is consumed
            tw = _ph_rdv_start(ph)
            self._wait_for(lambda: self.slots[rank] is self._SENTINEL,
                           "previous generation unconsumed",
                           abort_check, progress)
            if tw:
                _ph_rdv_end(ph, tw)
            gen = self.gen
            self.slots[rank] = value
            self.count += 1
            if self.count == self.size:
                shards = list(self.slots)
                self.count = 0
                self.slots = [self._SENTINEL] * self.size
                self.gen += 1
                if dispatch_async:
                    _dispatcher().submit(
                        functools.partial(self._work, gen, fn, shards, ph))
                else:
                    try:
                        self.results[gen] = _phase_fn(fn, shards, ph)
                    except BaseException as e:  # noqa: BLE001
                        self.errors[gen] = e
                        self.results[gen] = [None] * self.size
                    self.readers[gen] = self.size
                    self.cv.notify_all()
                    for r, prog in self._progs.items():
                        if r != rank:
                            prog.wakeup()
        return gen

    def _work(self, gen: int, fn, shards, ph=None) -> None:
        """The dispatcher thread's half of an async meeting: compute,
        publish the generation, wake every member."""
        try:
            res = _phase_fn(fn, shards, ph)
            err = None
        except BaseException as e:  # noqa: BLE001
            res = [None] * self.size
            err = e
        with self.cv:
            if err is not None:
                self.errors[gen] = err
            self.results[gen] = res
            self.readers[gen] = self.size
            self.cv.notify_all()
            progs = list(self._progs.values())
        # wake members parked on their progress idle selector (outside
        # the meeting lock)
        for prog in progs:
            prog.wakeup()

    def finish(self, rank: int, gen: int,
               abort_check: Optional[Callable[[], None]] = None,
               progress: Any = None,
               ph: Optional[tuple] = None) -> Any:
        """Collect this rank's output of generation ``gen`` (a token
        from ``begin``).  Each member must finish every generation it
        begins, exactly once — results are refcounted away after the
        last reader."""
        with self.cv:
            tw = _ph_rdv_start(ph)
            self._wait_for(lambda: gen in self.results,
                           f"waiting for peers (gen {gen})",
                           abort_check, progress)
            if tw:
                _ph_rdv_end(ph, tw)
            err = self.errors.get(gen)
            out = self.results[gen][rank]
            self.readers[gen] -= 1
            if self.readers[gen] == 0:
                del self.results[gen], self.readers[gen]
                self.errors.pop(gen, None)
            if err is not None:
                raise RuntimeError(
                    f"device collective failed on a peer: {err}") from err
            return out

    def run(self, rank: int, value: Any,
            fn: Callable[[List[Any]], List[Any]],
            abort_check: Optional[Callable[[], None]] = None,
            progress: Any = None, ph: Optional[tuple] = None) -> Any:
        """Deposit ``value``; the last arriver runs fn(slots) ->
        outputs; block until this rank's output is ready (begin +
        finish)."""
        gen = self.begin(rank, value, fn, abort_check, progress, ph=ph)
        return self.finish(rank, gen, abort_check, progress, ph=ph)

    def snapshot(self) -> dict:
        """The hang doctor's view of the meeting: which ranks have
        deposited for the current generation and which are absent.
        Cold path (a watchdog stall); tries the meeting lock for at
        most 0.2 s, then reads without it — under the GIL a stale list
        read is safe, and a wedged meeting is by definition not
        changing."""
        got = self.cv.acquire(timeout=0.2)
        try:
            arrived = [r for r in range(self.size)
                       if self.slots[r] is not self._SENTINEL]
            return {
                "size": self.size,
                "gen": self.gen,
                "count": self.count,
                "arrived": arrived,
                "absent": [r for r in range(self.size)
                           if self.slots[r] is self._SENTINEL],
                "pending_gens": sorted(self.results.keys()),
            }
        finally:
            if got:
                self.cv.release()


def _get_rendezvous(comm) -> Rendezvous:
    rv = comm.__dict__.get("_device_rv")
    if rv is not None:
        return rv
    world = comm.state.rte.world
    # disjoint communicators may share a cid (uniqueness is
    # per-process), so the group is part of the key
    key = ("coll_rv", comm.cid, tuple(comm.group))
    with world.shared_lock:
        rv = world.shared.get(key)
        if rv is None:
            rv = Rendezvous(comm.size)
            world.shared[key] = rv
    comm.__dict__["_device_rv"] = rv
    return rv


def _tensors(value) -> List[torch.Tensor]:
    """The tensors of a deposit or an output: one tensor, a list of
    them, a fused batch's (signature, tensors) pair, a mesh segment's
    (operand, output) pair, or an integrity carrier (its datapath
    deposit, its pristine source and its claim)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, _ig._Checked):
        return _tensors(value.v) + _tensors(value.src) + [value.d]
    if isinstance(value, tuple) and len(value) == 2 \
            and isinstance(value[1], list):
        value = value[1]
    return [t for t in value if isinstance(t, torch.Tensor)]


def _fenced(value, ph=None):
    """The deposit as it enters the meeting: (value, event).  On a
    card the event marks the end of the depositor's work on the
    value's tensors, on the depositor's current stream.  A phase ctx
    records the event's creation and record as the op's ``ph_pack``:
    the deposit's last preparation (the reference has no such step)."""
    ts = _tensors(value)
    if not ts or not ts[0].is_cuda:
        return value, None
    t0 = ph[0].start() if ph is not None else 0
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(ts[0].device))
    if t0:
        ph[0].end(t0, _NAME_PH_PACK, _CAT_PHASE, ph[1], ph[2], ph[3])
    return value, ev


def _fence(body):
    """fn for the rendezvous around ``body(values) -> per-rank
    outputs``: on the cards, the body thread's current stream on every
    device a deposit lies on (one for coll/hbm, one per member's card
    for the mesh) waits on every deposit's event first — any launch
    may read any deposit — and records one done event after; each
    member's stream waits on the done event of its output's device
    before it touches its output."""
    def fn(slots):
        values = [v for v, _ in slots]
        if slots[0][1] is None:
            return [(o, None) for o in body(values)]
        deposits = [t for v in values for t in _tensors(v)]
        streams = {}
        for t in deposits:
            if t.device not in streams:
                streams[t.device] = torch.cuda.current_stream(t.device)
        for stream in streams.values():
            for _, e in slots:
                stream.wait_event(e)
            # the deposit's memory must outlive this stream's reads
            # even if its owner frees it right after the meeting
            for t in deposits:
                t.record_stream(stream)
        outs = body(values)
        done = {}
        for dev, stream in streams.items():
            ev = done[dev] = torch.cuda.Event()
            ev.record(stream)
        return [(o, _done_for(o, done)) for o in outs]
    return fn


def _done_for(out, done: Dict[Any, Any]):
    ts = _tensors(out) if out is not None else []
    return done[ts[0].device] if ts else None


def _cross_fence(devices, bufs) -> None:
    """Inside a mesh body: before launches on one card read what the
    body's launches on another card wrote (``bufs``), every card's
    current stream waits on every other card's work so far, and each
    buffer stays alive until the other cards' reads are done.  Logical
    devices of one card share one stream: nothing to do."""
    streams = {}
    for d in devices:
        if d.type == "cuda" and d not in streams:
            streams[d] = torch.cuda.current_stream(d)
    if len(streams) < 2:
        return
    marks = {}
    for d, s in streams.items():
        ev = marks[d] = torch.cuda.Event()
        ev.record(s)
    for d, s in streams.items():
        for e, ev in marks.items():
            if e != d:
                s.wait_event(ev)
        for b in bufs:
            if b.device != d:
                b.record_stream(s)


def _collect(res, ph=None):
    """This member's output of a meeting, its stream made to wait on
    the meeting's done event.  A phase ctx records that wait as the
    op's ``ph_unpack``: taking the output (the reference has no such
    step)."""
    out, done = res
    if done is not None:
        ts = _tensors(out)
        if ts:
            t0 = ph[0].start() if ph is not None else 0
            stream = torch.cuda.current_stream(ts[0].device)
            stream.wait_event(done)
            for t in ts:
                t.record_stream(stream)
            if t0:
                ph[0].end(t0, _NAME_PH_UNPACK, _CAT_PHASE, ph[1], ph[2],
                          ph[3])
    return out


def _coll_delay_injector(state):
    """ft_inject 'delay' faults at the rendezvous: seed-driven stalls
    before a rank deposits, so chaos runs exercise straggler arrival
    orders (cached per rank state; False = disarmed)."""
    inj = state.extra.get("coll_delay_inj")
    if inj is None:
        inj = state.extra["coll_delay_inj"] = \
            ft_inject.coll_injector(state.rank) or False
    return inj


def _coll_sever_injector(state):
    """ft_inject 'rdv_sever' (the hang doctor's chaos class): a one-shot
    deterministic wedge — the victim rank stops short of depositing at
    its Nth rendezvous, stranding every peer in ``_wait_for`` until the
    world is poisoned (cached per rank state; False = disarmed)."""
    inj = state.extra.get("coll_sever_inj")
    if inj is None:
        inj = state.extra["coll_sever_inj"] = ft_inject.rdv_sever_injector(
            state.rank, getattr(state, "size", None)) or False
    return inj


def _coll_slow_injector(state):
    """ft_inject 'host_slow' (the GRAY failure): every rank resident on
    ft_inject_victim_host stalls a deterministic delay_ms*(factor-1)
    before each deposit — the whole host crawls while it stays alive,
    the shape the health plane must catch (cached per rank state;
    False = disarmed or this rank lives elsewhere)."""
    inj = state.extra.get("coll_slow_inj")
    if inj is None:
        node = getattr(getattr(state, "rte", None), "node_id", 0)
        inj = state.extra["coll_slow_inj"] = \
            ft_inject.host_slow_injector(node) or False
    return inj


def _sever_hold(abort_check) -> None:
    """The wedge itself: hold THIS rank before it deposits, in small
    abort-checked sleeps, so the hang doctor finds a live stall (peers
    parked at the rendezvous, this rank absent) and the world's abort
    still unwinds everything — ``abort_check`` raises once a peer has
    aborted.  Bounded by the rendezvous stall timeout, so a run with no
    doctor raises instead of hanging."""
    deadline = time.monotonic() + _rv_timeout_var.value
    while True:
        if abort_check:
            abort_check()
        if time.monotonic() > deadline:
            raise RuntimeError(
                "ft_inject rdv_sever: hold outlived the rendezvous "
                "stall timeout with no abort")
        time.sleep(0.02)


def _coll_sdc_injector(state):
    """ft_inject 'device_sdc' (the silent failure): the victim rank's
    operand bit-flips at the armed op count — after the integrity gate
    digested it, exactly the divergence the bisection round
    attributes.  On an unsampled op the flip lands on the raw operand
    and propagates silently: the honest semantics of 1-in-N detection
    (cached per rank state; False = disarmed or not the victim)."""
    inj = state.extra.get("coll_sdc_inj")
    if inj is None:
        inj = state.extra["coll_sdc_inj"] = ft_inject.sdc_injector(
            state.rank, getattr(state, "size", None)) or False
    return inj


def _enter(comm, value, body, abort_check, ck):
    """What a deposit passes before the rendezvous, in the reference's
    order: the 'delay' straggler, the 'host_slow' stall, the
    'rdv_sever' wedge, the integrity gate (``ck``, the check spec, is
    non-None only when the plane is armed and the op checkable; every
    rank passes the same one) and the 'device_sdc' flip.  Returns the
    (value, body) that meet."""
    inj = _coll_delay_injector(comm.state)
    if inj:
        d = inj.maybe_delay()
        if d:
            time.sleep(d)
    sl = _coll_slow_injector(comm.state)
    if sl:
        time.sleep(sl.delay_s())
    sv = _coll_sever_injector(comm.state)
    if sv and sv.should_sever():
        _sever_hold(abort_check)
    if ck is not None:
        value, body = _ig.gate(comm, value, body, ck)
    sj = _coll_sdc_injector(comm.state)
    if sj and sj.should_flip():
        value = _ig.flip_value(value)
    return value, body


def meet(comm, value, body: Callable[[List[Any]], List[Any]],
         abort_check, ck=None) -> Any:
    """The rendezvous entry point for the device collectives: deposit
    ``value`` (a contiguous tensor on the comm's shared device, a fused
    batch's (signature, tensors) pair, or a mesh segment's (operand,
    output) pair); the last arriver runs ``body(values) -> one output
    per rank`` and every rank gets its own.  On a CUDA device the
    stream fence of ``_fence`` orders the kernels after every deposit
    (the integrity gate's work included) and every rank's later work
    after the kernels.  ``ck``: the integrity check spec (``_enter``)."""
    track_state(comm.state)
    tr = comm.state.tracer
    if tr is None:
        value, body = _enter(comm, value, body, abort_check, ck)
        return _collect(_get_rendezvous(comm).run(
            comm.rank, _fenced(value), _fence(body), abort_check,
            progress=comm.state.progress))
    # the payload as the caller gave it (the gate may wrap it)
    nbytes = value.nbytes if isinstance(value, torch.Tensor) else 0
    value, body = _enter(comm, value, body, abort_check, ck)
    rv = _get_rendezvous(comm)
    # dispatch span: entry->rendezvous-release of the device fast path
    # (cat coll_dispatch feeds the dispatch-latency histogram); the
    # per-comm sequence number is the straggler correlation key
    seq = comm._dev_seq
    comm._dev_seq = seq + 1
    # inlined start_sampled skip branch (the steady-state common case;
    # see trace.coll_begin) — the sampled-out cost of the dispatch
    # span is two list ops, no method call, no clock read
    ctr = tr._ctr
    c = ctr[_CAT_DISP]
    if c:
        ctr[_CAT_DISP] = c - 1
        tr._skipped[_CAT_DISP] += 1
        t0 = 0
    else:
        t0 = tr.start_sampled(_CAT_DISP)
    # phase ctx: one tuple per op ONLY when the profiler is armed AND
    # this op samples in — off, a single attribute check
    ph = None
    if tr.phase:
        c = ctr[_CAT_PHASE]
        if c:
            ctr[_CAT_PHASE] = c - 1
            tr._skipped[_CAT_PHASE] += 1
        elif tr.gate_sampled(_CAT_PHASE):
            ph = (tr, comm.cid, seq, nbytes)
    out = _collect(rv.run(comm.rank, _fenced(value, ph), _fence(body),
                          abort_check, progress=comm.state.progress,
                          ph=ph), ph)
    if t0:
        tr.end(t0, _NAME_MEET, _CAT_DISP, comm.cid, seq, nbytes)
    return out


def meet_begin(comm, value, body, abort_check, ck=None):
    """Asynchronous rendezvous entry: deposit and return a handle
    without waiting for the result.  The last arriver's computation
    always runs on the dispatcher thread, so the caller's thread is
    free to pack the NEXT segment while the card computes this one.
    Collect with ``meet_finish``; every begun handle MUST be finished
    (results are refcounted per generation).  ``ck`` as in ``meet``:
    each segment takes its own sampling decision."""
    track_state(comm.state)
    tr = comm.state.tracer
    nbytes = value.nbytes if tr is not None \
        and isinstance(value, torch.Tensor) else 0
    value, body = _enter(comm, value, body, abort_check, ck)
    rv = _get_rendezvous(comm)
    t0 = 0
    ph = None
    if tr is not None:
        t0 = tr.start_sampled(_CAT_SEG)
        if tr.phase and tr.gate_sampled(_CAT_PHASE):
            # the final seq is assigned at meet_finish; the CURRENT
            # _dev_seq is close enough for critpath's containment-
            # based attribution (exact keys ride the seg_meet span)
            ph = (tr, comm.cid, comm._dev_seq, nbytes)
    gen = rv.begin(comm.rank, _fenced(value, ph), _fence(body),
                   abort_check, progress=comm.state.progress,
                   dispatch_async=True, ph=ph)
    return (rv, gen, t0, nbytes, ph)


def meet_finish(comm, handle, abort_check) -> Any:
    """Collect one ``meet_begin`` handle.  The deposit→collect span is
    recorded under cat ``coll_segment`` (its own latency histogram —
    per-segment latency, unlike coll_dispatch's whole-op latency)."""
    rv, gen, t0, nbytes, ph = handle
    out = _collect(rv.finish(comm.rank, gen, abort_check,
                             progress=comm.state.progress, ph=ph), ph)
    tr = comm.state.tracer
    if tr is not None:
        # the seq ticks on EVERY traced segment (sampled out or not)
        # so surviving spans keep cross-rank-aligned correlation keys
        seq = comm._dev_seq
        comm._dev_seq = seq + 1
        if t0:
            tr.end(t0, _NAME_SEG_MEET, _CAT_SEG, comm.cid, seq, nbytes)
    return out


def _abort_check(comm):
    cached = comm.__dict__.get("_device_abort_check")
    if cached is not None:
        return cached
    world = getattr(comm.state.rte, "world", None)
    ulfm = comm.state.ulfm  # None when mpi_ft_ulfm is off

    def check():
        if world is not None and world.aborted and \
                world.aborted[0] != comm.state.rank:
            raise RuntimeError(
                f"peer rank {world.aborted[0]} aborted during "
                "device collective")
        if ulfm is not None and ulfm.active:
            # a peer died while we were parked in the rendezvous:
            # surface ERR_PROC_FAILED/ERR_REVOKED out of the wait
            # instead of spinning until the meet timeout
            ulfm.poll()
            ulfm.check_comm(comm)
    comm.__dict__["_device_abort_check"] = check
    return check


# the resident pool's HBM quota tap (ompi_tpu_torch/serve/quota): bound
# by serve.quota.install(), so coll never imports the serve package and
# a world outside the pool pays one None check per deposit
_hbm_charge_hook: Optional[Callable[[int], None]] = None


def _deposit(comm, x) -> torch.Tensor:
    """A deposited value lives on the comm's shared device,
    contiguous.  A value that was not already there is a deposit onto
    the device, charged to the calling session's HBM quota when the
    pool armed it (the one deposit point of both tiers: coll/hbm and
    the mesh tier's placement go through here)."""
    dev = comm.state.device
    hook = _hbm_charge_hook
    if isinstance(x, torch.Tensor):
        if hook is not None and x.device != dev:
            hook(x.numel() * x.element_size())
        return x.to(dev).contiguous()
    t = convert.to_torch(x, dev)
    if hook is not None:
        hook(t.numel() * t.element_size())
    return t


def _norm(x):
    """Normalize scalars/0-d arrays to rank-1 (the stacked kernels
    work on a leading dimension)."""
    if getattr(x, "ndim", None) == 0:
        return x.reshape(1), True
    return x, False


class HbmCollModule(CollModule):
    """Intra-card collectives: every member rank shares one device, so
    the collective is a single stacked kernel through device memory
    (coll/sm analog — the 'node' is the card)."""

    name = "hbm"

    def __init__(self, fallback: "HostArrModule") -> None:
        self.fallback = fallback

    def _eligible(self, comm, x, op: Optional[Op] = None) -> bool:
        """Comm-consistent: depends only on comm properties and the
        dtype/op, which MPI requires to match across ranks (local
        buffer residency does not matter — _deposit moves stray host
        buffers), so every member reaches the same verdict and none
        enters the rendezvous while another takes the fallback.

        False only where the kernels cannot hold the call at all: a
        dtype torch lacks, or a user-defined op.  Every other call
        meets, and a pair or shape the kernels refuse raises inside
        the meeting, on every member."""
        one_dev = comm.__dict__.get("_hbm_one_device")
        if one_dev is None:
            keys = _member_devices(comm)
            one_dev = comm.size > 1 and keys is not None \
                and len(set(keys)) == 1
            comm.__dict__["_hbm_one_device"] = one_dev
        if not one_dev:
            return False
        return _dtype_of(x) is not None and (op is None or not op.is_user)

    _deposit = staticmethod(_deposit)

    def _stacked(self, comm, x, body, ck=None) -> List[torch.Tensor]:
        return meet(comm, self._deposit(comm, x), body, _abort_check(comm),
                    ck)

    @staticmethod
    def _stacked_fn(kind: str, opname: str):
        """The meeting body the plan and pipeline tiers run per
        deposit: K1 for an allreduce, K2 for an alltoall."""
        if kind == "allreduce":
            return lambda s: stacked.stacked_reduce(s, opname)
        if kind == "alltoall":
            return lambda s: stacked.stacked_copy(s, "alltoall")
        raise KeyError(kind)

    def allreduce_arr(self, comm, x, op: Op):
        if not self._eligible(comm, x, op):
            return self.fallback.allreduce_arr(comm, x, op)
        out = pipeline.maybe_device_coll(self, comm, "allreduce", x, op=op)
        if out is not pipeline.UNHANDLED:
            return out
        x, was_scalar = _norm(x)
        out = self._stacked(
            comm, x, lambda s: stacked.stacked_reduce(s, op.name),
            _ck("allreduce", op.name, x))
        return out.reshape(()) if was_scalar else out

    def reduce_scatter_block_arr(self, comm, x, op: Op):
        if not self._eligible(comm, x, op):
            return self.fallback.reduce_scatter_block_arr(comm, x, op)
        return self._stacked(
            comm, x,
            lambda s: stacked.stacked_reduce(s, op.name, scatter=True),
            _ck("reduce_scatter", op.name, x))

    def allgather_arr(self, comm, x):
        if not self._eligible(comm, x):
            return self.fallback.allgather_arr(comm, x)
        x, _ = _norm(x)
        return self._stacked(
            comm, x, lambda s: stacked.stacked_copy(s, "allgather"),
            _ck("allgather", "", x))

    def alltoall_arr(self, comm, x):
        if not self._eligible(comm, x):
            return self.fallback.alltoall_arr(comm, x)
        shp = _shape_of(x)
        if shp and shp[0] % comm.size == 0:
            out = pipeline.maybe_device_coll(self, comm, "alltoall", x)
            if out is not pipeline.UNHANDLED:
                return out
        return self._stacked(
            comm, x, lambda s: stacked.stacked_copy(s, "alltoall"),
            _ck("alltoall", "", x))

    def bcast_arr(self, comm, x, root: int):
        if not self._eligible(comm, x):
            return self.fallback.bcast_arr(comm, x, root)
        return self._stacked(comm, x, lambda s: _bcast_copies(s, root),
                             _ck("bcast", "", x, root))

    def reduce_arr(self, comm, x, op: Op, root: int):
        if not _reduce_as_allreduce_var.value:
            return self.fallback.reduce_arr(comm, x, op, root)
        out = self.allreduce_arr(comm, x, op)
        return out if comm.rank == root else None

    def ppermute_arr(self, comm, x, perm):
        if not self._eligible(comm, x):
            return self.fallback.ppermute_arr(comm, x, perm)
        pmap = {int(a): int(b) for a, b in perm}
        return self._stacked(comm, x, lambda s: _ppermute_copies(s, pmap))

    def neighbor_allgather_arr(self, comm, x, srcs):
        """``srcs[m]``: member m's sources in MPI neighbour order
        (``topo.neighbor.source_table``)."""
        if not self._eligible(comm, x):
            return self.fallback.neighbor_allgather_arr(comm, x, srcs)
        return self._stacked(comm, x, lambda s: _neighbor_gather(s, srcs))


def _spans_processes(comm) -> bool:
    """Whether some member of ``comm`` lives in another process (a
    process rank, or a rank-thread of another app shell)."""
    v = comm.__dict__.get("_spans_procs")
    if v is None:
        world = getattr(comm.state.rte, "world", None)
        v = any(g != comm.state.rank if world is None
                else not world.is_local(g) for g in comm.group)
        comm.__dict__["_spans_procs"] = v
    return v


class _HostIO:
    """The host buffers of one ``HostArrModule`` call: ``a`` the input
    as numpy, ``empty``/``zeros`` its outputs, ``back`` the result in
    the caller's kind.

    Plain (host buffers, a communicator within this process, or a rank
    that owns no device): ``a`` is the buffer itself; a tensor on a
    card is refused there.  Staged (a tensor of a rank that owns a
    device, on a communicator with members in another process): the
    input is copied D2H into a stage of the shared pool
    (``runtime/staging.py``: pinned for a card, and raising where it
    cannot be pinned); outputs are stages too, and ``back`` copies the
    result H2D from its stage into a new tensor on the rank's device.
    Each copy is waited on, so the stages go back to the pool at the
    end of the call — never a pageable copy of device data."""

    __slots__ = ("module", "comm", "x", "a", "staged", "_stages", "_pool")

    def __init__(self, module, comm, x) -> None:
        self.module, self.comm, self.x = module, comm, x
        self.staged = isinstance(x, torch.Tensor) \
            and comm.state.device is not None and _spans_processes(comm)
        #: the data pointer of each staged buffer -> its stage
        self._stages: dict = {}
        if not self.staged:
            self.a = module._np(x)
            return
        from ompi_tpu_torch.runtime import staging
        self._pool = staging.pool(x.device)
        src = x.detach().contiguous()
        a = self.empty(_shape_of(x), convert.numpy_dtype(src.dtype))
        staging.d2h(src, self._stages[a.ctypes.data])
        self.a = a

    def empty(self, shape, dtype) -> np.ndarray:
        """An output buffer: a stage's numpy view when staged (``back``
        takes any reshape of it)."""
        if not self.staged:
            return np.empty(shape, dtype=dtype)
        from ompi_tpu_torch.runtime import staging
        dtype = np.dtype(dtype)
        stage = self._pool.take(int(np.prod(shape)) * dtype.itemsize)
        arr = staging.host_view(stage).view(dtype).reshape(shape)
        self._stages[arr.ctypes.data] = stage
        return arr

    def zeros(self, shape, dtype) -> np.ndarray:
        out = self.empty(shape, dtype)
        out[...] = 0
        return out

    def back(self, arr: np.ndarray):
        if not self.staged:
            return self.module._back(self.comm, arr)
        from ompi_tpu_torch.runtime import staging
        out = torch.empty(arr.shape, dtype=convert.torch_dtype(arr.dtype),
                          device=self.comm.state.device)
        if arr.nbytes:
            staging.h2d(self._stages[arr.ctypes.data], out, wait=True)
        return out

    def __enter__(self) -> "_HostIO":
        return self

    def __exit__(self, *exc) -> None:
        # every copy from or to a stage has completed by now (the D2H
        # and H2D were each waited on): the stages may be reused
        for stage in self._stages.values():
            self._pool.park(stage)
        self._stages = {}


class HostArrModule(CollModule):
    """The *_arr surface over the host p2p collective stack (the
    'coll/cuda staging wrapper' analog, ref: ompi/mca/coll/cuda) for
    host buffers — numpy arrays and CPU tensors — and for tensors on a
    communicator that spans processes, which stage through pinned
    memory (``_HostIO``).  A card tensor on a communicator within this
    process is refused: copying it to the host and back would hide the
    device, and the port has no kernel for the call."""

    name = "arr_host"

    def __init__(self) -> None:
        self.p2p = TunedModule()
        from ompi_tpu_torch.datatype import engine as dtmod
        self._dt = dtmod

    def _np(self, x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                raise NotImplementedError(
                    f"no device collective takes this call (a {x.dtype} "
                    f"tensor on {x.device} with a user-defined op, or a "
                    "communicator whose members own no device), and "
                    "the port does not stage device tensors through "
                    "the host")
            return convert.to_numpy(x)
        return np.asarray(x)

    def _back(self, comm, arr: np.ndarray):
        dev = comm.state.device
        if dev is not None:
            return convert.to_torch(arr, dev)
        return arr

    def _dtype_of(self, arr):
        return self._dt.from_numpy_dtype(arr.dtype)

    def allreduce_into(self, comm, a: np.ndarray, r: np.ndarray,
                       op: Op) -> None:
        """Allreduce the flat host array ``a`` into ``r`` (its size and
        dtype) over the p2p stack: ``allreduce_arr``'s body, and the
        hierarchical tier's leader hop between its pinned stages."""
        self.p2p.allreduce(comm, a, r, a.size, self._dtype_of(a), op)

    def allreduce_arr(self, comm, x, op: Op):
        with _HostIO(self, comm, x) as io:
            a = io.a.reshape(-1)
            r = io.empty(a.size, a.dtype)
            self.allreduce_into(comm, a, r, op)
            return io.back(r.reshape(_shape_of(x)))

    def bcast_arr(self, comm, x, root: int):
        with _HostIO(self, comm, x) as io:
            a = io.a.reshape(-1)
            if not io.staged:
                a = a.copy()
            self.p2p.bcast(comm, a, a.size, self._dtype_of(a), root)
            return io.back(a.reshape(_shape_of(x)))

    def reduce_arr(self, comm, x, op: Op, root: int):
        with _HostIO(self, comm, x) as io:
            a = io.a.reshape(-1)
            r = io.empty(a.size, a.dtype) if comm.rank == root else None
            self.p2p.reduce(comm, a, r, a.size, self._dtype_of(a), op,
                            root)
            return io.back(r.reshape(_shape_of(x))) \
                if comm.rank == root else None

    def allgather_arr(self, comm, x):
        shp = _shape_of(x)
        with _HostIO(self, comm, x) as io:
            a = io.a.reshape(-1)
            r = io.empty(a.size * comm.size, a.dtype)
            self.p2p.allgather(comm, a, a.size, self._dtype_of(a), r,
                               a.size, self._dtype_of(a))
            out_shape = (comm.size,) if not shp else \
                (comm.size * shp[0],) + tuple(shp[1:])
            return io.back(r.reshape(out_shape))

    def alltoall_arr(self, comm, x):
        shp = _shape_of(x)
        with _HostIO(self, comm, x) as io:
            a = io.a.reshape(-1)
            n = a.size // comm.size
            r = io.empty(a.size, a.dtype)
            self.p2p.alltoall(comm, a, n, self._dtype_of(a), r, n,
                              self._dtype_of(a))
            return io.back(r.reshape(shp))

    def reduce_scatter_block_arr(self, comm, x, op: Op):
        shp = _shape_of(x)
        with _HostIO(self, comm, x) as io:
            a = io.a.reshape(-1)
            n = a.size // comm.size
            r = io.empty(n, a.dtype)
            self.p2p.reduce_scatter_block(comm, a, r, n, self._dtype_of(a),
                                          op)
            out_shape = (shp[0] // comm.size,) + tuple(shp[1:]) if shp \
                else (n,)
            return io.back(r.reshape(out_shape))

    def ppermute_arr(self, comm, x, perm):
        from ompi_tpu_torch.coll.base import _irecv_into, _isend
        with _HostIO(self, comm, x) as io:
            a = np.ascontiguousarray(io.a)
            out = io.zeros(a.shape, a.dtype)
            reqs = []
            for src, dst in perm:
                if int(dst) == comm.rank:
                    reqs.append(_irecv_into(comm, out.reshape(-1),
                                            int(src), -115))
            for src, dst in perm:
                if int(src) == comm.rank:
                    reqs.append(_isend(comm, a.reshape(-1), int(dst), -115))
            for q in reqs:
                q.wait()
            return io.back(out)

    def neighbor_allgather_arr(self, comm, x, srcs):
        """Host p2p: one message from each distinct source to each
        member that lists it (every block from one source holds the
        same bytes), zeros for a PROC_NULL source."""
        from ompi_tpu_torch.coll.base import _irecv_into, _isend
        from ompi_tpu_torch.pml.request import PROC_NULL
        with _HostIO(self, comm, x) as io:
            a = np.ascontiguousarray(io.a)
            mine = srcs[comm.rank]
            out = io.zeros((len(mine),) + a.shape, a.dtype)
            got = {s: np.empty_like(a) for s in mine if s != PROC_NULL}
            reqs = [_irecv_into(comm, buf.reshape(-1), s, T_NEIGHBOR_ARR)
                    for s, buf in got.items()]
            reqs += [_isend(comm, a.reshape(-1), m, T_NEIGHBOR_ARR)
                     for m in range(comm.size) if comm.rank in srcs[m]]
            for q in reqs:
                q.wait()
            for i, s in enumerate(mine):
                if s != PROC_NULL:
                    out[i] = got[s]
            return io.back(out)


# ---------------------------------------------------------------------------
# coll/tpu: the mesh tier
# ---------------------------------------------------------------------------

def _stripe_elems(n: int, size: int, itemsize: int) -> int:
    """Elements of the stripe each device owns in a mesh reduction:
    ceil(n / size), rounded up to whole 16-byte vectors."""
    v = max(1, 16 // itemsize)
    m = -(-n // size)
    return -(-m // v) * v


def _mesh_allreduce(xs: List[torch.Tensor], opname: str, order="rank",
                    outs: Optional[List[torch.Tensor]] = None
                    ) -> List[torch.Tensor]:
    """Allreduce of one tensor a member (xs[d] on member d's device):
    ``_mesh_allreduce_sets`` over one set, into ``outs[d]`` when given
    (written in place), else new tensors.  One K6 and one K2 peer
    launch a card."""
    bufs = None if outs is None else [o.view(-1) for o in outs]
    res = _mesh_allreduce_sets([xs], opname, order, bufs)[0]
    return res if outs is None else outs


def _mesh_allreduce_sets(sets: List[List[torch.Tensor]], opname: str,
                         order="rank",
                         outs: Optional[List[torch.Tensor]] = None,
                         split: bool = True) -> List[List[torch.Tensor]]:
    """Allreduce of one or more tensors a member at once: sets[p] holds
    one tensor a member (sets[p][d] on member d's device, the same
    devices for every p; one dtype).  The sets are laid end to end as
    one vector of L elements; device d folds stripe d of that vector
    (K6, ``order`` as ``kernels.mesh._order`` takes it: a job for each
    set the stripe meets, reading that set's inputs) into a stripe
    buffer on d, then gathers every stripe from its owner (K2 peer)
    into one buffer of L elements — ``outs[d]`` when given (flat,
    written in place), else a new one — so that the result's [p][d]
    is a view of set p's elements on device d.  One K6 and one K2 peer
    launch a card for all the sets (each over a destination table of
    every member on that card): a combined dispatch of several
    sessions' group buffers.  ``split`` False raises ValueError where
    K6's table would need a second launch on a card."""
    xs0 = sets[0]
    size = len(xs0)
    devices = [x.device for x in xs0]
    for xs in sets:
        if [x.device for x in xs] != devices:
            raise ValueError("_mesh_allreduce_sets: every set lies on the "
                             "members' devices")
    lens = [xs[0].numel() for xs in sets]
    offs = [0] * len(sets)
    for p in range(1, len(sets)):
        offs[p] = offs[p - 1] + lens[p - 1]
    total = offs[-1] + lens[-1]
    dt = xs0[0].dtype
    if outs is None:
        outs = [torch.empty(total, dtype=dt, device=d) for d in devices]
    if total:
        m = _stripe_elems(total, size, xs0[0].element_size())
        stripes = [torch.empty(m, dtype=dt, device=d) for d in devices]
        jobs = []
        for d in range(size):
            a, b = d * m, min((d + 1) * m, total)
            for p, (o, n) in enumerate(zip(offs, lens)):
                lo, hi = max(a, o), min(b, o + n)
                if lo < hi:
                    jobs.append((stripes[d][lo - a:hi - a], lo - o, p))
        mesh.mesh_fold_many([[x.reshape(-1) for x in xs] for xs in sets],
                            jobs, opname, order, split)
        _cross_fence(devices, stripes)
        stacked.peer_copy_many(stripes, outs, m, limit=total)
    return [[outs[d][o:o + n].view(xs[d].shape) for d in range(size)]
            for xs, o, n in zip(sets, offs, lens)]


def _mesh_reduce_scatter(xs: List[torch.Tensor], opname: str
                         ) -> List[torch.Tensor]:
    """Member d's output is stripe d of the rank-order fold: one K6
    launch a card, writing the outputs directly."""
    x0 = xs[0]
    shape = stacked._scatter_shape(x0, len(xs))
    m = x0.numel() // len(xs)
    flats = [x.reshape(-1) for x in xs]
    outs = [torch.empty(shape, dtype=x0.dtype, device=x.device) for x in xs]
    if m:
        mesh.mesh_fold_many(flats, [(o.view(-1), d * m)
                                    for d, o in enumerate(outs)], opname)
    return outs


def _mesh_alltoall(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Output d, block j <- input j, block d: one K2 peer launch a
    card."""
    x0, size = xs[0], len(xs)
    if x0.dim() == 0 or x0.shape[0] % size:
        raise ValueError(f"alltoall: leading dimension of "
                         f"{tuple(x0.shape)} is not divisible by {size}")
    b = x0.numel() // size
    flats = [x.reshape(-1) for x in xs]
    outs = [torch.empty(x0.shape, dtype=x0.dtype, device=x.device)
            for x in xs]
    stacked.peer_copy_many(flats, [o.view(-1) for o in outs], b,
                           src_stride=b)
    return outs


def _mesh_allgather(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Output d = every input in rank order: one K2 peer launch a
    card."""
    x0, size = xs[0], len(xs)
    s = tuple(x0.shape) or (1,)
    shape = (size * s[0],) + s[1:]
    flats = [x.reshape(-1) for x in xs]
    outs = [torch.empty(shape, dtype=x0.dtype, device=x.device) for x in xs]
    stacked.peer_copy_many(flats, [o.view(-1) for o in outs], x0.numel())
    return outs


def _bcast_copies(xs: List[torch.Tensor], root: int
                  ) -> List[torch.Tensor]:
    """Every member gets its own copy of the root's tensor on its own
    device (a clone on one card, a peer copy across cards)."""
    src = xs[root]
    return [torch.empty(src.shape, dtype=src.dtype, device=x.device)
            .copy_(src) for x in xs]


def _ppermute_copies(xs: List[torch.Tensor], pmap: Dict[int, int]
                     ) -> List[torch.Tensor]:
    """Member dst gets its own copy of member src's tensor for each
    (src, dst) on dst's device, zeros where no source maps to it."""
    outs: List[Optional[torch.Tensor]] = [None] * len(xs)
    for src, dst in pmap.items():
        outs[dst] = torch.empty(xs[src].shape, dtype=xs[src].dtype,
                                device=xs[dst].device).copy_(xs[src])
    return [o if o is not None else torch.zeros(
        xs[0].shape, dtype=xs[0].dtype, device=x.device)
        for o, x in zip(outs, xs)]


def _neighbor_gather(xs: List[torch.Tensor], srcs: List[List[int]]
                     ) -> List[torch.Tensor]:
    """Member m's output stacks the deposits of its sources ``srcs[m]``
    (MPI neighbour order; a duplicate neighbour appears twice) along a
    new leading axis, a zero block for PROC_NULL: ONE K2 peer launch a
    member, writing its blocks straight from the neighbours' deposits
    (no stack is materialised; the reference holds one ppermute
    meeting a (dim, direction) and stacks the results)."""
    from ompi_tpu_torch.pml.request import PROC_NULL
    x0 = xs[0]
    flats = [x.reshape(-1) for x in xs]
    outs = []
    for m, x in enumerate(xs):
        o = torch.empty((len(srcs[m]),) + tuple(x0.shape), dtype=x0.dtype,
                        device=x.device)
        if o.numel():
            stacked.peer_copy([None if s == PROC_NULL else flats[s]
                               for s in srcs[m]], o.view(-1), x0.numel())
        outs.append(o)
    return outs


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(getattr(x, "nbytes", 0) or 0)


def _measured_host_wins(comm, kind: str, nbytes: int) -> bool:
    """Measured-crossover reroute (--mca coll_tuned_use_measured_rules):
    below the calibrated device-vs-host crossover the host path wins.
    Comm-consistent: the profile is process-wide and nbytes is
    MPI-matched across ranks, so every member reroutes (or not)
    together.  The host path takes host buffers only: with the knob on,
    a card tensor below the crossover is refused there, not staged."""
    from ompi_tpu_torch.coll import calibrate
    if not calibrate.use_measured_rules():
        return False
    return 0 < nbytes < calibrate.crossover_bytes(kind, comm.size)


class TpuCollModule(CollModule):
    """The mesh tier: collectives for comms whose ranks own pairwise-
    distinct devices (cards, or logical devices of one card), as
    per-device kernel launches from one controller thread."""

    name = "tpu"

    def __init__(self, fallback: "HostArrModule") -> None:
        self.fallback = fallback
        self.pvar_offload = registry.register_pvar(
            "coll", "tpu", "offloaded_collectives",
            help="Number of collectives executed by the mesh tier")

    def _eligible(self, comm, x) -> bool:
        """Comm-consistent: depends only on comm properties and the
        dtype, which MPI requires to match across ranks (stray host
        buffers are moved to the rank's device at the deposit)."""
        if comm.size == 1 or comm.mesh() is None:
            return False
        return _dtype_of(x) is not None

    @staticmethod
    def _folds(op: Op) -> bool:
        return op.name in _XLA_REDUCERS or op.name in _GATHER_FOLD

    _deposit = staticmethod(_deposit)

    def _run(self, comm, x, body, ck=None):
        out = meet(comm, self._deposit(comm, x), body, _abort_check(comm),
                   ck)
        self.pvar_offload.add(1)
        return out

    def _tier(self, comm, kind, x, **kw):
        out = pipeline.maybe_device_coll(self, comm, kind, x, **kw)
        if out is not pipeline.UNHANDLED:
            self.pvar_offload.add(1)
        return out

    def allreduce_arr(self, comm, x, op: Op):
        if not self._eligible(comm, x) or not self._folds(op) \
                or _measured_host_wins(comm, "allreduce", _nbytes(x)):
            return self.fallback.allreduce_arr(comm, x, op)
        out = self._tier(comm, "allreduce", x, op=op)
        if out is not pipeline.UNHANDLED:
            return out
        x, was_scalar = _norm(x)
        out = self._run(comm, x, lambda s: _mesh_allreduce(s, op.name),
                        _ck("allreduce", op.name, x))
        return out.reshape(()) if was_scalar else out

    def reduce_scatter_block_arr(self, comm, x, op: Op):
        shp = _shape_of(x)
        if not self._eligible(comm, x) or not self._folds(op) \
                or not shp or shp[0] % comm.size:
            return self.fallback.reduce_scatter_block_arr(comm, x, op)
        return self._run(comm, x,
                         lambda s: _mesh_reduce_scatter(s, op.name),
                         _ck("reduce_scatter", op.name, x))

    def allgather_arr(self, comm, x):
        if not self._eligible(comm, x):
            return self.fallback.allgather_arr(comm, x)
        x, _ = _norm(x)
        return self._run(comm, x, _mesh_allgather, _ck("allgather", "", x))

    def alltoall_arr(self, comm, x):
        shp = _shape_of(x)
        if not self._eligible(comm, x) or not shp or shp[0] % comm.size \
                or _measured_host_wins(comm, "alltoall", _nbytes(x)):
            return self.fallback.alltoall_arr(comm, x)
        out = self._tier(comm, "alltoall", x)
        if out is not pipeline.UNHANDLED:
            return out
        return self._run(comm, x, _mesh_alltoall, _ck("alltoall", "", x))

    def bcast_arr(self, comm, x, root: int):
        if not self._eligible(comm, x) \
                or _measured_host_wins(comm, "bcast", _nbytes(x)):
            return self.fallback.bcast_arr(comm, x, root)
        out = self._tier(comm, "bcast", x, root=root)
        if out is not pipeline.UNHANDLED:
            return out
        x, was_scalar = _norm(x)
        out = self._run(comm, x, lambda s: _bcast_copies(s, root),
                        _ck("bcast", "", x, root))
        return out.reshape(()) if was_scalar else out

    def reduce_arr(self, comm, x, op: Op, root: int):
        if not _reduce_as_allreduce_var.value:
            return self.fallback.reduce_arr(comm, x, op, root)
        out = self.allreduce_arr(comm, x, op)
        return out if comm.rank == root else None

    def ppermute_arr(self, comm, x, perm):
        """Neighbour shift — the ring-attention / pipeline primitive."""
        if not self._eligible(comm, x):
            return self.fallback.ppermute_arr(comm, x, perm)
        x, _ = _norm(x)
        pmap = {int(a): int(b) for a, b in perm}
        return self._run(comm, x, lambda s: _ppermute_copies(s, pmap))

    def neighbor_allgather_arr(self, comm, x, srcs):
        """``srcs[m]``: member m's sources in MPI neighbour order."""
        if not self._eligible(comm, x):
            return self.fallback.neighbor_allgather_arr(comm, x, srcs)
        return self._run(comm, x, lambda s: _neighbor_gather(s, srcs))


class PartlySharedModule(CollModule):
    """Members that partly share devices (8 ranks on 4 cards): neither
    one device (coll/hbm) nor pairwise-distinct devices (the mesh).
    The reference host-stages such a comm's calls; the port refuses
    them on every member instead of copying device data through the
    host."""

    name = "tpu"

    def _refuse(self, comm, *args, **kwargs):
        raise NotImplementedError(
            "the members of this communicator partly share devices: "
            "neither the mesh tier (pairwise-distinct devices) nor "
            "coll/hbm (one shared device) takes it, and the port does "
            "not stage device data through the host")

    allreduce_arr = bcast_arr = reduce_arr = allgather_arr = _refuse
    alltoall_arr = reduce_scatter_block_arr = ppermute_arr = _refuse
    neighbor_allgather_arr = _refuse


class TpuComponent(CollComponent):
    name = "tpu"

    @property
    def priority(self):
        return _prio_tpu.value

    def comm_query(self, comm):
        keys = _member_devices(comm)
        if keys is None or len(set(keys)) < 2:
            return None
        if comm.mesh() is None:
            return (self.priority, PartlySharedModule())
        return (self.priority, TpuCollModule(_host_arr_fallback()))


class HbmComponent(CollComponent):
    name = "hbm"

    @property
    def priority(self):
        return _prio_hbm.value

    def comm_query(self, comm):
        keys = _member_devices(comm)
        if keys is None or len(set(keys)) != 1 or comm.size == 1:
            return None
        return (self.priority, HbmCollModule(_host_arr_fallback()))


class ArrHostComponent(CollComponent):
    name = "arr_host"
    priority = 5

    def comm_query(self, comm):
        return (self.priority, HostArrModule())


_host_fallback_lock = threading.Lock()
_host_fallback_singleton: Optional[HostArrModule] = None


def _host_arr_fallback() -> HostArrModule:
    """Process-wide host-staged *_arr fallback shared by every device
    module (stateless beyond its decision hooks)."""
    global _host_fallback_singleton
    with _host_fallback_lock:
        if _host_fallback_singleton is None:
            _host_fallback_singleton = HostArrModule()
        return _host_fallback_singleton


coll_framework.add_component(TpuComponent())
coll_framework.add_component(HbmComponent())
coll_framework.add_component(ArrHostComponent())
