"""Small-message collective fusion/coalescing: the device fast path
for batches of small nonblocking collectives, on ranks that share one
card (hbm mode) and on ranks with distinct devices (mesh mode).

Every device collective pays a size-independent constant (the
rendezvous of the rank threads, the wrapper, the launch), so at small
payloads the constant is the whole cost.  The fix is the reference's
message-coalescing idea: when a rank has several small collectives
pending (surfaced through the nonblocking coll surface, coll/nbc),
they meet ONCE per batch.  In hbm mode a batch runs as ONE kernel
launch per (op, dtype) group (K3 ``fused_batch``, kernels/fused.py),
bcasts joining the SUM group of their dtype as copy-from-root entries.
In mesh mode each rank first packs its slots of each group into one
buffer on its own device (K7 ``slot_pack``, one launch a group, before
the meeting: ``_build_pack``; a non-root bcast slot packs as zeros),
and the meeting reduces each group's packed buffers as ONE mesh
allreduce (K6 + K2 peer, two launches a device), sliced back out as
views — the reference's masked psum per (reducer, dtype) group.  One
rendezvous and a few launches amortized over N collectives.

Surface: ``comm.iallreduce_arr`` / ``comm.ibcast_arr`` return a
``FusedRequest``; pending ops coalesce until an explicit
``comm.flush_arr()``, a ``wait()``/``test()`` on any request of the
batch, the ``coll_device_fusion_max_ops`` bound, or MPI_Finalize
(finalize hook) flushes them.  Ineligible ops (big payloads, host-only
comms, dtypes or ops the kernel does not take) execute immediately
through the blocking vtable and return an already-complete request —
callers never branch.

Batch symmetry: the flush is one rendezvous per batch, so every member
rank must enqueue the SAME sequence of collectives between flushes
(the usual SPMD discipline MPI already requires for collective
ordering).  The batch signature is validated at the meeting point — a
divergent batch raises a clear error on every rank instead of
deadlocking.

A batch is checked by the integrity plane as one op (``_fused_ck``):
one claim a slot (hbm) or a group buffer (mesh), or none at all.

A traced flush records a ``fused_flush`` span (cat ``coll``); a mesh
batch's pack a ``fused_pack`` span and, with ``trace_phase_enable``,
a ``ph_pack`` phase of the meeting that follows.

Cross-session batching (the reference's serve plane): resident
sessions — independent thread worlds of one process, each in its own
cid band (``testing.sessions.run_sessions``; the pool's socket plane
will sit on top of it) — share the card, so their fused batches, each
already one meeting, can share the launches too when they land within
``dvm_batch_window_us`` of each other.  The window opens only while
``set_xsession_hint`` reports more than one resident session.  The
last arriver of a session's meeting hands its batch to ``_xdispatch``;
the first under a key (("hbm", N), or ("mesh", the members' devices))
leads: it sleeps the window inside its meeting body, then runs ONE
combined dispatch over every batch that joined — a K3 launch a (op,
dtype) group for all sessions' slots (hbm), or one K6 and one K2 peer
launch a card a group over all sessions' group buffers (mesh) — and
hands each session its outputs, byte for byte the outputs of its solo
dispatch.  A batch joins a window only while every group still fits
one launch (``_hbm_fits``, ``_mesh_fits``); one that would not leads a
window of its own, so nothing splits and nothing falls back.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch import convert
from ompi_tpu_torch import obs as _obs
from ompi_tpu_torch import trace as _trace
from ompi_tpu_torch.kernels import fused
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.obs import integrity as _ig
from ompi_tpu_torch.op.op import Op
from ompi_tpu_torch.pml.request import Request

_fusion_var = registry.register(
    "coll", "device", "fusion", True, bool,
    help="Coalesce pending small nonblocking device collectives "
         "(iallreduce_arr/ibcast_arr) into one rendezvous and one "
         "launch per (op, dtype) group per batch, amortizing the "
         "per-op constant")
_threshold_var = registry.register(
    "coll", "device", "fusion_threshold", 65536, int,
    help="Per-op payload bound (bytes) for fusion eligibility; larger "
         "payloads are bandwidth-dominated and run unfused "
         "immediately")
_max_ops_var = registry.register(
    "coll", "device", "fusion_max_ops", 32, int,
    help="Auto-flush a pending fusion batch at this many collectives "
         "(bounds result latency and the batch's kernel arguments)")

# session-banded (ompi_tpu_torch/obs): each flush belongs to exactly
# one session (the engine is per comm, the comm's state carries
# cid_band); global reads through the registry are untouched
_pv_batches = _obs.scoped_pvar(
    "coll", "device", "fused_batches",
    help="Fused device-collective batches dispatched")
_pv_colls = _obs.scoped_pvar(
    "coll", "device", "fused_collectives",
    help="Individual collectives that rode in a fused batch")
_pv_bytes = _obs.scoped_pvar(
    "coll", "device", "fused_bytes",
    help="Payload bytes carried by fused batches")

# -- cross-session batching -------------------------------------------------
_xwin_var = registry.register(
    "dvm", "", "batch_window_us", 0, int,
    help="Cross-session fusion window (microseconds): a fused batch "
         "dispatched from a resident session waits this long for "
         "compatible batches from OTHER resident sessions and rides "
         "one combined dispatch with them.  0 disables.  Only "
         "consulted while more than one session is resident")
_pv_xbatches = registry.register_pvar(
    "dvm", "", "xsession_batches",
    help="Combined dispatches that carried fused batches from 2+ "
         "concurrently-resident sessions")
_pv_xcolls = registry.register_pvar(
    "dvm", "", "xsession_collectives",
    help="Individual collectives that rode a cross-session combined "
         "dispatch")

_xsession_hint = 0  # resident-session count (testing/sessions.py)


def set_xsession_hint(n: int) -> None:
    """The host of resident sessions reports their count here on every
    attach and detach; the cross-session window opens only above 1."""
    global _xsession_hint
    _xsession_hint = n

class FusedRequest(Request):
    """Request handle for a (possibly) coalesced device collective.

    ``result`` is the output tensor once complete.  Completion requires
    running the fused batch — a bare progress sweep cannot do that, so
    ``wait()`` AND ``test()`` both flush the owning engine's pending
    batch (the batch rendezvous blocks on peers; under the SPMD batch
    discipline they are flushing too)."""

    def __init__(self, progress, engine) -> None:
        super().__init__(progress)
        self._engine = engine
        self._error: Optional[BaseException] = None
        self.result = None

    def _deliver(self, value) -> None:
        self.result = value
        self._complete()

    def _fail(self, exc: BaseException) -> None:
        self._error = exc
        self._complete()

    def test(self) -> bool:
        if not self.complete and self._engine is not None:
            self._engine.flush()
        return self.complete

    def wait(self, timeout=None):
        if not self.complete and self._engine is not None:
            self._engine.flush()
        st = super().wait(timeout)
        if self._error is not None:
            raise RuntimeError(
                f"fused device collective failed: {self._error}"
            ) from self._error
        return st


class _Pending:
    __slots__ = ("kind", "x", "extra", "was_scalar", "nbytes", "req")

    def __init__(self, kind, x, extra, was_scalar, nbytes, req) -> None:
        self.kind = kind            # "allreduce" | "bcast"
        self.x = x                  # normalized payload (ndim >= 1)
        self.extra = extra          # opname (allreduce) or root (bcast)
        self.was_scalar = was_scalar
        self.nbytes = nbytes
        self.req = req


def _nbytes_of(x) -> int:
    """Payload bytes from shape x itemsize (runs on every enqueue)."""
    n = 1
    for s in x.shape:
        n *= s
    return n * (x.element_size() if isinstance(x, torch.Tensor)
                else x.dtype.itemsize)


#: a batch signature entry: (kind, shape, dtype, opname or root)
SigEntry = Tuple[str, tuple, Any, Any]


def _group_plan(sig: Sequence[SigEntry]):
    """Static fusion plan, a pure function of the batch signature (so
    every rank derives the same plan): slots grouped by (op, dtype) in
    first-seen order — a bcast joins the SUM group of its dtype (a
    copy-from-root entry in hbm mode, a root-masked summand in mesh
    mode).  K3 and K6 fold every op the stacked kernel takes, so unlike
    the reference's mesh mode there are no gather-fold slots: one
    packed buffer a group is the whole mesh deposit."""
    groups: Dict[tuple, List[int]] = {}
    for i, (kind, _shape, dt, extra) in enumerate(sig):
        key = ("MPI_SUM", dt) if kind == "bcast" else (extra, dt)
        groups.setdefault(key, []).append(i)
    return tuple((opname, dt, tuple(slots))
                 for (opname, dt), slots in groups.items())


def _hbm_batch_outs(size: int, sigs: Sequence[Sequence[SigEntry]],
                    arrays) -> List[List[List[torch.Tensor]]]:
    """Run the hbm batches of one or more sessions: ``arrays[s][r][i]``
    is session s's rank r payload of slot i.  Slots are grouped by (op,
    dtype) across the sessions, and each group is ONE K3 call — split
    only where one session's group outgrows the kernel's argument
    block.  A combined group past it raises: the batcher admits no
    session that would push a group past it (``_hbm_fits``).  Returns
    outs[s][r] = session s's rank r list of slot outputs, each its own
    tensor."""
    outs = [[[None] * len(sig) for _ in range(size)] for sig in sigs]
    keyed: Dict[tuple, List[Tuple[int, int]]] = {}
    for s, sig in enumerate(sigs):
        for opname, dt, slots in _group_plan(sig):
            keyed.setdefault((opname, dt), []).extend((s, i) for i in slots)
    for (opname, _dt), members in keyed.items():
        entries = []
        for s, i in members:
            kind, _shape, _dt2, extra = sigs[s][i]
            entries.append(([arrays[s][r][i] for r in range(size)],
                            extra if kind == "bcast" else None))
        res = fused.fused_batch(entries, opname) if len(sigs) == 1 \
            else fused.fused_batch(entries, opname, split=False)
        for (s, i), per_rank in zip(members, res):
            for r in range(size):
                outs[s][r][i] = per_rank[r]
    return outs


def _group_counts(sigs: Sequence[Sequence[SigEntry]]) -> Dict[tuple, List[int]]:
    """(op, dtype) -> the slots of that group in each session that has
    one (``_group_plan`` across the sessions, as the combined
    dispatches key them)."""
    counts: Dict[tuple, List[int]] = {}
    for sig in sigs:
        for opname, dt, slots in _group_plan(sig):
            counts.setdefault((opname, dt), []).append(len(slots))
    return counts


def _hbm_fits(size: int, sigs: Sequence[Sequence[SigEntry]]) -> bool:
    """Whether the sessions' hbm batches ride one combined dispatch:
    every (op, dtype) group's slots, summed over the sessions, fit one
    K3 launch (``fused.per_launch``)."""
    per = fused.per_launch(size)
    return all(sum(c) <= per for c in _group_counts(sigs).values())


def _mesh_fits(size: int, sigs: Sequence[Sequence[SigEntry]]) -> bool:
    """Whether the sessions' mesh batches ride one combined dispatch:
    every (op, dtype) group's buffers, one a session, fit one K6 table
    a card (``mesh.sets_per_launch``)."""
    from ompi_tpu_torch.kernels import mesh
    per = mesh.sets_per_launch(size)
    return all(len(c) <= per for c in _group_counts(sigs).values())


def _hbm_slot_outs(size: int, sig: Sequence[SigEntry],
                   arrays: Sequence[Sequence[torch.Tensor]]):
    """One session's hbm batch: ``arrays[r][i]`` is rank r's payload of
    slot i; one K3 call a (op, dtype) group.  Returns outs[r]."""
    return _hbm_batch_outs(size, (sig,), (arrays,))[0]


def _build_pack(rank: int, sig: Sequence[SigEntry],
                xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Mesh mode, on the owning rank's thread before the meeting: one
    packed buffer a (op, dtype) group on this rank's device (K7, one
    launch a group), a non-root bcast slot packed as zeros."""
    from ompi_tpu_torch.datatype.device import pack_segments
    return [pack_segments([xs[i] for i in slots],
                          [sig[i][0] == "bcast" and sig[i][3] != rank
                           for i in slots])
            for _op, _dt, slots in _group_plan(sig)]


def _mesh_batch_outs(size: int, sigs: Sequence[Sequence[SigEntry]],
                     deposits) -> List[List[List[torch.Tensor]]]:
    """Run the mesh batches of one or more sessions: ``deposits[s][r]``
    is session s's rank r packed group buffers.  The group buffers of
    one (op, dtype) across the sessions reduce as ONE rank-order mesh
    allreduce (``device._mesh_allreduce_sets``: one K6 and one K2 peer
    launch a card; a combined table past K6's raises, and the batcher
    admits no session that would push it there: ``_mesh_fits``), each
    session's result sliced back into its slots as views.  Returns
    outs[s][r][i]."""
    from ompi_tpu_torch.coll import device
    from ompi_tpu_torch.datatype.device import unpack_segments
    outs = [[[None] * len(sig) for _ in range(size)] for sig in sigs]
    keyed: Dict[tuple, List[Tuple[int, int, tuple]]] = {}
    for s, sig in enumerate(sigs):
        for gi, (opname, dt, slots) in enumerate(_group_plan(sig)):
            keyed.setdefault((opname, dt), []).append((s, gi, slots))
    for (opname, _dt), members in keyed.items():
        red = device._mesh_allreduce_sets(
            [[deposits[s][r][gi] for r in range(size)]
             for s, gi, _ in members], opname, split=len(sigs) == 1)
        for (s, _gi, slots), per_rank in zip(members, red):
            shapes = [sigs[s][i][1] for i in slots]
            for r in range(size):
                for i, o in zip(slots, unpack_segments(per_rank[r], shapes)):
                    outs[s][r][i] = o
    return outs


def _mesh_slot_outs(size: int, sig: Sequence[SigEntry],
                    deposits: Sequence[Sequence[torch.Tensor]]):
    """One session's mesh batch: one mesh allreduce a (op, dtype)
    group.  Returns outs[r][i]."""
    return _mesh_batch_outs(size, (sig,), (deposits,))[0]


def _fused_ck(mode, sig):
    """Integrity spec for one fused batch: one claim per deposit
    buffer — hbm mode digests each slot tensor (claim index = slot),
    mesh mode each packed group buffer (claim index = group).  Returns
    None when any slot falls outside the checkable algebra (another
    reduce op, an unchecked dtype): a partly checked batch could not
    attribute a mismatch to one rank, so the whole batch runs
    unchecked instead."""
    ents = []
    if mode == "hbm":
        for i, (kind, _shape, dt, extra) in enumerate(sig):
            if kind == "bcast":
                s = _ig.spec_static("bcast", "", dt, extra)
                if s is None:
                    return None
                ents.append(("b", s[1], i, int(extra), s[2]))
            else:
                s = _ig.spec_static("allreduce", extra, dt)
                if s is None:
                    return None
                ents.append(("g", s[1], i, (i,), s[2]))
    else:
        for gi, (opname, dt, slots) in enumerate(_group_plan(sig)):
            # bcast slots ride SUM groups root-masked to zero, so the
            # group conservation sum covers them exactly
            s = _ig.spec_static("allreduce", opname, dt)
            if s is None:
                return None
            ents.append(("g", s[1], gi, slots, s[2]))
    return ("fused", tuple(ents))


def _x_marks(tensors) -> Optional[Dict[Any, Any]]:
    """An event on the calling thread's current stream of each card
    ``tensors`` lie on (None off the cards): what a combined dispatch
    orders itself after, or what its sessions wait on."""
    marks = {}
    for t in tensors:
        if t.is_cuda and t.device not in marks:
            ev = marks[t.device] = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(t.device))
    return marks or None


def _x_wait(marks) -> None:
    """The calling thread's current streams wait on ``marks``."""
    for dev, ev in (marks or {}).items():
        torch.cuda.current_stream(dev).wait_event(ev)


def _x_tensors(args) -> List[torch.Tensor]:
    return [t for per_rank in args for t in per_rank]


class _XEntry:
    __slots__ = ("sig", "args", "ready", "outs", "done", "err", "event")

    def __init__(self, sig, args) -> None:
        self.sig = sig
        self.args = args
        # the session's deposits are ready on ITS body thread's streams
        # (coll/device._fence); a leader on another stream waits here
        self.ready = _x_marks(_x_tensors(args))
        self.outs = None
        self.done = None
        self.err: Optional[BaseException] = None
        self.event = threading.Event()


class _XBatcher:
    """Process-global meeting point for cross-session batch
    coalescing.  Callers are the last-arriver threads of independent
    sessions' batch rendezvous (device.meet's body) — one thread per
    session batch.  The first arriver under a compatibility key
    becomes the leader: it holds the window open, then runs ONE
    combined dispatch over every batch that joined and hands each
    follower its outputs.  A batch joins only while ``fits`` holds for
    the window's signatures and its own, so that every combined
    dispatch stays one launch a group; one that does not fit leads a
    window of its own, and the window it found takes no more batches.
    Entries are sorted by signature before
    combining, so the combined launches do not depend on arrival
    order.  Stream order: the leader's streams wait on every
    session's ready events before the launches, and every session's
    streams wait on the leader's done events before it returns."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.groups: Dict[Any, List[_XEntry]] = {}  # key -> open window

    def run(self, key, sig, args, single_fn, multi_fn, fits):
        win_s = max(0, _xwin_var.value) / 1e6
        e = _XEntry(sig, args)
        with self.lock:
            grp = self.groups.get(key)
            leader = grp is None or not fits([x.sig for x in grp] + [sig])
            if leader:
                grp = self.groups[key] = [e]
            else:
                grp.append(e)
        if leader:
            time.sleep(win_s)
            with self.lock:
                if self.groups.get(key) is grp:
                    del self.groups[key]
            self._dispatch(grp, single_fn, multi_fn)
        if not e.event.wait(timeout=120.0):
            raise RuntimeError(
                "cross-session batch leader did not dispatch within "
                "120s (dvm_batch_window_us misconfigured or leader "
                "session died mid-window)")
        if e.err is not None:
            raise RuntimeError(
                f"cross-session combined dispatch failed: {e.err}"
            ) from e.err
        _x_wait(e.done)
        return e.outs

    def _dispatch(self, entries, single_fn, multi_fn) -> None:
        try:
            if len(entries) == 1:
                entries[0].outs = single_fn(entries[0].args)
            else:
                order = sorted(range(len(entries)),
                               key=lambda i: repr(entries[i].sig))
                for i in order:
                    _x_wait(entries[i].ready)
                    for t in _x_tensors(entries[i].args):
                        if t.is_cuda:
                            t.record_stream(
                                torch.cuda.current_stream(t.device))
                outs = multi_fn([entries[i].sig for i in order],
                                [entries[i].args for i in order])
                done = _x_marks(t for per in outs for per_rank in per
                                for t in per_rank)
                ncolls = 0
                for i, o in zip(order, outs):
                    entries[i].outs = o
                    entries[i].done = done
                    ncolls += len(entries[i].sig)
                _pv_xbatches.add(1)
                _pv_xcolls.add(ncolls)
        except BaseException as exc:  # noqa: BLE001
            for e in entries:
                e.err = exc
        finally:
            for e in entries:
                e.event.set()


_xbatcher = _XBatcher()


def _xdispatch(key, sig, args, single_fn, multi_fn, fits):
    """Run one session's prepared fused batch: straight through when
    the cross-session window is closed (knob 0, or fewer than 2
    resident sessions), else through the batcher.  ``single_fn(args)``
    is the solo dispatch; ``multi_fn(sigs, argss)`` the combined one,
    returning one output list a session; ``fits(sigs)`` whether those
    sessions' batches fit one combined dispatch."""
    if _xwin_var.value <= 0 or _xsession_hint < 2:
        return single_fn(args)
    return _xbatcher.run(key, sig, args, single_fn, multi_fn, fits)


class _FusionEngine:
    """Per-comm, per-rank staging area for pending fusible collectives.
    Single-threaded (each rank owns its comm object); flush runs the
    whole batch through ONE device.meet rendezvous."""

    def __init__(self, comm) -> None:
        from ompi_tpu_torch.coll import device
        self.comm = comm
        prov = getattr(comm.coll, "providers", None) or {}
        m = prov.get("allreduce_arr")
        if m == "tpu" and comm.mesh() is None:
            m = None  # partly shared devices: the blocking calls refuse
        self.mode = m if m in ("tpu", "hbm") else None
        # the cross-session key of a mesh batch: the members' devices
        self._dev_key = tuple(device._member_devices(comm)) \
            if self.mode == "tpu" else None
        self.pending: List[_Pending] = []
        self._abort_check = device._abort_check(comm)
        # finalize hook registration happens HERE, not at the first
        # meet(): a batch enqueued and never waited on must still
        # flush at MPI_Finalize, even if no blocking collective ran
        device.track_state(comm.state)

    def enqueue(self, kind, x, extra, nbytes) -> FusedRequest:
        was_scalar = x.dim() == 0
        if was_scalar:
            x = x.reshape(1)
        req = FusedRequest(self.comm.state.progress, self)
        self.pending.append(
            _Pending(kind, x, extra, was_scalar, nbytes, req))
        if len(self.pending) >= max(1, _max_ops_var.value):
            self.flush()
        return req

    def flush(self) -> None:
        if not self.pending:
            return
        batch, self.pending = self.pending, []
        tr = self.comm.state.tracer
        t0 = tr.start_sampled(_trace.CAT_COLL) if tr is not None else 0
        try:
            outs = self._run(batch)
        except BaseException as e:  # noqa: BLE001
            for p in batch:
                p.req._fail(e)
            raise
        if t0:
            tr.end(t0, _trace.NAME_FUSED_FLUSH, _trace.CAT_COLL,
                   self.comm.cid, len(batch))
        nbytes = 0
        for p, out in zip(batch, outs):
            nbytes += p.nbytes
            p.req._deliver(out.reshape(()) if p.was_scalar else out)
        band = self.comm.state.cid_band
        _pv_batches.add(1, band)
        _pv_colls.add(len(batch), band)
        _pv_bytes.add(nbytes, band)

    def _run(self, batch: List[_Pending]) -> List[torch.Tensor]:
        from ompi_tpu_torch.coll import device

        comm = self.comm
        size = comm.size
        mode = self.mode
        sig = tuple((p.kind, tuple(p.x.shape), p.x.dtype, p.extra)
                    for p in batch)

        def body(shards):
            sig0 = shards[0][0]
            for r, (s, _a) in enumerate(shards):
                if s != sig0:
                    raise RuntimeError(
                        f"fused-collective batch mismatch: rank {r} "
                        f"enqueued {s} but rank 0 enqueued {sig0}; "
                        "every member must issue the same nonblocking "
                        "device collectives between flushes")
            arrays = [a for _s, a in shards]
            if mode == "hbm":
                return _xdispatch(
                    ("hbm", size, comm.state.device), sig0, arrays,
                    lambda a: _hbm_slot_outs(size, sig0, a),
                    lambda sigs, argss: _hbm_batch_outs(size, sigs, argss),
                    lambda sigs: _hbm_fits(size, sigs))
            return _xdispatch(
                ("mesh", self._dev_key), sig0, arrays,
                lambda a: _mesh_slot_outs(size, sig0, a),
                lambda sigs, argss: _mesh_batch_outs(size, sigs, argss),
                lambda sigs: _mesh_fits(size, sigs))

        arrays = [device._deposit(comm, p.x) for p in batch]
        if mode != "hbm":
            arrays = self._pack_groups(sig, arrays)
        ck = _fused_ck(mode, sig) if _ig.on else None
        return device.meet(comm, (sig, arrays), body, self._abort_check, ck)

    def _pack_groups(self, sig, arrays):
        """Mesh-mode deposit payload: this rank's slots packed into one
        buffer a (reducer, dtype) group (K7), on the owning rank's
        thread BEFORE the rendezvous.  Traced as ``fused_pack``, the
        host-pack phase of the op the following meet() dispatches —
        comm._dev_seq is exactly the seq that meet will record."""
        comm = self.comm
        tr = comm.state.tracer
        t0 = tr.start_sampled(_trace.CAT_COLL) if tr is not None else 0
        tp = tr.start_sampled(_trace.CAT_PHASE) \
            if tr is not None and tr.phase else 0
        deposit = _build_pack(comm.rank, sig, arrays)
        if tp:
            tr.end(tp, _trace.NAME_PH_PACK, _trace.CAT_PHASE,
                   comm.cid, comm._dev_seq, 0)
        if t0:
            tr.end(t0, _trace.NAME_FUSED_PACK, _trace.CAT_COLL,
                   comm.cid, len(_group_plan(sig)[0]), len(sig))
        return deposit


def _engine(comm) -> _FusionEngine:
    eng = comm.__dict__.get("_fusion_engine")
    if eng is None:
        eng = comm.__dict__["_fusion_engine"] = _FusionEngine(comm)
    return eng


def _as_arr(x):
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _dtype_of(x) -> Optional[torch.dtype]:
    if isinstance(x, torch.Tensor):
        return x.dtype
    try:
        return convert.torch_dtype(x.dtype)
    except KeyError:
        return None


def _eligible(comm, kind: str, x, opname, nbytes: int) -> bool:
    """Comm-consistent fusion gate: depends only on comm properties,
    the MCA knobs (process-wide), and dtype/op/nbytes — all of which
    MPI requires to match across members.  The kernel must take the
    (dtype, op) pair (SUM for a bcast), so an ineligible call runs
    through the blocking path, which takes it or raises on every
    member."""
    if not _fusion_var.value or comm.size == 1:
        return False
    if _engine(comm).mode is None:
        return False
    dt = _dtype_of(x)
    if dt is None:
        return False
    if not fused.reduce_supported(
            dt, "MPI_SUM" if kind == "bcast" else opname):
        return False
    return 0 < nbytes <= max(0, _threshold_var.value)


def _immediate(comm, value) -> FusedRequest:
    req = FusedRequest(comm.state.progress, None)
    req._deliver(value)
    return req


def iallreduce_arr(comm, x, op: Op) -> FusedRequest:
    """Nonblocking device-array allreduce; small payloads coalesce
    into the comm's pending fusion batch."""
    x = _as_arr(x)
    nbytes = _nbytes_of(x)
    if not op.is_user and _eligible(comm, "allreduce", x, op.name,
                                    nbytes):
        return _engine(comm).enqueue("allreduce", _tensor(comm, x),
                                     op.name, nbytes)
    return _immediate(comm, comm.coll.allreduce_arr(comm, x, op))


def ibcast_arr(comm, x, root: int = 0) -> FusedRequest:
    """Nonblocking device-array broadcast; small payloads coalesce
    into the comm's pending fusion batch (a copy-from-root entry of
    its dtype's SUM group)."""
    x = _as_arr(x)
    nbytes = _nbytes_of(x)
    if _eligible(comm, "bcast", x, None, nbytes):
        return _engine(comm).enqueue("bcast", _tensor(comm, x),
                                     int(root), nbytes)
    return _immediate(comm, comm.coll.bcast_arr(comm, x, root))


def _tensor(comm, x) -> torch.Tensor:
    """A pending payload as a tensor (host buffers move to the comm's
    device at enqueue, as the blocking path moves them at the
    deposit)."""
    if isinstance(x, torch.Tensor):
        return x
    return convert.to_torch(x, comm.state.device)


def flush_comm(comm) -> None:
    """Run this comm's pending fusion batch now (collective over the
    comm: all members must flush)."""
    eng = comm.__dict__.get("_fusion_engine")
    if eng is not None:
        eng.flush()


def flush_state(state) -> None:
    """Finalize hook: flush every comm's pending batch for this rank
    so no enqueued collective dies with the process (runs before the
    finalize fence — peers are still alive to rendezvous)."""
    first = None
    for comm in list(state.comms.values()):
        if comm is None:  # freed comm leaves its cid slot behind
            continue
        try:
            flush_comm(comm)
        except BaseException as e:  # noqa: BLE001
            if first is None:
                first = e
    if first is not None:
        raise first
