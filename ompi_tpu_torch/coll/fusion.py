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

Not ported yet (ROADMAP.md): the cross-session batcher (``_XBatcher``,
``_build_fused_mesh_multi``, ``dvm_batch_window_us``: it needs the host
pool of resident sessions that reports their count) and the tracing
spans.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch import convert
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

_pv_batches = registry.register_pvar(
    "coll", "device", "fused_batches",
    help="Fused device-collective batches dispatched")
_pv_colls = registry.register_pvar(
    "coll", "device", "fused_collectives",
    help="Individual collectives that rode in a fused batch")
_pv_bytes = registry.register_pvar(
    "coll", "device", "fused_bytes",
    help="Payload bytes carried by fused batches")

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


def _hbm_slot_outs(size: int, sig: Sequence[SigEntry],
                   arrays: Sequence[Sequence[torch.Tensor]]):
    """Run one hbm batch: ``arrays[r][i]`` is rank r's payload of slot
    i.  Slots are grouped by (op, dtype), and each group is ONE K3 call
    (split only where a group outgrows the kernel's argument block).
    Returns outs[r] = rank r's list of slot outputs, each its own
    tensor."""
    outs = [[None] * len(sig) for _ in range(size)]
    for opname, _dt, slots in _group_plan(sig):
        entries = []
        for i in slots:
            kind, _shape, _dt2, extra = sig[i]
            entries.append(([arrays[r][i] for r in range(size)],
                            extra if kind == "bcast" else None))
        res = fused.fused_batch(entries, opname)
        for i, per_rank in zip(slots, res):
            for r in range(size):
                outs[r][i] = per_rank[r]
    return outs


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


def _mesh_slot_outs(size: int, sig: Sequence[SigEntry],
                    deposits: Sequence[Sequence[torch.Tensor]]):
    """Run one mesh-mode batch: ``deposits[r]`` is rank r's packed
    group buffers.  Each group is ONE mesh allreduce with the group's
    op (rank-order fold), its result sliced back into the slots as
    views of each rank's own buffer.  Returns outs[r][i]."""
    from ompi_tpu_torch.coll import device
    from ompi_tpu_torch.datatype.device import unpack_segments
    outs = [[None] * len(sig) for _ in range(size)]
    for gi, (opname, _dt, slots) in enumerate(_group_plan(sig)):
        red = device._mesh_allreduce([deposits[r][gi] for r in range(size)],
                                     opname)
        shapes = [sig[i][1] for i in slots]
        for r in range(size):
            for i, o in zip(slots, unpack_segments(red[r], shapes)):
                outs[r][i] = o
    return outs


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
        try:
            outs = self._run(batch)
        except BaseException as e:  # noqa: BLE001
            for p in batch:
                p.req._fail(e)
            raise
        nbytes = 0
        for p, out in zip(batch, outs):
            nbytes += p.nbytes
            p.req._deliver(out.reshape(()) if p.was_scalar else out)
        _pv_batches.add(1)
        _pv_colls.add(len(batch))
        _pv_bytes.add(nbytes)

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
                return _hbm_slot_outs(size, sig0, arrays)
            return _mesh_slot_outs(size, sig0, arrays)

        arrays = [device._deposit(comm, p.x) for p in batch]
        if mode != "hbm":
            arrays = _build_pack(comm.rank, sig, arrays)
        ck = _fused_ck(mode, sig) if _ig.on else None
        return device.meet(comm, (sig, arrays), body, self._abort_check, ck)


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
