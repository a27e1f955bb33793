"""coll/plan: collective plans — ONE rendezvous per large-message
allreduce, one stacked kernel on one card (hbm) or one pull-reduce a
device on a mesh.

The pipelined tier (coll/pipeline.py) pays one rendezvous and one
launch per segment.  A plan moves every decision out of steady state:
for each (segment geometry, dtype, op) it resolves ONCE a ``Plan``
holding the meeting body (the stacked reduce, K1) and the pad
identity.  Executing a plan is pure data motion:

    pack (identity-pad to the plan's fixed shape, composed on the card:
    ``torch.full`` + ``torch.cat`` on the depositor's stream)
      -> ONE ``device.meet`` (one rendezvous, one K1 launch over all
         nsegs * seg elements)
      -> unpack (trim) + pvar accounting.

A payload that is not a whole number of plan elements (a ragged size)
pays the pack: one extra on-card copy of its payload.  The reference's
zero-copy host-alias branch (``runtime/staging``) is not ported; the
port always takes the copying branch.

Keying: resolved ``Plan`` objects live per comm in
``comm._coll_plans`` (bounded LRU, ``coll_plan_cache_max``).
Sub-segment payloads quantize the plan shape to the next power of two
(a multiple of the comm size), full payloads use the calibrated
segment — the identity padding keeps every size on a log-bounded key
set.

Mesh plans (``mesh_reduce``, the port of ``_compile_mesh`` and
``_build_mesh_plan``): the reference compiles the whole multi-segment
segring or segrd schedule, or a native psum/pmax/pmin, into one
program over the identity-padded payload.  The port's body is one K6
mesh_fold a card in the schedule's order (the ring geometry of the
plan's segments, segrd's tree, or rank order for the native lowering)
and one K2 peer gather a card — over the payload as it is: the
kernels take any length and the ring geometry by index, so a mesh
plan neither pads nor trims.  With ``coll_plan_native_reduce`` (on by
default) SUM/MAX/MIN plans take the rank-order fold.

A plan carries the integrity check spec of its op (``Plan.ck``), built
once with ``spec_static`` (plans outlive arm and disarm); ``execute``
passes it to the meeting only while the plane is armed.

Tracing: a traced ``execute`` records one ``plan_exec`` span (cat
``coll_segment``, args cid, payload bytes and the plan's algorithm)
around pack, the meeting and unpack; with ``trace_phase_enable`` the
pack and unpack of a padded payload are ``ph_pack`` / ``ph_unpack``
phases of it.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import torch

from ompi_tpu_torch import trace as _trace
from ompi_tpu_torch.coll import pipeline as _pl
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.obs import integrity as _ig

_CAT_SEG = _trace.CAT_COLL_SEGMENT
_CAT_PHASE = _trace.CAT_PHASE
_NAME_PLAN = _trace.NAME_PLAN_EXEC
_NAME_PH_PACK = _trace.NAME_PH_PACK
_NAME_PH_UNPACK = _trace.NAME_PH_UNPACK

_enable_var = registry.register(
    "coll", "plan", "enable", True, bool,
    help="Resolve one plan per (segment geometry, dtype, op) and run "
         "each large-message allreduce as ONE rendezvous + ONE launch; "
         "0 = the per-segment pipelined rendezvous path")

_cache_max_var = registry.register(
    "coll", "plan", "cache_max", 32, int,
    help="Per-communicator bound on resolved Plan objects (LRU)")

_native_var = registry.register(
    "coll", "plan", "native_reduce", True, bool,
    help="Lower mesh plans for SUM/MAX/MIN as the native cross-replica "
         "reduction (one rank-order fold); 0 keeps the batched ring / "
         "recursive-doubling schedule for every op")

#: ops with a native cross-replica lowering
_NATIVE_OPS = frozenset(("MPI_SUM", "MPI_MAX", "MPI_MIN"))

#: interned alg ids for the plan_exec span
_ALG_ID = {
    "segring": _trace.intern_name("segring"),
    "segrd": _trace.intern_name("segrd"),
    "hbm": _trace.intern_name("hbm"),
}

pv_builds = registry.register_pvar(
    "coll", "plan", "builds",
    help="collective plans resolved (per rank): a Plan object built "
         "and cached on the comm — steady state should be ~0")
pv_hits = registry.register_pvar(
    "coll", "plan", "hits",
    help="collective ops served by an already-resolved plan")
pv_exec_us = registry.register_pvar(
    "coll", "plan", "exec_us",
    help="cumulative wall microseconds inside plan execution "
         "(pack + rendezvous + unpack)")


def enabled() -> bool:
    return bool(_enable_var.value)


def _plan_segments(comm, n: int, seg: int):
    """(nsegs, seg_elems) for an n-element payload.  Payloads below
    one calibrated segment quantize to the next pow2 (rounded to a
    comm-size multiple) so a 64 KiB message is not identity-padded to
    a 1 MiB plan; at or above, the calibrated segment is the unit.
    Either way the key set stays log-bounded in payload size."""
    size = comm.size
    if n < seg:
        s = 1
        while s < n:
            s <<= 1
        rem = s % size
        if rem:
            s += size - rem
        return 1, min(s, seg)
    return -(-n // seg), seg


class Plan:
    """One resolved collective plan: the prebound meeting body, the pad
    identity and the geometry.  Everything per-op-variable is an
    ``execute`` argument; everything else was decided at build."""

    __slots__ = ("alg_id", "nsegs", "seg", "total", "itemsize", "pad_val",
                 "fn", "ck")

    def __init__(self, alg: str, nsegs: int, seg: int, itemsize: int,
                 pad_val, fn, ck=None) -> None:
        self.alg_id = _ALG_ID[alg]
        self.itemsize = itemsize
        self.nsegs = nsegs
        self.seg = seg
        self.total = nsegs * seg
        self.pad_val = pad_val  # None: the plan takes any length
        self.fn = fn
        # integrity spec, built unconditionally (plans outlive
        # arm/disarm); execute() re-gates on the live arm flag
        self.ck = ck

    def execute(self, comm, flat: torch.Tensor, n: int) -> torch.Tensor:
        """The whole steady-state op: pack, one meet, unpack.  Hot
        (once per large-message collective): audited by hotpath_audit
        — pack/unpack and all key/closure work live off this path."""
        from ompi_tpu_torch.coll import device
        tr = comm.state.tracer
        t0 = 0
        if tr is not None:
            t0 = tr.start_sampled(_CAT_SEG)
        ns0 = time.perf_counter_ns()
        pad = self.pad_val is not None and n != self.total
        value = _pack(comm, flat, n, self) if pad else flat
        out = device.meet(comm, value, self.fn, device._abort_check(comm),
                          self.ck if _ig.on else None)
        if pad:
            out = _unpack(comm, out, n, self)
        pv_exec_us.add((time.perf_counter_ns() - ns0) // 1000)
        if t0:
            tr.end(t0, _NAME_PLAN, _CAT_SEG,
                   comm.cid, n * self.itemsize, self.alg_id)
        return out


def _pack(comm, flat: torch.Tensor, n: int, plan: Plan) -> torch.Tensor:
    """Identity-pad ``flat`` (n,) to the plan's fixed (total,) shape,
    composed on the card on the depositor's stream: one new tensor, so
    the caller's buffer is never written."""
    tr = comm.state.tracer
    t0 = tr.start_sampled(_CAT_PHASE) \
        if tr is not None and tr.phase else 0
    value = torch.cat([flat, torch.full((plan.total - n,), plan.pad_val,
                                        dtype=flat.dtype,
                                        device=flat.device)])
    if t0:
        tr.end(t0, _NAME_PH_PACK, _CAT_PHASE,
               comm.cid, 0, n * plan.itemsize)
    return value


def _unpack(comm, out: torch.Tensor, n: int, plan: Plan) -> torch.Tensor:
    tr = comm.state.tracer
    t0 = tr.start_sampled(_CAT_PHASE) \
        if tr is not None and tr.phase else 0
    res = out[:n]
    if t0:
        tr.end(t0, _NAME_PH_UNPACK, _CAT_PHASE,
               comm.cid, 0, n * plan.itemsize)
    return res


def _plans_of(comm) -> OrderedDict:
    plans = comm.__dict__.get("_coll_plans")
    if plans is None:
        plans = comm.__dict__["_coll_plans"] = OrderedDict()
    return plans


def _resolve(comm, pkey, builder) -> Plan:
    """Per-comm Plan LRU: hit moves to the back, build trims to
    coll_plan_cache_max.  comm objects are rank-local, so this needs
    no lock."""
    plans = _plans_of(comm)
    plan = plans.get(pkey)
    if plan is not None:
        plans.move_to_end(pkey)
        pv_hits.add(1)
        return plan
    plan = builder()
    plans[pkey] = plan
    cap = max(1, int(_cache_max_var.value))
    while len(plans) > cap:
        plans.popitem(last=False)
    pv_builds.add(1)
    return plan


# -- hbm (intra-card) plans -------------------------------------------------

def _build_hbm_plan(module, nsegs: int, seg: int, dtype,
                    opname: str) -> Plan:
    return Plan("hbm", nsegs, seg, dtype.itemsize,
                _pl._pad_value(opname, dtype),
                module._stacked_fn("allreduce", opname),
                _ig.spec_static("allreduce", opname, dtype))


def hbm_reduce(module, comm, x, op) -> torch.Tensor:
    """Plan-path intra-card allreduce: the stacked whole-payload
    kernel, through exactly one rendezvous."""
    x = module._deposit(comm, x)
    shape = None if x.dim() == 1 else x.shape
    flat = x if shape is None else x.reshape(-1)
    n = int(flat.shape[0])
    nsegs, seg = _plan_segments(
        comm, n, _pl.segment_elems(comm, flat.element_size()))
    pkey = ("hbm", nsegs, seg, flat.dtype, op.name)
    plan = _resolve(
        comm, pkey,
        lambda: _build_hbm_plan(module, nsegs, seg, flat.dtype, op.name))
    _pl.pv_segments.add(nsegs)
    out = plan.execute(comm, flat, n)
    return out if shape is None else out.reshape(shape)


# -- mesh plans -------------------------------------------------------------

def _build_mesh_plan(comm, alg: str, nsegs: int, seg: int, dtype,
                     opname: str, native: bool) -> Plan:
    from ompi_tpu_torch.coll import device
    order = "rank" if native else _pl.fold_order(alg, comm.size, seg)
    return Plan(alg, nsegs, seg, dtype.itemsize, None,
                lambda s: device._mesh_allreduce(s, opname, order),
                _ig.spec_static("allreduce", opname, dtype))


def mesh_reduce(module, comm, x, op, alg: str) -> torch.Tensor:
    """Plan-path allreduce over the mesh: resolve (or reuse) the plan
    for this payload's geometry, then one rendezvous."""
    x = module._deposit(comm, x)
    flat = x.reshape(-1)
    n = int(flat.shape[0])
    nsegs, seg = _plan_segments(
        comm, n, _pl.segment_elems(comm, flat.element_size()))
    native = bool(_native_var.value) and op.name in _NATIVE_OPS
    pkey = ("mesh", "native" if native else alg, nsegs, seg, flat.dtype,
            op.name)
    plan = _resolve(
        comm, pkey,
        lambda: _build_mesh_plan(comm, alg, nsegs, seg, flat.dtype, op.name,
                                 native))
    _pl.pv_segments.add(nsegs)
    return plan.execute(comm, flat, n).reshape(x.shape)
