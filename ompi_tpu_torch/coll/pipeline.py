"""coll/pipeline: the large-message tier of the device collective
engine, for ranks that share one card (coll/hbm) and for ranks on
distinct devices (the mesh, coll/tpu).

The single-dispatch path (one rendezvous, one kernel a device) owns the
small-message regime.  At or above ``coll_pipeline_min_bytes`` a call
takes this tier instead (ref: coll_tuned_decision_fixed.c:72 segmented
ring above 1 MiB):

* an **allreduce** goes through the compiled-plan path (coll/plan:
  ``hbm_reduce``, one identity-padded stacked kernel, or
  ``mesh_reduce``, one pull-reduce a device; one rendezvous) when
  ``coll_plan_enable`` is on, else through per-segment kernels
  pipelined through the asynchronous rendezvous;
* an **alltoall** runs fixed-size segments — segment k covers columns
  [k*m, (k+1)*m) of every destination block — pipelined the same way;
* on the mesh a **bcast** runs segments too (segbcast).

The mesh schedules of the reference (``_build_seg_kernel``: segring,
segrd, segbcast, sega2a) circulate data hop by hop with ppermute.  The
port computes what the hops compute with pulls: segring and segrd are
K6 mesh_fold folds in the ring order (stripe c of a segment folds
ranks c, c+1, ..., c-1) or the recursive-doubling tree, then a K2 peer
gather of the stripes; segbcast and sega2a are K2 peer copies.  Every
element is the same chain of binary ops as the reference's, so the
results are its bytes.  The mesh segments need no identity pad (the
kernels take any length and the ring geometry by index) and write
straight into the caller's output (no concatenation).

**Pipelining**: segments run through ``device.meet_begin`` /
``meet_finish``: a rank deposits segment k and immediately packs
(slices, pads) segment k+1 on its own thread while the dispatcher
thread launches segment k; depth is bounded by
``coll_pipeline_depth``.

**Segment-size discipline**: every segment of every message is padded
to ONE fixed segment shape (op identity elements, trimmed at unpack),
so every segment of every size takes the same kernel arguments.

Every segment of an op carries the op's integrity check spec to its
meeting, where it takes its own sampling decision.

**The hierarchical tier** (``hier``, ``coll_hier_enable``): on a mesh
comm of two or more slices (``topo.slice_groups``: forced blocks of
``coll_hier_slice_size`` ranks, else the device's slice index or the
modex node id) of two or more ranks each, an allreduce of at least
``coll_hier_min_bytes`` reduces inside each slice on the device (the
intra-slice comm's own tier: K6 + K2 peer), combines the slice results
between the slice leaders over the host path, and fans the total back
out inside each slice (``bcast_arr``: K2 peer copies).  The leader
hop stages explicitly, where the reference hands a jax array to its
host module: the slice result goes D2H into a pinned stage
(``runtime.staging.aligned_empty``) on the leader's stream, the leader
waits on that copy's event, the leaders allreduce the stage's numpy
view into a second pinned stage over the host p2p stack
(``HostArrModule``'s tuned module), and the total goes H2D from that
stage on the same stream, ahead of the bcast's deposit event.  On the
CPU the stages are ``aligned_empty``'s numpy buffers.  A stage that
cannot be pinned raises; nothing falls back to a pageable copy.  A
rank on a host the health plane holds degraded biases its split key,
so a slice's leader lands on a healthy host when the slice has one.
An hbm comm (one card) never takes the tier.

Tracing: a traced call of this tier records one ``pipeline_<kind>``
span (cat ``coll_dispatch``, its algorithm as an arg) around the
whole op; with ``trace_phase_enable``, the pack of each segment
(``ph_pack``, around the segment generator's step) and the unpack
(``ph_unpack``) are phases of it, and each segment's meeting records
its own ``seg_meet`` span and phases (coll/device).
"""

from __future__ import annotations

from collections import deque
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch import convert
from ompi_tpu_torch import trace as _trace
from ompi_tpu_torch.kernels import stacked
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.obs import integrity as _ig

# interned span names for the per-kind dispatch spans (args: cid,
# payload bytes, interned algorithm tag)
_PIPE_NAME = {
    kind: _trace.intern_name(f"pipeline_{kind}",
                             ("cid", "nbytes", "alg$"))
    for kind in ("allreduce", "bcast", "alltoall")
}

# phase-profiler aliases: host pack (segment slicing) and unpack
# (trim + concat) sub-op phases
_CAT_PHASE = _trace.CAT_PHASE
_NAME_PH_PACK = _trace.NAME_PH_PACK
_NAME_PH_UNPACK = _trace.NAME_PH_UNPACK
# the hierarchical tier's leader hop, one span a step a leader an op:
# ``pinned`` is 1 where the stage is page-locked host memory
_NAME_HOP_D2H = _trace.intern_name("ph_hop_d2h",
                                   ("cid", "nbytes", "pinned"))
_NAME_HOP_HOST = _trace.intern_name("ph_hop_host", ("cid", "nbytes"))
_NAME_HOP_H2D = _trace.intern_name("ph_hop_h2d",
                                   ("cid", "nbytes", "pinned"))

_seg_size_var = registry.register(
    "coll", "seg", "size", 1 << 20, int,
    help="Segment size (bytes) for the segmented/pipelined large-"
         "message device algorithms (ref: "
         "coll_tuned_decision_fixed.c:72).  Rounded up so stripes and "
         "alltoall blocks stay equal; coll_tuned_use_measured_rules "
         "replaces this with the calibrated per-host segment size")
_depth_var = registry.register(
    "coll", "pipeline", "depth", 2, int,
    help="Outstanding segments in the pipelined rendezvous: host "
         "packing of segment k+1 overlaps device dispatch of segment "
         "k up to this depth.  1 = fully synchronous")
_enable_var = registry.register(
    "coll", "pipeline", "enable", True, bool,
    help="Enable the segmented/pipelined large-message device tier "
         "(messages below coll_pipeline_min_bytes keep the single-"
         "dispatch path either way)")
_min_bytes_var = registry.register(
    "coll", "pipeline", "min_bytes", 4 << 20, int,
    help="Static single-dispatch-vs-segmented crossover: messages at "
         "least this large take the segmented tier.  "
         "coll_tuned_use_measured_rules replaces it with the "
         "calibrated per-host crossover")
_rd_max_var = registry.register(
    "coll", "pipeline", "rd_max_bytes", 8 << 20, int,
    help="Upper bound of the per-segment recursive-doubling window "
         "(power-of-two comms): above it the ring's lower bytes-on-"
         "the-wire wins (2(P-1)/P x n vs log2(P) x n)")

_hier_var = registry.register(
    "coll", "hier", "enable", False, bool,
    help="Enable the hierarchical allreduce tier: intra-slice device "
         "allreduce + inter-slice reduction between the slice leaders "
         "over the host path (pinned stages) + intra-slice bcast.  "
         "Needs >= 2 slices of >= 2 ranks (topo.slice_groups)")
_hier_slice_var = registry.register(
    "coll", "hier", "slice_size", 0, int,
    help="Force hierarchical slices of this many consecutive ranks "
         "(0 = auto: group by device slice_index, else modex node)")
_hier_min_var = registry.register(
    "coll", "hier", "min_bytes", 1 << 20, int,
    help="Static minimum payload for the hierarchical tier (the "
         "leader hop adds host-path latency that small messages "
         "cannot amortize)")

pv_segments = registry.register_pvar(
    "coll", "pipeline", "segments",
    help="Segments dispatched through the pipelined rendezvous")
pv_ops = registry.register_pvar(
    "coll", "pipeline", "ops",
    help="Collectives routed to the segmented large-message tier")
pv_hier = registry.register_pvar(
    "coll", "hier", "ops",
    help="Collectives routed to the hierarchical tier")

#: returned by maybe_device_coll when the large-message tier does not
#: apply and the caller should keep its single-dispatch path
UNHANDLED = object()


def _pad_value(opname: Optional[str], dtype: torch.dtype) -> Any:
    """Identity element of the op — tail segments are padded with it
    so EVERY segment takes one shape and the padding cannot perturb
    real elements (it is trimmed off, and every tier reduces
    elementwise).  The same table as the reference's, type for type:
    for bool, MAX and MIN both pad with True there too."""
    is_int = not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool
    if opname == "MPI_MAX":
        if is_int:
            return torch.iinfo(dtype).min
        return True if dtype == torch.bool else float("-inf")
    if opname == "MPI_MIN":
        if is_int:
            return torch.iinfo(dtype).max
        return True if dtype == torch.bool else float("inf")
    if opname in ("MPI_PROD", "MPI_LAND"):
        return True if dtype == torch.bool else 1
    if opname == "MPI_BAND":
        if is_int:
            # every bit set: -1 for a signed type, the maximum for an
            # unsigned one
            info = torch.iinfo(dtype)
            return -1 if info.min < 0 else info.max
        return True if dtype == torch.bool else 1
    # SUM, OR/XOR families, and data-movement kinds (bcast/alltoall)
    return False if dtype == torch.bool else 0


# ---------------------------------------------------------------------------
# the pipelined executor
# ---------------------------------------------------------------------------

def segment_elems(comm, itemsize: int) -> int:
    """Per-host segment size in elements, rounded UP to a multiple of
    the comm size so stripes and alltoall blocks stay equal."""
    from ompi_tpu_torch.coll import calibrate
    seg_bytes = calibrate.segment_bytes(comm.size, _seg_size_var.value)
    elems = max(comm.size, seg_bytes // max(1, itemsize))
    rem = elems % comm.size
    return elems + (comm.size - rem) if rem else elems


def _pull_segment(it, ph):
    """Pack stage: pull one (value, fn) job from the segment
    generator.  The slice+pad work happens inside next(), so the span
    around it IS the host-pack phase.  Hot (once per segment, per
    rank): audited by hotpath_audit.  A non-None ctx sampled in at
    build time (Tracer.gate_sampled), so every segment of a kept op
    records.  The exhausted-iterator probe records one ~0 span."""
    if ph is None:
        return next(it, None)
    tr = ph[0]
    t0 = tr.start()
    job = next(it, None)
    tr.end(t0, _NAME_PH_PACK, _CAT_PHASE, ph[1], ph[2], ph[3])
    return job


def _run_pipelined(comm, jobs, ck=None) -> List[Any]:
    """Drive (value, fn) segment jobs through the async rendezvous
    with bounded depth.  Every begun handle is finished even on error
    — peers park on the generation's refcounted results.  ``ck`` is
    the integrity-plane spec shared by every segment (each segment
    takes its own sampling decision at the meet gate)."""
    from ompi_tpu_torch.coll import device
    depth = max(1, _depth_var.value)
    check = device._abort_check(comm)
    tr = comm.state.tracer
    ph = ((tr, comm.cid, 0, 0)
          if tr is not None and tr.phase and tr.gate_sampled(_CAT_PHASE)
          else None)
    it = iter(jobs)
    handles: deque = deque()
    outs: List[Any] = []
    try:
        while True:
            job = _pull_segment(it, ph)
            if job is None:
                break
            value, fn = job
            handles.append(device.meet_begin(comm, value, fn, check, ck))
            pv_segments.add(1)
            if len(handles) > depth:
                outs.append(device.meet_finish(comm, handles.popleft(),
                                               check))
        while handles:
            outs.append(device.meet_finish(comm, handles.popleft(), check))
    except BaseException:
        while handles:  # drain: results are refcounted per generation
            try:
                device.meet_finish(comm, handles.popleft(), check)
            except BaseException:  # noqa: BLE001 — already failing
                pass
        raise
    return outs


def _flat_segments(flat: torch.Tensor, n: int, seg: int, pad):
    """Slice ``flat`` into fixed-size segments, padding the tail with
    the op identity — the pack stage (slicing segment k+1 overlaps the
    launch of segment k through the async meet).  Full segments are
    views; the tail is a new tensor composed on the caller's stream."""
    for lo in range(0, n, seg):
        piece = flat[lo:lo + seg]
        if piece.shape[0] < seg:
            piece = torch.cat([piece, torch.full(
                (seg - piece.shape[0],), pad, dtype=piece.dtype,
                device=piece.device)])
        yield piece


def _concat_trim(outs: List[torch.Tensor], n: int, seg: int
                 ) -> torch.Tensor:
    """Unpack stage: trim the padded tail and concatenate."""
    tail = n - (len(outs) - 1) * seg
    if tail != seg:
        outs = outs[:-1] + [outs[-1][:tail]]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _unpack_trim(comm, outs: List[torch.Tensor], n: int, seg: int
                 ) -> torch.Tensor:
    """Unpack stage: trim the padded tail and concatenate, wrapped in
    a ph_unpack phase span when the phase profiler is armed."""
    tr = comm.state.tracer
    if tr is None or not tr.phase:
        return _concat_trim(outs, n, seg)
    t0 = tr.start_sampled(_CAT_PHASE)
    out = _concat_trim(outs, n, seg)
    if t0:
        tr.end(t0, _NAME_PH_UNPACK, _CAT_PHASE, comm.cid, 0, 0)
    return out


# ---------------------------------------------------------------------------
# hbm (intra-card) segmentation
# ---------------------------------------------------------------------------

def _hbm_seg_reduce(module, comm, x, op):
    """Segmented intra-card allreduce: the compiled-plan path (one
    stacked whole-payload kernel, one rendezvous) when enabled, else
    per-segment stacked kernels (elementwise over the rank axis —
    bit-exact against the single stacked reduce at any dtype),
    pipelined through the async meet."""
    from ompi_tpu_torch.coll import plan
    if plan.enabled():
        return plan.hbm_reduce(module, comm, x, op)
    x = module._deposit(comm, x)
    shape = x.shape
    flat = x.reshape(-1)
    n = flat.shape[0]
    seg = segment_elems(comm, flat.element_size())
    fn = module._stacked_fn("allreduce", op.name)
    pad = _pad_value(op.name, flat.dtype)
    ck = _ig.spec("allreduce", op.name, flat) if _ig.on else None
    outs = _run_pipelined(comm, ((p, fn) for p in _flat_segments(
        flat, n, seg, pad)), ck)
    return _unpack_trim(comm, outs, n, seg).reshape(shape)


def _hbm_seg_alltoall(module, comm, x):
    x = module._deposit(comm, x)
    size = comm.size
    shape = x.shape
    rows = x.reshape(size, -1)  # row p = the block for rank p
    cols = rows.shape[1]
    seg = segment_elems(comm, rows.element_size())
    m = max(1, seg // size)
    fn = module._stacked_fn("alltoall", "")

    def jobs():
        for lo in range(0, cols, m):
            sub = rows[:, lo:lo + m]
            if sub.shape[1] < m:
                sub = torch.cat([sub, torch.zeros(
                    (size, m - sub.shape[1]), dtype=sub.dtype,
                    device=sub.device)], dim=1)
            yield sub.reshape(-1), fn

    ck = _ig.spec("alltoall", "", rows) if _ig.on else None
    outs = _run_pipelined(comm, jobs(), ck)
    pieces = [o.reshape(size, m) for o in outs]
    tail = cols - (len(pieces) - 1) * m
    if tail != m:
        pieces = pieces[:-1] + [pieces[-1][:, :tail]]
    full = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)
    return full.reshape(shape)


# ---------------------------------------------------------------------------
# mesh (coll/tpu) schedules
# ---------------------------------------------------------------------------

def fold_order(alg: str, size: int, seg: int):
    """The K6 order of a segmented mesh allreduce (see
    ``kernels.mesh._order``): segring's ring over ``seg``-element
    segments of ``size`` stripes, or segrd's tree."""
    return ("ring", seg, seg // size) if alg == "segring" else "tree"


def _mesh_seg_reduce(module, comm, x, op, alg: str):
    """Segmented allreduce over the mesh: the compiled-plan path (one
    pull-reduce over the whole payload, one rendezvous) when enabled,
    else one segring / segrd fold a segment, pipelined; each segment's
    gather writes straight into this rank's output."""
    from ompi_tpu_torch.coll import device, plan
    if plan.enabled():
        return plan.mesh_reduce(module, comm, x, op, alg)
    x = module._deposit(comm, x)
    flat = x.reshape(-1)
    n = flat.shape[0]
    seg = segment_elems(comm, flat.element_size())
    order = fold_order(alg, comm.size, seg)
    out = torch.empty(n, dtype=flat.dtype, device=flat.device)

    def fn(slots):
        return device._mesh_allreduce([p for p, _ in slots], op.name,
                                      order, outs=[o for _, o in slots])

    ck = _ig.spec("allreduce", op.name, flat) if _ig.on else None
    _run_pipelined(comm, (((flat[lo:lo + seg], out[lo:lo + seg]), fn)
                          for lo in range(0, n, seg)), ck)
    return out.reshape(x.shape)


def _mesh_seg_bcast(module, comm, x, root: int):
    """Segmented bcast over the mesh (segbcast): each segment is one K2
    peer launch a card from the root's segment into the members'
    outputs."""
    x = module._deposit(comm, x)
    flat = x.reshape(-1)
    n = flat.shape[0]
    seg = segment_elems(comm, flat.element_size())
    out = torch.empty(n, dtype=flat.dtype, device=flat.device)

    def fn(slots):
        outs = [o for _, o in slots]
        return stacked.peer_copy_many([slots[root][0]], outs,
                                      outs[0].numel())

    ck = _ig.spec("bcast", "", flat, root) if _ig.on else None
    _run_pipelined(comm, (((flat[lo:lo + seg], out[lo:lo + seg]), fn)
                          for lo in range(0, n, seg)), ck)
    return out.reshape(x.shape)


def _mesh_seg_alltoall(module, comm, x):
    """Segmented pairwise alltoall over the mesh (sega2a): segment k
    moves columns [k*m, (k+1)*m) of every block.  A rank deposits its
    segment as one contiguous (P, w) operand (the reference's segment
    shape: what the integrity gate digests and a retry re-reads), and
    one K2 peer launch a card writes block d of every source's segment
    into each member d's output in place.  Each member's output
    of a segment is its column slice of that output."""
    x = module._deposit(comm, x)
    size = comm.size
    rows = x.reshape(size, -1)  # row p = the block for rank p
    cols = rows.shape[1]
    m = max(1, segment_elems(comm, rows.element_size()) // size)
    out = torch.empty(x.numel(), dtype=x.dtype, device=x.device)

    def jobs():
        for lo in range(0, cols, m):
            w = min(m, cols - lo)

            def fn(slots, lo=lo, w=w):
                stacked.peer_copy_many([s for s, _ in slots],
                                       [o for _, o in slots], w,
                                       src_stride=w, out_stride=cols,
                                       out_off=lo)
                return [o.view(size, cols)[:, lo:lo + w] for _, o in slots]
            yield (rows[:, lo:lo + w].reshape(-1), out), fn

    ck = _ig.spec("alltoall", "", rows) if _ig.on else None
    _run_pipelined(comm, jobs(), ck)
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# hierarchical tier
# ---------------------------------------------------------------------------

def hier_eligible(comm) -> bool:
    """Comm-consistent: slice grouping depends only on modex/device
    data every member shares.  Cached — consulted per large message."""
    cached = comm.__dict__.get("_hier_eligible")
    if cached is not None:
        return cached
    ok = False
    if _hier_var.value and comm.size >= 4 and comm.mesh() is not None:
        from ompi_tpu_torch.topo import topo as topomod
        groups = topomod.slice_groups(comm, _hier_slice_var.value)
        # need >= 2 slices of >= 2 ranks each: a 1-rank slice would
        # make the intra tier a no-op and the leader hop pure overhead
        ok = len(groups) >= 2 and all(len(g) >= 2 for g in groups)
    comm.__dict__["_hier_eligible"] = ok
    return ok


def _hier_plan(comm) -> Tuple[Any, Optional[Any]]:
    """(intra_slice_comm, leader_comm_or_None) — built collectively at
    first use (the pick is comm-consistent, so every member arrives
    together) and cached."""
    plan = comm.__dict__.get("_hier_plan")
    if plan is None:
        from ompi_tpu_torch.comm.communicator import UNDEFINED
        from ompi_tpu_torch.obs import health as _health
        from ompi_tpu_torch.topo import topo as topomod
        groups = topomod.slice_groups(comm, _hier_slice_var.value)
        mine = next(i for i, g in enumerate(groups) if comm.rank in g)
        # gray-failure reroute: a rank resident on a degraded host
        # biases its OWN split key past every healthy rank's, so the
        # slice leader (intra.rank 0 = smallest key) lands on a
        # healthy host whenever the slice has one.  The split is
        # computed from the GATHERED keys, so the result stays
        # collectively consistent even if members read the mask at
        # slightly different moments
        node = getattr(getattr(comm.state, "rte", None), "node_id", 0)
        key = comm.rank + (comm.size
                           if _health.node_degraded(node) else 0)
        intra = comm.split(mine, key=key)
        lead = comm.split(0 if intra.rank == 0 else UNDEFINED,
                          key=key)
        plan = (intra, lead)
        comm.__dict__["_hier_plan"] = plan
    return plan


def _leader_hop(lead, y: torch.Tensor, op) -> torch.Tensor:
    """Combine the slice results ``y`` across the slice leaders.  One
    D2H into a pinned stage on the leader's current stream, then a wait
    on that copy's event; the leaders' host allreduce over
    ``HostArrModule``'s p2p stack from that stage into a second pinned
    stage (numpy views: no tensor reaches the host module); one H2D
    into a new tensor shaped like ``y``, queued on the same stream, so
    the intra-slice bcast's deposit event, recorded after it, orders
    the bcast after the copy (the caching host allocator keeps the
    stage until the copy is done).  On the CPU both stages are
    ``aligned_empty``'s numpy buffers and the result shares the second
    one's memory.  A stage that cannot be pinned raises.  Under phase
    tracing each step is one span (``ph_hop_d2h``, ``ph_hop_host``,
    ``ph_hop_h2d``)."""
    from ompi_tpu_torch.coll import device
    from ompi_tpu_torch.runtime import staging
    nbytes = y.numel() * y.element_size()
    send = staging.aligned_empty(nbytes, y.device)
    recv = staging.aligned_empty(nbytes, y.device)
    host = isinstance(send, np.ndarray)
    npdt = convert.numpy_dtype(y.dtype)
    a = (send if host else send.numpy()).view(npdt)
    r = (recv if host else recv.numpy()).view(npdt)
    tr = lead.state.tracer
    ph = tr is not None and tr.phase and tr.gate_sampled(_CAT_PHASE)
    t0 = tr.start() if ph else 0
    staging.d2h(y.contiguous(), send)
    if ph:
        tr.end(t0, _NAME_HOP_D2H, _CAT_PHASE, lead.cid, nbytes,
               int(not host and send.is_pinned()))
        t0 = tr.start()
    device._host_arr_fallback().allreduce_into(lead, a, r, op)
    if ph:
        tr.end(t0, _NAME_HOP_HOST, _CAT_PHASE, lead.cid, nbytes)
        t0 = tr.start()
    if host:
        out = convert.to_torch(r, y.device).reshape(y.shape)
    else:
        out = torch.empty(y.shape, dtype=y.dtype, device=y.device)
        staging.h2d(recv, out)
    if ph:
        tr.end(t0, _NAME_HOP_H2D, _CAT_PHASE, lead.cid, nbytes,
               int(not host and recv.is_pinned()))
    return out


def _hier_allreduce(module, comm, x, op):
    """Reduce inside each slice on the device, combine slice results
    over the leaders' host path, fan the total back out on the device.
    The inter-slice hop moves ONE slice-reduced payload per slice
    instead of serializing the whole comm through one link."""
    intra, lead = _hier_plan(comm)
    y = intra.allreduce_arr(x, op)
    if lead is not None:
        y = _leader_hop(lead, y, op)
    pv_hier.add(1)
    return intra.bcast_arr(y, 0)


# ---------------------------------------------------------------------------
# the entry consulted by coll/device (HbmCollModule, TpuCollModule)
# ---------------------------------------------------------------------------

def maybe_device_coll(module, comm, kind: str, x, op=None, root=None):
    """Route one *_arr call to the large-message tier, or return
    ``UNHANDLED`` (the caller keeps its single-dispatch path).  Must be
    comm-consistent: the pick depends only on knobs, the process-wide
    calibration profile, comm properties and the MPI-matched payload
    size.  On one card (hbm) a bcast is one shared-memory handoff
    already; the mesh segments it.  The hbm branch comes first, so an
    hbm comm never takes the hierarchical tier."""
    if not _enable_var.value:
        return UNHANDLED
    nbytes = x.numel() * x.element_size() \
        if isinstance(x, torch.Tensor) else int(getattr(x, "nbytes", 0))
    if nbytes <= 0 or comm.size < 2:
        return UNHANDLED
    from ompi_tpu_torch.coll import tuned
    alg = tuned.device_algorithm(comm, kind, nbytes,
                                 op.name if op is not None else None)
    if alg is None:
        return UNHANDLED
    tr = comm.state.tracer
    t0 = tr.start_sampled(_trace.CAT_COLL_DISPATCH) \
        if tr is not None else 0
    if module.name == "hbm":
        if kind == "allreduce":
            out = _hbm_seg_reduce(module, comm, x, op)
        elif kind == "alltoall":
            out = _hbm_seg_alltoall(module, comm, x)
        else:
            return UNHANDLED
    elif alg == "hier":
        out = _hier_allreduce(module, comm, x, op)
    elif kind == "allreduce":
        out = _mesh_seg_reduce(module, comm, x, op, alg)
    elif kind == "bcast":
        out = _mesh_seg_bcast(module, comm, x, root)
    elif kind == "alltoall":
        out = _mesh_seg_alltoall(module, comm, x)
    else:
        return UNHANDLED
    pv_ops.add(1)
    if t0:
        tr.end(t0, _PIPE_NAME[kind], _trace.CAT_COLL_DISPATCH,
               comm.cid, nbytes, _trace.intern_name(alg))
    return out
