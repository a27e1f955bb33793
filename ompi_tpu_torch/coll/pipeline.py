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

Not ported yet (ROADMAP.md): the hierarchical tier (``hier``: it needs
``topo.slice_groups`` and the health plane) and the tracing spans.
"""

from __future__ import annotations

from collections import deque
from typing import Any, List, Optional

import torch

from ompi_tpu_torch.kernels import stacked
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.obs import integrity as _ig

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

pv_segments = registry.register_pvar(
    "coll", "pipeline", "segments",
    help="Segments dispatched through the pipelined rendezvous")
pv_ops = registry.register_pvar(
    "coll", "pipeline", "ops",
    help="Collectives routed to the segmented large-message tier")

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


def _run_pipelined(comm, jobs, ck=None) -> List[Any]:
    """Drive (value, fn) segment jobs through the async rendezvous
    with bounded depth.  Every begun handle is finished even on error
    — peers park on the generation's refcounted results.  ``ck`` is
    the integrity-plane spec shared by every segment (each segment
    takes its own sampling decision at the meet gate)."""
    from ompi_tpu_torch.coll import device
    depth = max(1, _depth_var.value)
    check = device._abort_check(comm)
    it = iter(jobs)
    handles: deque = deque()
    outs: List[Any] = []
    try:
        while True:
            job = next(it, None)
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
    return _concat_trim(outs, n, seg).reshape(shape)


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
# the entry consulted by coll/device (HbmCollModule, TpuCollModule)
# ---------------------------------------------------------------------------

def maybe_device_coll(module, comm, kind: str, x, op=None, root=None):
    """Route one *_arr call to the large-message tier, or return
    ``UNHANDLED`` (the caller keeps its single-dispatch path).  Must be
    comm-consistent: the pick depends only on knobs, the process-wide
    calibration profile, comm properties and the MPI-matched payload
    size.  On one card (hbm) a bcast is one shared-memory handoff
    already; the mesh segments it."""
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
    if module.name == "hbm":
        if kind == "allreduce":
            out = _hbm_seg_reduce(module, comm, x, op)
        elif kind == "alltoall":
            out = _hbm_seg_alltoall(module, comm, x)
        else:
            return UNHANDLED
    elif kind == "allreduce":
        out = _mesh_seg_reduce(module, comm, x, op, alg)
    elif kind == "bcast":
        out = _mesh_seg_bcast(module, comm, x, root)
    elif kind == "alltoall":
        out = _mesh_seg_alltoall(module, comm, x)
    else:
        return UNHANDLED
    pv_ops.add(1)
    return out
