"""Collectives framework: per-communicator module stacks with
per-function merging.

Re-design of ompi/mca/coll selection (ref: coll_base_comm_select.c:
51-58,128-151,262-300 — every component is queried with the comm,
returns a module + priority, and the winning *function pointers* are
merged per collective so different components can serve different
collectives on the same communicator; module interface ref:
coll.h:139-256).

The merged vtable lives on ``comm.coll``.  Components register here;
coll/basic, coll/base+tuned, coll/hbm and arr_host each fill the
functions they implement, and the highest-priority provider of each
function wins — exactly how the reference lets coll/tuned own
allreduce while coll/sm owns barrier on the same comm.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ompi_tpu_torch.mca.base import Component, frameworks

coll_framework = frameworks.create("ompi", "coll")

# the collective function names a module may provide
COLL_FUNCS = (
    "barrier", "bcast", "reduce", "allreduce", "allgather", "allgatherv",
    "gather", "gatherv", "scatter", "scatterv", "alltoall", "alltoallv",
    "alltoallw", "reduce_scatter", "reduce_scatter_block", "scan", "exscan",
    # nonblocking
    "ibarrier", "ibcast", "ireduce", "iallreduce", "iallgather",
    "iallgatherv", "igather", "igatherv", "iscatter", "iscatterv",
    "ialltoall", "ialltoallv",
    "ireduce_scatter", "ireduce_scatter_block", "iscan", "iexscan",
    # device-array collectives (tensors in, tensors out) — the
    # coll/hbm surface; ppermute is the neighbor-shift primitive
    # (ring attention / pipeline parallelism)
    "allreduce_arr", "bcast_arr", "reduce_arr", "allgather_arr",
    "alltoall_arr", "reduce_scatter_block_arr", "ppermute_arr",
    # the cartesian halo gather (topo.neighbor.neighbor_allgather_arr)
    "neighbor_allgather_arr",
    # nonblocking device-array collectives: the fusion surface
    "iallreduce_arr", "ibcast_arr",
)


class CollModule:
    """Base class: set attributes named after COLL_FUNCS."""

    def enable(self, comm) -> None:
        pass


class MergedColl:
    """The per-comm vtable of winning collective implementations."""

    def __init__(self) -> None:
        self.providers: Dict[str, Any] = {}

    def __getattr__(self, name: str):
        # AttributeError (not NotImplementedError) so hasattr/getattr
        # probing for optional collectives behaves normally
        if name in COLL_FUNCS:
            raise AttributeError(
                f"no collective module provides '{name}' on this comm")
        raise AttributeError(name)


class CollComponent(Component):
    def comm_query(self, comm) -> Optional[tuple]:
        """Return (priority, module) or None."""
        return None

    def query(self, comm=None):
        if comm is None:
            return (self.priority, None)
        return self.comm_query(comm)


def _instrumented(fname: str, fn):
    """Entry shim over a winning blocking collective: the SHARED
    instrumentation point for span tracing and the extended PERUSE
    coll events (ompi_tpu_torch/trace coll_begin/coll_end).  When both
    systems are off, coll_begin returns None after one flag check and
    the shim is a bare pass-through — nonblocking collectives are not
    shimmed (their lifecycle is observed by the nbc hooks instead).

    The reference's shim also runs the ULFM entry check (a collective
    on a revoked comm, or one naming a failed member, raises); the port
    has no ULFM yet (ROADMAP.md A7), so that check comes with it."""
    from ompi_tpu_torch import trace

    # intern once at wrap time: the shim passes a small int on the
    # hot path, never a string; the hook functions bind into the
    # closure so each call skips the module attribute lookups
    fid = trace.intern_name(fname, ("cid", "seq"))
    _begin = trace.coll_begin
    _end = trace.coll_end

    def shim(comm, *args, **kwargs):
        pr = comm.state.progress
        if pr.interrupt is not None:
            # armed interrupts fire at blocking-collective entry: the
            # device providers can complete whole ops on their own
            # fast paths without one progress sweep, so a rank looping
            # over collectives would otherwise never consume its
            # pending interrupt
            pr.progress()
        tok = _begin(comm, fid)
        if tok is None:
            return fn(comm, *args, **kwargs)
        out = fn(comm, *args, **kwargs)
        if tok:
            # falsy tok == sampled out: nothing to close, skip the
            # coll_end call itself (kept-span tokens and peruse tuples
            # are always truthy)
            _end(comm, fid, tok)
        return out

    shim._coll_inner = fn  # the unwrapped provider, for introspection
    return shim


def comm_select(comm) -> None:
    """Stack modules on a communicator (coll_base_comm_select analog)."""
    merged = MergedColl()
    candidates = coll_framework.select_all(comm)  # sorted high→low
    for pri, component, module in reversed(candidates):  # low→high overlay
        if module is None:
            continue
        module.enable(comm)
        for fname in COLL_FUNCS:
            fn = getattr(module, fname, None)
            if fn is not None:
                # blocking collectives get the entry-span shim; the
                # i* surface completes asynchronously and is observed
                # at its own lifecycle points (nbc/fusion hooks)
                setattr(merged, fname,
                        fn if fname.startswith("i")
                        else _instrumented(fname, fn))
                merged.providers[fname] = component.name
    comm.coll = merged
    # verify the mandatory blocking set is covered
    for fname in ("barrier", "bcast", "allreduce", "reduce", "allgather",
                  "alltoall", "gather", "scatter", "reduce_scatter_block"):
        if not hasattr(merged, fname):
            raise RuntimeError(
                f"no coll component provides {fname} for {comm}")
