"""coll/tuned: decision layer choosing algorithms by communicator and
message size.

Re-design of ompi/mca/coll/tuned fixed decisions
(ref: coll_tuned_decision_fixed.c:44-86 — allreduce: <10 KB →
recursive doubling; commutative → ring (segmented above 1 MiB);
else nonoverlapping) plus the dynamic rule-file mechanism
(ref: coll_tuned_dynamic_file.c:46-64) via the
``coll_tuned_dynamic_rules`` MCA parameter.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

from ompi_tpu_torch.coll import autotune
from ompi_tpu_torch.coll import base as alg
from ompi_tpu_torch.coll import calibrate
from ompi_tpu_torch.coll.basic import P2PCollModule, _is_pow2
from ompi_tpu_torch.coll.framework import CollComponent, coll_framework
from ompi_tpu_torch.mca.params import registry

_small_var = registry.register(
    "coll", "tuned", "allreduce_small_msg", 10000, int,
    help="Below this many bytes allreduce uses recursive doubling "
         "(ref: coll_tuned_decision_fixed.c:52)")
_seg_var = registry.register(
    "coll", "tuned", "allreduce_ring_segsize", 1 << 20, int,
    help="Segment size for segmented-ring allreduce "
         "(ref: coll_tuned_decision_fixed.c:72)")
_rules_var = registry.register(
    "coll", "tuned", "dynamic_rules", "", str,
    help="Path to a JSON rules file mapping collective -> "
         "[[max_bytes, algorithm_name], ...]")

_ALGS = {
    "allreduce": {
        "linear": alg.allreduce_linear,
        "recursive_doubling": alg.allreduce_recursivedoubling,
        "reduce_bcast": alg.allreduce_reduce_bcast,
        "ring": alg.allreduce_ring,
    },
    "bcast": {
        "linear": alg.bcast_linear,
        "binomial": alg.bcast_binomial,
        "pipeline": alg.bcast_pipeline,
    },
    "allgather": {
        "linear": alg.allgather_linear,
        "ring": alg.allgather_ring,
        "recursive_doubling": alg.allgather_recursivedoubling,
        "bruck": alg.allgather_bruck,
    },
    "alltoall": {
        "linear": alg.alltoall_linear,
        "pairwise": alg.alltoall_pairwise,
        "bruck": alg.alltoall_bruck,
    },
}


def _oversubscribed(comm) -> bool:
    """Comm-consistent oversubscription verdict: true when some node
    hosts more members of THIS comm than it has cores.  Computed from
    modex data (node_id, cores published at init) so every member
    reaches the same answer — a local-env hint would diverge (e.g. a
    dpm-spawned singleton vs its parent job) and split the comm
    across different algorithms: deadlock.  Cached per comm."""
    cached = getattr(comm, "_oversub_verdict", None)
    if cached is not None:
        return cached
    verdict = False
    if comm.size > 1:
        rte = comm.state.rte
        per_node: dict = {}
        cores_of: dict = {}
        # modex lookups may NOT be swallowed into a default verdict:
        # one rank silently defaulting while its peers compute true
        # is exactly the algorithm divergence (reduce_bcast vs ring)
        # this function exists to prevent — deadlock.  A missing key
        # (pre-modex bootstrap comms) is deterministic across members
        # and may default; a transport error must propagate loudly
        # (ADVICE r3 #4).
        try:
            for g in comm.group:
                node = rte.modex_get(g, "node_id")
                per_node[node] = per_node.get(node, 0) + 1
                if node not in cores_of:
                    cores_of[node] = int(rte.modex_get(g, "cores"))
            verdict = any(cnt > cores_of[n]
                          for n, cnt in per_node.items())
        except (KeyError, LookupError, AttributeError, TypeError,
                ValueError):
            # deterministic data-shape outcomes (key absent on every
            # member, non-modex rte): same default everywhere
            verdict = False
    comm._oversub_verdict = verdict
    return verdict


def device_algorithm(comm, kind: str, nbytes: int,
                     opname: Optional[str] = None) -> Optional[str]:
    """Large-message device-tier pick, the per-communicator analog of
    the reference's comm-bound module selection: None keeps the
    single-dispatch path; "hier" routes to the hierarchical tier;
    "segring"/"segrd"/"segbcast"/"sega2a" route to the segmented tier
    (coll/pipeline).  On a one-card comm every
    reduction pick takes the plan or the pipelined stacked path; on a
    mesh segring and segrd pick the fold order of the K6 pulls, and
    segbcast and sega2a the segmented K2 peer copies.

    Comm-consistent by construction — thresholds come from knobs and
    the process-wide calibration profile, and nbytes is MPI-matched —
    and cached per comm (a large message should pay one dict hit, not
    a profile walk, to be routed).

    With coll/autotune active the cache re-resolves at collective-seq
    WINDOW boundaries through a put-once shared snapshot: every
    member of a given collective shares the same seq, hence the same
    window, hence identical thresholds — the online profile updates
    can never split one collective across algorithms."""
    from ompi_tpu_torch.coll import pipeline
    tbl = comm.__dict__.get("_pipeline_pick")
    at = autotune.active()
    if at is not None:
        win = comm._coll_seq // at.window_ops()
        if tbl is None or tbl.get("__win") != win:
            agreed = at.thresholds_for(comm, win)
            if agreed is not None:
                tbl = comm.__dict__["_pipeline_pick"] = dict(agreed)
            # worlds without a shared store keep the frozen cache
    if tbl is None:
        tbl = comm.__dict__["_pipeline_pick"] = {}
    th = tbl.get(kind)
    if th is None:
        th = tbl[kind] = (
            calibrate.segmented_crossover(
                kind, comm.size, pipeline._min_bytes_var.value),
            calibrate.hier_min_bytes(
                comm.size, pipeline._hier_min_var.value),
        )
    seg_min, hier_min = th
    if kind == "allreduce":
        if nbytes >= hier_min and pipeline.hier_eligible(comm):
            return "hier"
        if nbytes >= seg_min:
            if _is_pow2(comm.size) and \
                    nbytes < pipeline._rd_max_var.value:
                return "segrd"
            return "segring"
        return None
    if kind == "bcast" and nbytes >= seg_min:
        return "segbcast"
    if kind == "alltoall" and nbytes >= seg_min:
        return "sega2a"
    return None


class TunedModule(P2PCollModule):
    name = "tuned"

    def __init__(self) -> None:
        self._rules: Dict[str, list] = {}
        path = _rules_var.value
        if path and os.path.exists(path):
            try:
                with open(path) as fh:
                    self._rules = json.load(fh)
            except (OSError, ValueError):
                self._rules = {}

    def _rule(self, coll: str, nbytes: int) -> Optional[Callable]:
        for max_bytes, name in self._rules.get(coll, []):
            if nbytes <= max_bytes:
                fn = _ALGS.get(coll, {}).get(name)
                if fn is not None:
                    return fn
        return None

    # decision functions (ref: coll_tuned_decision_fixed.c:44-86)
    def _pick_allreduce(self, comm, nbytes, op):
        fn = self._rule("allreduce", nbytes)
        if fn is not None:
            return fn
        if not op.commute:
            # only the rank-ordered fold is deterministic+correct for
            # non-commutative ops (ref decision: "else nonoverlapping")
            return alg.allreduce_linear
        if _oversubscribed(comm):
            # ranks share cores: every message is a scheduler hop and
            # nothing runs in parallel, so minimize TOTAL messages.
            # reduce+bcast moves the same total bytes as ring
            # (2(N-1)*nbytes) in 2(N-1) messages instead of 2(N-1)*N.
            return alg.allreduce_reduce_bcast
        # measured crossover (coll_tuned_use_measured_rules) replaces
        # the static 10 KB cutoff; falls back to it when rules are off
        small = calibrate.measured_threshold(
            "allreduce_small", comm.size, _small_var.value)
        if nbytes < small and _is_pow2(comm.size):
            return alg.allreduce_recursivedoubling
        if nbytes // max(1, comm.size) > 0:
            if nbytes > _seg_var.value * comm.size:
                return lambda c, s, r, o: alg.allreduce_ring(
                    c, s, r, o, segsize_bytes=_seg_var.value)
            return alg.allreduce_ring
        if _is_pow2(comm.size):
            return alg.allreduce_recursivedoubling
        return alg.allreduce_linear

    def _pick_bcast(self, comm, nbytes):
        fn = self._rule("bcast", nbytes)
        if fn is not None:
            return fn
        pipe = calibrate.measured_threshold(
            "bcast_pipeline", comm.size, 256 * 1024)
        if nbytes > pipe and comm.size > 2:
            return alg.bcast_pipeline
        return alg.bcast_binomial

    def _pick_allgather(self, comm, nbytes):
        fn = self._rule("allgather", nbytes)
        if fn is not None:
            return fn
        if nbytes <= 4096:
            return alg.allgather_bruck
        if _is_pow2(comm.size):
            return alg.allgather_recursivedoubling
        return alg.allgather_ring

    def _pick_alltoall(self, comm, nbytes):
        fn = self._rule("alltoall", nbytes)
        if fn is not None:
            return fn
        bruck = calibrate.measured_threshold(
            "alltoall_bruck", comm.size, 1024)
        if nbytes <= bruck and comm.size >= 8:
            return alg.alltoall_bruck
        return alg.alltoall_pairwise

    def _pick_reduce(self, comm, nbytes, op):
        return alg.reduce_binomial if op.commute else alg.reduce_linear

    def _pick_barrier(self, comm):
        if _oversubscribed(comm):
            return alg.barrier_binomial
        return alg.barrier_bruck


class TunedComponent(CollComponent):
    name = "tuned"
    priority = 30

    def comm_query(self, comm):
        return (self.priority, TunedModule())


coll_framework.add_component(TunedComponent())
