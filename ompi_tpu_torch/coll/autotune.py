"""Online collective autotuning: trace histograms close the loop.

``bench.py --probe-dispatch`` / ``--probe-pipeline`` calibrate the
measured-rules profile OFFLINE (coll/calibrate.py); this module is
the ONLINE half of ROADMAP open item 4: while a job runs, the
``coll_dispatch`` / ``coll_segment`` latency histograms that
``Tracer.end`` feeds anyway (DESIGN.md §9) are periodically folded
back into the calibrate profile — EWMA-updated ``seg_crossover_bytes``
and ``hier_min_bytes``, plus the fusion flush threshold
(``coll_device_fusion_max_ops``) — so ``tuned.device_algorithm``
re-selects algorithms mid-job without a probe run.  The reference
analog is coll/tuned's dynamic-rules file feeding the fixed decision
tables, except the "file" is regenerated live from the job's own
latency distribution.

The hard problem is COMM CONSISTENCY: a per-rank fold applied at an
arbitrary moment could change one member's pick mid-collective while
a peer still holds the old pick — divergent algorithms on one
collective are a deadlock (the same hazard get_profile() and
device_algorithm document).  The discipline here:

  * Folding only rewrites the PROCESS-WIDE profile (all rank-threads
    of a process see one decision surface) and purges the per-comm
    selection caches (``ft.ulfm.SELECTION_CACHE_KEYS``: the subset of
    the epoch purge that is safe on a live comm).
  * Picks are re-resolved at WINDOW boundaries of the per-comm
    collective sequence counter (``w = _coll_seq // window_ops``).
    The first member entering window ``w`` publishes a thresholds
    snapshot put-once in ``world.shared`` keyed ``(cid, w)``; every
    member of any given collective shares the same seq, hence the
    same window, hence the SAME snapshot — identical picks regardless
    of when each rank's fold ran.
  * Worlds without a shared store (multi-process jobs) skip window
    re-resolution entirely: their picks stay frozen until the normal
    epoch purge (shrink/respawn), and folds only persist the profile
    for the NEXT job.  Cross-process agreement would need a KV round
    trip per window — not worth it on the hot path (DESIGN.md §13).

Pacing rides the existing low-priority progress lane: a callback
counts dispatch/segment spans (exact even under sampling — the
tracer's per-category seen counters include the sampled-out
remainder) and triggers a fold every ``coll_autotune_interval_ops``.

The port's copy of the reference's ``ompi_tpu/coll/autotune.py``: a
window's thresholds hold, a kind, the segmented crossover and the
hierarchical tier's minimum (``hier_min_bytes``), as the reference's do.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional

from ompi_tpu_torch import trace
from ompi_tpu_torch.coll import calibrate
from ompi_tpu_torch.ft.ulfm import SELECTION_CACHE_KEYS
from ompi_tpu_torch.mca.params import registry

enable_var = registry.register(
    "coll", "autotune", "enable", False, bool,
    help="Fold the coll_dispatch/coll_segment trace histograms back "
         "into the calibrate profile while the job runs (EWMA-updated "
         "seg_crossover_bytes / hier_min_bytes / fusion flush "
         "threshold); implies a tracer even when trace_enable is off")
interval_var = registry.register(
    "coll", "autotune", "interval_ops", 256, int,
    help="Dispatch+segment spans observed (kept + sampled out) "
         "between histogram folds")
ewma_var = registry.register(
    "coll", "autotune", "ewma", 0.25, float,
    help="EWMA weight of the newest histogram window when folding "
         "latency estimates (1.0 = trust only the latest window)")
min_samples_var = registry.register(
    "coll", "autotune", "min_samples", 32, int,
    help="Minimum new dispatch samples before a fold moves the "
         "profile (smaller windows accumulate until reached)")
window_var = registry.register(
    "coll", "autotune", "window_ops", 16, int,
    help="Per-comm collective-seq window width: cached algorithm "
         "picks re-resolve against the live profile at window "
         "boundaries, through a put-once shared snapshot so every "
         "member of a collective sees identical thresholds")
persist_var = registry.register(
    "coll", "autotune", "persist", False, bool,
    help="Also write each folded profile to coll_tuned_profile_path "
         "(the next job starts from this job's observed latencies)")
fusion_var = registry.register(
    "coll", "autotune", "fusion", True, bool,
    help="Let folds retune coll_device_fusion_max_ops (batch more "
         "small ops per flush when the measured dispatch constant "
         "grows)")


_CAND_MIN = 1 << 16          # 64 KiB: crossover floor
_CAND_MAX = 64 << 20         # 64 MiB: crossover ceiling
_SPREAD_CAP = 4              # max straggler discount (log2 buckets)


def _pow2_snap(n: float) -> int:
    """Snap to the nearest power of two within the candidate clamp —
    coarse quantization absorbs run-to-run timing noise so repeated
    folds on a steady workload converge instead of dithering."""
    n = min(max(n, _CAND_MIN), _CAND_MAX)
    return 1 << round(math.log2(n))


def _bucket_center_us(b: int) -> float:
    """Geometric-ish center of log2 bucket b (bucket 0 = sub-us)."""
    if b == 0:
        return 0.5
    return 1.5 * (1 << (b - 1))


def _hist_quantile_us(hist: List[int], q: float) -> Optional[float]:
    """Latency at quantile q from a log2-bucket histogram delta."""
    total = sum(hist)
    if total <= 0:
        return None
    target = q * total
    acc = 0
    for b, n in enumerate(hist):
        acc += n
        if acc >= target:
            return _bucket_center_us(b)
    return _bucket_center_us(len(hist) - 1)


def _hist_bucket_at(hist: List[int], q: float) -> int:
    total = sum(hist)
    if total <= 0:
        return 0
    target = q * total
    acc = 0
    for b, n in enumerate(hist):
        acc += n
        if acc >= target:
            return b
    return len(hist) - 1


class Autotuner:
    """Process-wide fold engine (one per process, like the calibrate
    profile itself — per-rank tuners could diverge the shared decision
    surface).  Rank states register at mpi_init and deregister at
    finalize; folds read every registered tracer's histograms as
    deltas against the last fold."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.folds = 0            # folds that moved the profile
        self.gen = 0              # bumped per applied fold
        self.dispatch_us: Optional[float] = None   # EWMA state
        self.segment_us: Optional[float] = None
        self.fusion_ops: Optional[float] = None
        self._states: List = []
        # per-tracer histogram baselines (id(tracer) -> (disp, seg))
        self._bases: Dict[int, tuple] = {}
        # per-state span-count marker for fold pacing
        self._marks: Dict[int, int] = {}

    # -- registration ---------------------------------------------------
    def register(self, state) -> None:
        with self.lock:
            if state not in self._states:
                self._states.append(state)

    def deregister(self, state) -> None:
        with self.lock:
            if state in self._states:
                self._states.remove(state)
            tr = getattr(state, "tracer", None)
            if tr is not None:
                self._bases.pop(id(tr), None)
            self._marks.pop(id(state), None)

    # -- pacing ---------------------------------------------------------
    def poll(self, state) -> int:
        """Low-priority progress callback body: trigger a fold once
        this rank has observed interval_ops new dispatch/segment
        spans.  Exact under sampling — cat_seen counts the sampled-out
        remainder too."""
        tr = getattr(state, "tracer", None)
        if tr is None:
            return 0
        seen = tr.cat_seen("coll_dispatch") + tr.cat_seen("coll_segment")
        mark = self._marks.get(id(state), 0)
        if seen - mark < max(1, interval_var.value):
            return 0
        self._marks[id(state)] = seen
        self.fold()
        return 0

    # -- folding --------------------------------------------------------
    def _hist_deltas(self):
        """Sum dispatch/segment histogram deltas across every
        registered tracer since the last fold.  Baselines are NOT
        advanced here — the caller commits the returned snapshot only
        when it actually folds, so under-threshold windows keep
        accumulating."""
        disp = [0] * trace.N_BUCKETS
        seg = [0] * trace.N_BUCKETS
        snap: Dict[int, tuple] = {}
        for st in self._states:
            tr = getattr(st, "tracer", None)
            if tr is None:
                continue
            d_now = list(tr.hists[trace.HIST_COLL_DISPATCH])
            s_now = list(tr.hists[trace.HIST_COLL_SEGMENT])
            d_base, s_base = self._bases.get(
                id(tr), ([0] * trace.N_BUCKETS, [0] * trace.N_BUCKETS))
            for b in range(trace.N_BUCKETS):
                disp[b] += d_now[b] - d_base[b]
                seg[b] += s_now[b] - s_base[b]
            snap[id(tr)] = (d_now, s_now)
        return disp, seg, snap

    def fold(self) -> bool:
        """One fold: histogram deltas -> EWMA latency estimates ->
        profile thresholds (+ optional fusion knob), then purge the
        live selection caches so window re-resolution sees the move.
        Returns True when the profile moved."""
        with self.lock:
            disp_hist, seg_hist, snap = self._hist_deltas()
            n_disp = sum(disp_hist)
            if n_disp < max(1, min_samples_var.value):
                return False  # baselines untouched: keep accumulating
            self._bases.update(snap)
            disp_med = _hist_quantile_us(disp_hist, 0.5)
            seg_med = _hist_quantile_us(seg_hist, 0.5)
            a = min(1.0, max(0.01, ewma_var.value))
            self.dispatch_us = disp_med if self.dispatch_us is None \
                else a * disp_med + (1 - a) * self.dispatch_us
            if seg_med is not None:
                self.segment_us = seg_med if self.segment_us is None \
                    else a * seg_med + (1 - a) * self.segment_us
            prof = calibrate.get_profile(create=True) or {}
            seg_bytes = int(prof.get("seg_bytes") or (1 << 20))
            # crossover candidate: the segmented tier starts winning
            # once ~two segments' worth of pipelined transfers hide
            # one whole-op dispatch; a dispatch constant that measures
            # LARGER than the per-segment latency pulls the crossover
            # DOWN (segment earlier), and vice versa
            seg_us = self.segment_us or self.dispatch_us
            ratio = seg_us / max(self.dispatch_us, 1e-3)
            cand = _pow2_snap(2.0 * seg_bytes * ratio)
            # hierarchical tier: a wide dispatch distribution (p90 far
            # above p50) is the straggler signature hier absorbs, so
            # spread discounts its minimum payload
            spread = _hist_bucket_at(disp_hist, 0.9) \
                - _hist_bucket_at(disp_hist, 0.5)
            hier_cand = _pow2_snap(
                cand >> min(max(spread, 0), _SPREAD_CAP))
            old_cx = dict(prof.get("seg_crossover_bytes") or {})
            new_cx = {}
            for kind in ("allreduce", "bcast", "alltoall"):
                old = old_cx.get(kind)
                new_cx[kind] = _pow2_snap(
                    a * cand + (1 - a) * old) if old else cand
            old_hier = prof.get("hier_min_bytes")
            new_hier = _pow2_snap(
                a * hier_cand + (1 - a) * old_hier) if old_hier \
                else hier_cand
            calibrate.update_profile(
                {"seg_crossover_bytes": new_cx,
                 "hier_min_bytes": new_hier,
                 "autotune": {"folds": self.folds + 1,
                              "dispatch_us": round(self.dispatch_us, 2),
                              "segment_us": round(seg_us, 2),
                              "samples": n_disp}},
                persist=bool(persist_var.value))
            if fusion_var.value:
                self._retune_fusion(prof, a)
            self.folds += 1
            self.gen += 1
            states = list(self._states)
        # purge OUTSIDE the tuner lock (comm dicts have no ordering
        # with it); safe on live comms because re-resolution is
        # window-gated through the shared snapshot below
        for st in states:
            if not self._world_shared(st):
                continue  # frozen picks until epoch purge (see above)
            for comm in list(getattr(st, "comms", {}).values()):
                for k in SELECTION_CACHE_KEYS:
                    comm.__dict__.pop(k, None)
        return True

    def _retune_fusion(self, prof: Dict, a: float) -> None:
        """Batch more small ops per fused flush when the measured
        dispatch constant dwarfs the host per-message constant (each
        extra batched op amortizes one dispatch), fewer when dispatch
        is cheap and batching only adds pack latency."""
        alpha = float(prof.get("host_alpha_us") or 1.0)
        cand = self.dispatch_us / max(alpha, 0.1)
        self.fusion_ops = cand if self.fusion_ops is None \
            else a * cand + (1 - a) * self.fusion_ops
        ops = int(min(max(round(self.fusion_ops), 4), 256))
        registry.set("coll_device_fusion_max_ops", str(ops))

    # -- window-agreed selection snapshots ------------------------------
    @staticmethod
    def _world_shared(state):
        world = getattr(state.rte, "world", None)
        if world is not None and hasattr(world, "shared"):
            return world
        return None

    def window_ops(self) -> int:
        return max(1, window_var.value)

    def thresholds_for(self, comm, win: int) -> Optional[Dict]:
        """The pick-threshold table every member of window ``win``
        must share, put-once published under the world's shared lock.
        None when the world has no shared store (the caller keeps its
        frozen per-comm cache)."""
        world = self._world_shared(comm.state)
        if world is None:
            return None
        key = ("autotune_th", comm.cid, win)
        with world.shared_lock:
            tbl = world.shared.get(key)
            if tbl is None:
                tbl = self._compute_thresholds(comm, win)
                world.shared[key] = tbl
                for k in [k for k in world.shared
                          if isinstance(k, tuple) and len(k) == 3
                          and k[0] == "autotune_th" and k[1] == comm.cid
                          and k[2] < win]:
                    del world.shared[k]
        return tbl

    @staticmethod
    def _compute_thresholds(comm, win: int) -> Dict:
        from ompi_tpu_torch.coll import pipeline
        tbl: Dict = {"__win": win}
        for kind in ("allreduce", "bcast", "alltoall"):
            tbl[kind] = (
                calibrate.segmented_crossover(
                    kind, comm.size, pipeline._min_bytes_var.value),
                calibrate.hier_min_bytes(
                    comm.size, pipeline._hier_min_var.value),
            )
        return tbl


_tuner: Optional[Autotuner] = None
_tuner_lock = threading.Lock()


def active() -> Optional[Autotuner]:
    """The process autotuner, or None when coll_autotune_enable is
    off / no rank has attached — the one check device_algorithm pays."""
    return _tuner


def attach(state):
    """Called by mpi_init right after trace.attach: when enabled,
    guarantee a tracer (the fold has nothing to read otherwise),
    register the rank with the process tuner, and hook fold pacing
    into the low-priority progress lane."""
    global _tuner
    if not enable_var.value:
        state.autotune = None
        return None
    if getattr(state, "tracer", None) is None:
        trace.force_attach(state)
    with _tuner_lock:
        if _tuner is None:
            _tuner = Autotuner()
        tuner = _tuner
    tuner.register(state)
    state.autotune = tuner
    state.progress.register(lambda: tuner.poll(state),
                            low_priority=True)
    return tuner


def detach(state) -> None:
    """Finalize-time deregistration (the state's progress engine stops
    being swept with the world; the tuner must just stop reading its
    tracer)."""
    tuner = getattr(state, "autotune", None)
    if tuner is not None:
        tuner.deregister(state)
        state.autotune = None


def reset() -> None:
    """Testing hook: drop the process tuner (fresh EWMA state)."""
    global _tuner
    with _tuner_lock:
        _tuner = None


# -- pvars ------------------------------------------------------------------

def _tuner_attr(attr: str, scale: Optional[float] = None):
    def getter():
        t = _tuner
        if t is None:
            return 0
        v = getattr(t, attr)
        if v is None:
            return 0
        return round(v, 2) if scale is None else int(v * scale)
    return getter


registry.register_pvar(
    "coll", "autotune", "folds",
    help="Histogram folds applied to the calibrate profile",
    getter=_tuner_attr("folds"))
registry.register_pvar(
    "coll", "autotune", "gen",
    help="Autotune generation (bumps once per applied fold)",
    getter=_tuner_attr("gen"))
registry.register_pvar(
    "coll", "autotune", "dispatch_ewma_us",
    help="EWMA of the median coll_dispatch latency (us) across folds",
    getter=_tuner_attr("dispatch_us"))
registry.register_pvar(
    "coll", "autotune", "segment_ewma_us",
    help="EWMA of the median coll_segment latency (us) across folds",
    getter=_tuner_attr("segment_us"))
registry.register_pvar(
    "coll", "autotune", "seg_crossover_allreduce",
    help="Current allreduce segmented-pipeline crossover (bytes) in "
         "the live profile",
    getter=lambda: int(((calibrate.get_profile(create=False) or {})
                        .get("seg_crossover_bytes") or {})
                       .get("allreduce") or 0))
