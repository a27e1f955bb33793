"""Cross-rank span tracing: the observability spine.

The port's copy of the reference's ``ompi_tpu/trace`` (it imports
nothing of it: the pvars register on the port's registry and
``current_tracer`` reads the port's rank state).  Traces are host
timestamps (``perf_counter_ns``); device time is the kernels' own
measurement (CUDA events), never a span.  The one divergence is the
compile span: the port has no XLA compile, so the first-use build and
load of a kernel library (``kernels/build.load``) records
``kernel_load`` (arg ``key``: the source's name) under ``CAT_COMPILE``
where the reference records ``xla_compile``.

One per-rank, lock-light ring-buffer tracer records *spans* (complete
operations with a wall-clock start and a perf-counter duration) and
*instants* (point annotations: fault injections, heartbeats) from the
layers that matter — pml send/recv activate→complete, collective
entry→rendezvous→dispatch (including the fused device path's
pack/compile/execute phases), progress-loop tick latency, OOB
heartbeat/reconnect.  ``ompi_tpu_torch/tools/traceview.py`` merges per-rank
dumps, applies mpisync clock offsets, and emits Chrome trace-event
JSON.

The cost contract mirrors ``peruse``: when ``trace_enable`` is off
(the default) every instrumented hot path pays exactly one
attribute-is-None check — no payload is ever built, no timestamp is
ever taken (guarded by ``tests/test_trace.py`` the same way
``test_peruse_disabled_costs_nothing`` guards the peruse flag).  When
on, the recording hot path ALLOCATES NOTHING: the ring is a set of
preallocated parallel typed-array columns (``array('q')`` nanosecond
timestamps/durations/args, ``array('i')`` interned name/category ids)
indexed by one cursor, timestamps are single ``perf_counter_ns``
integer reads against a wall-clock anchor captured once at tracer
creation, and strings only exist in the module-level intern tables —
decoding back to span dicts happens at snapshot/dump time, off the
hot path.  ``ompi_tpu_torch/tools/hotpath_audit.py`` lints the hot
functions so tuple/dict builds and ``time.time`` calls cannot
silently return.

On a GIL-bound box every nanosecond on the hot path is multiplied by
the rank count, so recording is additionally *sampled per category*:
``Tracer.start_sampled`` keeps 1-in-N spans (N starts at 1, doubles
each time a category banks ``trace_sample_auto`` kept events, capped
at ``trace_sample_max``) and the skip path is a counter decrement —
no clock read, no ring write.  The unsampled remainder is counted
EXACTLY per category (``trace_dropped_<cat>`` pvars, ``sampling`` /
``dropped_by_cat`` dump sections), so sampled traces stay honest:
``recorded == kept + sampled_out`` always holds.

Correlation keys stitch ranks together in the merger:

  * p2p spans carry ``mid`` = ``cid:src:tag:seq`` — identical on the
    sender's and the matching receiver's span (the ob1 match id).
    The components are stored as four integer columns; the string is
    synthesized at snapshot time.
  * collective spans carry ``cid`` + a per-comm ``seq`` drawn from one
    shared counter (``coll_seq``), so rank 0's allreduce #7 lines up
    with rank 3's allreduce #7.

Under sampling each rank keeps its own 1-in-N subset, so cross-rank
correlation is complete only while every category still runs at
period 1 (small traces never adapt: the default ``trace_sample_auto``
threshold is far above what a test emits).

On top of the same ring, fixed log2-bucket latency histograms
(progress tick, collective dispatch, p2p completion, per-segment
rendezvous) are maintained per rank and exposed as MPI_T pvars —
``bench.py --trace-overhead`` snapshots them into BENCH_DETAIL.json,
and ``ompi_tpu_torch/coll/autotune.py`` folds them back into the calibrate
profile online.  Histograms count KEPT spans only, so histogram
totals always equal ring span counts per category.

The collective/nbc hooks here (``coll_begin``/``coll_end``,
``nbc_begin``/``nbc_end``) also fire the extended PERUSE events, so
the two observability systems share one set of instrumentation
points rather than drifting apart.
"""

from __future__ import annotations

import json
import os
import threading
import time
from array import array
from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch import peruse
from ompi_tpu_torch.mca.params import registry

enable_var = registry.register(
    "trace", "", "enable", False, bool,
    help="Record per-rank span traces (ring buffer) and latency "
         "histograms; off = a single attribute check on hot paths")
buffer_var = registry.register(
    "trace", "", "buffer_events", 8192, int,
    help="Ring-buffer capacity in events per rank; when full the "
         "oldest event is overwritten and the dropped counter grows")
dump_var = registry.register(
    "trace", "", "dump_path", "", str,
    help="Per-rank trace dump destination at MPI_Finalize: a "
         "directory, a prefix, or a template containing %r (replaced "
         "by the rank).  Empty = no dump")
sample_spec_var = registry.register(
    "trace", "", "sample_spec", "", str,
    help="Initial per-category sampling periods as 'cat:N,cat:N' "
         "(e.g. 'p2p:8,coll:4'); unlisted categories start at 1 "
         "(keep everything).  Skipped spans are counted exactly")
sample_auto_var = registry.register(
    "trace", "", "sample_auto", 1024, int,
    help="Adaptive sampling: double a category's period each time it "
         "SEES this many more events, kept or skipped (busy "
         "categories back off geometrically to trace_sample_max "
         "within a few thousand ops; quiet ones never leave full "
         "fidelity).  0 disables adaptation")
sample_max_var = registry.register(
    "trace", "", "sample_max", 64, int,
    help="Ceiling for adaptive per-category sampling periods "
         "(keep at least 1-in-N)")
phase_enable_var = registry.register(
    "trace", "phase", "enable", False, bool,
    help="Record sub-op PHASE spans inside traced collectives "
         "(rendezvous wait, host pack, dispatch, device execute, "
         "unpack) for tools/critpath.py dispatch-tax attribution.  "
         "Needs trace_enable; off = one extra attribute check per "
         "traced op.  Device-execute spans fence with "
         "block_until_ready on SAMPLED ops only")
phase_sample_var = registry.register(
    "trace", "phase", "sample", 1, int,
    help="Initial 1-in-N sampling period of the 'phase' category "
         "(1 = record every phase of every op — what critpath wants; "
         "adaptive sampling still backs busy runs off toward "
         "trace_sample_max, keeping steady-state cost inside the "
         "trace budget)")
sync_rounds_var = registry.register(
    "trace", "sync", "rounds", 8, int,
    help="Ping-pong rounds of the finalize-time mpisync measurement "
         "auto-embedded into trace dumps (multi-rank worlds with "
         "trace_dump_path set); 0 disables — traceview/critpath then "
         "need the hand-plumbed --sync file again")

# Fixed log2 latency buckets in microseconds: bucket i holds durations
# in [2^(i-1), 2^i) us (bucket 0 = sub-microsecond), plus one overflow
# bucket.  Fixed bounds keep cross-rank and cross-run histograms
# directly comparable — no adaptive resizing to explain away.
N_BUCKETS = 21  # 0..2^19 us (~0.5 s) + overflow
BUCKET_BOUNDS_US = tuple(1 << i for i in range(N_BUCKETS - 1))

HIST_PROGRESS_TICK = 0
HIST_COLL_DISPATCH = 1
HIST_P2P_COMPLETE = 2
HIST_COLL_SEGMENT = 3  # per-segment rendezvous latency (pipeline tier)
HIST_SERVE_ATTACH = 4  # DVM session-attach latency (tools/dvm)
HIST_RDV_WAIT = 5      # rendezvous-wait phase (straggler-skew gauge)
HIST_NAMES = ("progress_tick", "coll_dispatch", "p2p_complete",
              "coll_segment", "serve_attach", "rdv_wait")


def bucket_upper_us(b: int) -> float:
    """Upper bound in microseconds of log2 bucket ``b`` under
    hist_add's bit_length bucketing (bucket b holds [2^(b-1), 2^b)
    us; the overflow bucket reports its lower bound doubled).  The
    telemetry plane (ompi_tpu_torch/obs) derives p50/p90/p99 gauges from
    the histograms, so the bucket→value mapping lives here with the
    bucketing itself rather than drifting in a consumer."""
    return float(1 << b)


# -- intern tables ----------------------------------------------------------
# Category and span-name strings live HERE, once per process; the ring
# stores small integer ids.  The tables are append-only (ids never
# move), so lock-free reads on the hot path are safe; interning itself
# is cold and takes the lock.

_intern_lock = threading.Lock()
_names: List[str] = []
_name_ids: Dict[str, int] = {}
_name_fields: List[Tuple[str, ...]] = []   # arg-column schema per name
_cats: List[str] = []
_cat_ids: Dict[str, int] = {}
_cat_hist: List[int] = []                  # hist index or -1 per cat


def intern_name(name: str, fields: Tuple[str, ...] = ()) -> int:
    """Id for a span name, registering its arg-column schema on first
    sight (columns a0..a4 decode to dict keys at snapshot time; a
    field spelled 'key$' decodes its column as an interned-name id).
    Re-interning keeps the first schema."""
    nid = _name_ids.get(name)
    if nid is not None:
        return nid
    with _intern_lock:
        nid = _name_ids.get(name)
        if nid is None:
            nid = len(_names)
            _names.append(name)
            _name_fields.append(tuple(fields))
            _name_ids[name] = nid
    return nid


def intern_cat(cat: str, hist: int = -1) -> int:
    """Id for a span category, optionally bound to the latency
    histogram Tracer.end feeds for it."""
    cid = _cat_ids.get(cat)
    if cid is not None:
        return cid
    with _intern_lock:
        cid = _cat_ids.get(cat)
        if cid is None:
            cid = len(_cats)
            _cats.append(cat)
            _cat_hist.append(hist)
            _cat_ids[cat] = cid
    return cid


# The hot categories and names, interned at import so ids are module
# constants every call site can close over.
CAT_P2P = intern_cat("p2p", HIST_P2P_COMPLETE)
CAT_COLL = intern_cat("coll")
CAT_NBC = intern_cat("nbc")
CAT_COLL_DISPATCH = intern_cat("coll_dispatch", HIST_COLL_DISPATCH)
CAT_COLL_SEGMENT = intern_cat("coll_segment", HIST_COLL_SEGMENT)
CAT_COMPILE = intern_cat("compile")
CAT_FT = intern_cat("ft")
CAT_OOB = intern_cat("oob")
CAT_FAULT = intern_cat("fault")
CAT_SERVE = intern_cat("serve", HIST_SERVE_ATTACH)
# sub-op phase spans (critpath dispatch-tax attribution): NOT bound to
# a histogram — only the rendezvous-wait phase feeds HIST_RDV_WAIT,
# via an explicit hist_add at its call sites
CAT_PHASE = intern_cat("phase")
# one-sided ops (osc put/get/accumulate) — both the host AM component
# and the device ppermute component stamp the same category
CAT_RMA = intern_cat("rma")

# categories whose spans are sampled / drop-accounted (pvar surface)
SPAN_CATS = ("p2p", "coll", "nbc", "coll_dispatch", "coll_segment",
             "compile", "phase", "rma")

NAME_SEND = intern_name("send", ("cid", "src", "tag", "seq", "bytes"))
NAME_RECV = intern_name("recv", ("cid", "src", "tag", "seq", "bytes"))
NAME_NBC = intern_name("nbc", ("cid", "seq"))
NAME_MEET = intern_name("meet", ("cid", "seq", "nbytes"))
NAME_SEG_MEET = intern_name("seg_meet", ("cid", "seq", "nbytes"))
# one span per compiled-plan collective (DESIGN.md §22): pack, the
# single rendezvous and unpack all inside it.  Categorized under
# coll_segment so HIST_COLL_SEGMENT keeps a latency pulse when the
# plan path replaces per-segment meets
NAME_PLAN_EXEC = intern_name("plan_exec", ("cid", "nbytes", "alg$"))
NAME_FUSED_FLUSH = intern_name("fused_flush", ("cid", "ops"))
NAME_FUSED_PACK = intern_name("fused_pack", ("cid", "groups", "slots"))
NAME_XLA_COMPILE = intern_name("xla_compile", ("key$",))
NAME_RMA_PUT = intern_name("rma_put", ("cid", "target", "nbytes"))
NAME_RMA_GET = intern_name("rma_get", ("cid", "target", "nbytes"))
NAME_RMA_ACC = intern_name("rma_acc", ("cid", "target", "nbytes"))

# phase-span names share one arg schema: the op correlation keys.
# (cid, seq) line phases up with their enclosing meet/seg_meet span;
# critpath additionally attributes by time containment, so sites that
# cannot know the final seq (pack/unpack of a pipelined segment) pass
# their best approximation or 0.
NAME_PH_RDV = intern_name("ph_rdv_wait", ("cid", "seq", "nbytes"))
NAME_PH_PACK = intern_name("ph_pack", ("cid", "seq", "nbytes"))
NAME_PH_DISPATCH = intern_name("ph_dispatch", ("cid", "seq", "nbytes"))
NAME_PH_EXECUTE = intern_name("ph_execute", ("cid", "seq", "nbytes"))
NAME_PH_UNPACK = intern_name("ph_unpack", ("cid", "seq", "nbytes"))

# the port's compile span (after the reference's names, so the shared
# names keep the reference's ids): a kernel library's first-use build
# and load, where the reference records xla_compile
NAME_KERNEL_LOAD = intern_name("kernel_load", ("key$",))

#: span name -> human phase label (tools/critpath.py keeps its own
#: copy so it stays runnable against dump files alone)
PHASE_LABELS = {
    "ph_rdv_wait": "rendezvous",
    "ph_pack": "pack",
    "fused_pack": "pack",
    "ph_dispatch": "dispatch",
    "ph_execute": "execute",
    "ph_unpack": "unpack",
    "xla_compile": "compile",
    "kernel_load": "compile",
}

_NO_ADAPT = 1 << 62  # _nxt sentinel when adaptation is disabled

# per-job request-tag marks kept per tracer (DESIGN.md §23): one mark
# per run start/end, so even a 256-deep ring covers hours of serving
REQ_MARKS = 256


def _parse_sample_spec(spec: str) -> Dict[int, int]:
    """'p2p:8,coll:4' -> {cat_id: period}; malformed entries ignored
    (diagnostics never take a rank down)."""
    out: Dict[int, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        cat, _, per = part.partition(":")
        try:
            p = int(per)
        except ValueError:
            continue
        if p >= 1:
            out[intern_cat(cat.strip())] = p
    return out


class Tracer:
    """One rank's ring buffer + histograms.

    The ring is a fixed set of parallel typed-array columns
    (preallocated at construction) indexed by ``cursor % capacity``:
    nanosecond start/duration (``'q'``), interned name/cat ids
    (``'i'``), phase code (``'b'``: 0=span, 1=instant), and five
    generic ``'q'`` arg columns whose meaning comes from the name's
    interned field schema.  Recording a span is pure column stores +
    counter bumps — no object leaves the nursery, no lock is taken;
    on the 1-core bench box every GIL-held nanosecond here is
    multiplied by the rank count, and the --trace-overhead budget is
    single-digit percent.  Overwrite accounting is exact: the slot
    being reused charges its old category's overwritten counter.

    Wall-clock anchoring: ``time.time`` is read ONCE at construction
    next to one ``perf_counter_ns`` read; every stored timestamp is a
    raw ``perf_counter_ns`` and converts to epoch seconds affinely at
    snapshot time — one clock read per span, and mpisync offset
    correction in traceview still yields monotonic merged timelines
    because within a rank all timestamps share one monotonic clock.

    Cold paths (``instant``, ``end_slow``) may carry real dicts in a
    parallel object column; the hot path stores None there.

    A rank's tracer is written almost exclusively by its own thread;
    the GIL makes the column stores safe for the rare cross-thread
    completion path and the process-global daemon tracer (worst case
    under a true race is an off-by-a-few counter, never a torn
    event)."""

    __slots__ = (
        "rank", "capacity", "cursor", "hists",
        "anchor_wall", "anchor_ns",
        "_ts", "_dur", "_name", "_cat", "_ph",
        "_a0", "_a1", "_a2", "_a3", "_a4", "_argobj",
        "_nrec", "_period", "_ctr", "_skipped", "_cnt", "_nxt",
        "_over", "_auto", "_max_period",
        "phase", "sync_offsets_us",
        "_req_tags", "_req_ts", "_req_n",
    )

    def __init__(self, rank: int, capacity: int = 8192) -> None:
        self.rank = rank
        cap = self.capacity = max(1, int(capacity))
        self.cursor = 0
        self.hists = [[0] * N_BUCKETS for _ in HIST_NAMES]
        self.anchor_wall = time.time()
        self.anchor_ns = time.perf_counter_ns()
        zq = array("q", [0]) * cap
        self._ts = array("q", zq)
        self._dur = array("q", zq)
        self._a0 = array("q", zq)
        self._a1 = array("q", zq)
        self._a2 = array("q", zq)
        self._a3 = array("q", zq)
        self._a4 = array("q", zq)
        self._name = array("i", [0]) * cap
        self._cat = array("i", [0]) * cap
        self._ph = array("b", [0]) * cap
        self._argobj: List[Any] = [None] * cap
        self._nrec = 0          # events stored in the ring (kept)
        ncat = len(_cats)
        self._period = [1] * ncat    # current 1-in-N period per cat
        self._ctr = [0] * ncat       # skips remaining in this period
        self._skipped = [0] * ncat   # exact sampled-out count per cat
        self._cnt = [0] * ncat       # exact kept count per cat
        self._over = [0] * ncat      # exact overwrite count per cat
        self._auto = max(0, int(sample_auto_var.value))
        self._max_period = max(1, int(sample_max_var.value))
        nxt = self._auto if self._auto else _NO_ADAPT
        self._nxt = [nxt] * ncat     # seen-count at next period double
        # phase spans: single-attribute gate for every instrumented
        # site (the zero-cost-when-off contract), initial period from
        # its own knob (trace_sample_spec 'phase:N' still overrides)
        self.phase = bool(phase_enable_var.value)
        self._period[CAT_PHASE] = max(1, int(phase_sample_var.value))
        # mpisync offsets measured at finalize (sync_state) ride the
        # dump so traceview/critpath need no hand-plumbed --sync file
        self.sync_offsets_us: Optional[List[float]] = None
        # request-tag mark ring (DESIGN.md §23): a run stamps its
        # 63-bit trace id on entry and 0 on exit; spans between two
        # marks belong to that request.  Preallocated so req_mark
        # stays two column stores
        self._req_tags = array("q", [0]) * REQ_MARKS
        self._req_ts = array("q", [0]) * REQ_MARKS
        self._req_n = 0
        for cid, per in _parse_sample_spec(sample_spec_var.value).items():
            self._ensure_cat(cid)
            self._period[cid] = min(per, self._max_period)

    def _ensure_cat(self, cat_id: int) -> None:
        """Grow the per-category tables to cover a cat interned after
        this tracer was built (cold: instants / end_slow only — hot
        call sites use the module-constant ids interned at import)."""
        grow = cat_id + 1 - len(self._period)
        if grow > 0:
            nxt = self._auto if self._auto else _NO_ADAPT
            self._period.extend([1] * grow)
            self._ctr.extend([0] * grow)
            self._skipped.extend([0] * grow)
            self._cnt.extend([0] * grow)
            self._over.extend([0] * grow)
            self._nxt.extend([nxt] * grow)

    @property
    def recorded(self) -> int:
        """Total events seen (kept + sampled-out); instants and spans."""
        return self._nrec + sum(self._skipped)

    @property
    def dropped(self) -> int:
        """Events not in the ring: sampled-out + lost to wraparound."""
        live = self.cursor if self.cursor < self.capacity else self.capacity
        return self.recorded - live

    # -- recording -------------------------------------------------------
    # The default-arg binding (_pcns) skips the module+attribute
    # lookup per call on the hot path.
    def start(self, _pcns=time.perf_counter_ns) -> int:
        """Unconditional span-start token: one integer nanosecond
        perf-counter read (always truthy — perf_counter_ns is
        monotonic from a nonzero epoch)."""
        return _pcns()

    def start_sampled(self, cat_id: int, _pcns=time.perf_counter_ns) -> int:
        """Sampling span-start: 1-in-period spans get a start token,
        the rest return 0 after a counter decrement — the skip path
        takes NO clock read and writes NO ring slot, which is what
        makes always-on tracing affordable under the GIL.  Callers
        skip their end() call (and any arg gathering) on 0.

        Adaptation lives in the KEEP branch (so the skip branch stays
        two list ops) and is driven by the category's total SEEN count
        (kept + skipped): every ``trace_sample_auto`` more sightings,
        the period doubles up to ``trace_sample_max``.  A hot category
        therefore backs off geometrically within ~6 x auto events,
        checked at worst one kept-event late — the exact counters make
        any sampling error visible, never silent."""
        c = self._ctr[cat_id]
        if c:
            self._ctr[cat_id] = c - 1
            self._skipped[cat_id] += 1
            return 0
        p = self._period[cat_id]
        seen = self._cnt[cat_id] + self._skipped[cat_id]
        if seen >= self._nxt[cat_id]:
            self._nxt[cat_id] = seen + self._auto
            if p < self._max_period:
                p += p
                self._period[cat_id] = p
        self._ctr[cat_id] = p - 1
        return _pcns()

    def gate_sampled(self, cat_id: int) -> bool:
        """Sampling decision WITHOUT a clock read: start_sampled's
        1-in-period keep/skip logic for call sites that gate a whole
        STRUCTURE of spans — the §18 per-op phase ctx — rather than
        one span.  A skipped sighting is a counter decrement counted
        sampled-out (the category's exact counters still see every
        op); a kept one runs the same geometric adaptation and
        reloads the counter.  The sub-spans of a kept structure then
        record unconditionally (``start()``/``end()``), so one op's
        decomposition is always coherent — never a dispatch span
        whose execute sampled out."""
        c = self._ctr[cat_id]
        if c:
            self._ctr[cat_id] = c - 1
            self._skipped[cat_id] += 1
            return False
        p = self._period[cat_id]
        seen = self._cnt[cat_id] + self._skipped[cat_id]
        if seen >= self._nxt[cat_id]:
            self._nxt[cat_id] = seen + self._auto
            if p < self._max_period:
                p += p
                self._period[cat_id] = p
        self._ctr[cat_id] = p - 1
        return True

    def end(self, t0: int, name_id: int, cat_id: int,
            a0: int = 0, a1: int = 0, a2: int = 0, a3: int = 0,
            a4: int = 0, _pcns=time.perf_counter_ns,
            _hist=_cat_hist) -> int:
        """Close a span opened with start()/start_sampled(); returns
        the duration in ns.  Categories bound to a histogram feed it
        here (kept spans only — histogram totals equal ring span
        counts).  This is THE recording hot path: column stores and
        integer bumps, zero allocation."""
        dur = _pcns() - t0
        h = _hist[cat_id]
        if h >= 0:
            b = (dur // 1000).bit_length()
            self.hists[h][b if b < N_BUCKETS else N_BUCKETS - 1] += 1
        cur = self.cursor
        cap = self.capacity
        i = cur % cap
        if cur >= cap:
            self._over[self._cat[i]] += 1
        self._ts[i] = t0
        self._dur[i] = dur
        self._name[i] = name_id
        self._cat[i] = cat_id
        self._ph[i] = 0
        self._a0[i] = a0
        self._a1[i] = a1
        self._a2[i] = a2
        self._a3[i] = a3
        self._a4[i] = a4
        self._argobj[i] = None
        self.cursor = cur + 1
        self._nrec += 1
        self._cnt[cat_id] += 1
        return dur

    def _store_slot(self, ts: int, dur: int, name_id: int, cat_id: int,
                    ph: int, argobj: Optional[dict]) -> None:
        """Cold-path slot store (instants, end_slow)."""
        cur = self.cursor
        i = cur % self.capacity
        if cur >= self.capacity:
            self._over[self._cat[i]] += 1
        self._ts[i] = ts
        self._dur[i] = dur
        self._name[i] = name_id
        self._cat[i] = cat_id
        self._ph[i] = ph
        self._argobj[i] = argobj
        self.cursor = cur + 1
        self._nrec += 1

    def end_slow(self, t0: int, name: str, cat: str, **args) -> float:
        """String-keyed compat span close for COLD call sites (daemon
        OOB reconnects, tests): interns on the fly, carries args as a
        real dict, still feeds the category's histogram.  Returns the
        duration in seconds (legacy contract)."""
        dur = time.perf_counter_ns() - t0
        cid = intern_cat(cat)
        self._ensure_cat(cid)
        h = _cat_hist[cid]
        if h >= 0:
            b = (dur // 1000).bit_length()
            self.hists[h][b if b < N_BUCKETS else N_BUCKETS - 1] += 1
        self._store_slot(t0, dur, intern_name(name), cid, 0,
                         dict(args) if args else None)
        self._cnt[cid] += 1
        return dur * 1e-9

    def instant(self, name: str, cat: str, **args) -> None:
        """Point annotation (cold path: faults, heartbeats, ULFM)."""
        cid = intern_cat(cat)
        self._ensure_cat(cid)
        self._store_slot(time.perf_counter_ns(), 0, intern_name(name),
                         cid, 1, dict(args) if args else None)

    def tick_ns(self, dur_ns: int) -> None:
        """Progress-sweep latency: histogram only, never a ring event
        (a sweep runs thousands of times per second and would flood
        the ring into pure tick noise)."""
        b = (dur_ns // 1000).bit_length()
        self.hists[HIST_PROGRESS_TICK][
            b if b < N_BUCKETS else N_BUCKETS - 1] += 1

    def tick(self, dur_s: float) -> None:
        self.tick_ns(int(dur_s * 1e9))

    def req_mark(self, tag: int, _pcns=time.perf_counter_ns) -> None:
        """Stamp the per-job request tag (DESIGN.md §23): the serving
        plane calls this once at run entry (tag = the run's 63-bit
        trace id) and once at exit (tag 0), so every span recorded in
        between is attributable to that request at dump time.  Hot
        contract (hotpath_audit): two preallocated column stores, one
        perf-counter read, integer bookkeeping — the same cost class
        as a ScopedPvar add."""
        i = self._req_n % REQ_MARKS
        self._req_tags[i] = tag
        self._req_ts[i] = _pcns()
        self._req_n += 1

    def req_windows(self) -> List[dict]:
        """The live request marks oldest-first as {tag, ts} dicts
        (epoch-second timestamps, the dump event convention): window
        k covers [mark[k].ts, mark[k+1].ts).  Cold path."""
        out = []
        n = self._req_n
        start = max(0, n - REQ_MARKS)
        for k in range(start, n):
            i = k % REQ_MARKS
            out.append({"tag": self._req_tags[i],
                        "ts": self._wall(self._req_ts[i])})
        return out

    def hist_add(self, which: int, dur_s: float) -> None:
        us = int(dur_s * 1e6)
        # log2 bucket: us in [2^(i-1), 2^i) -> bucket i; 0 us -> 0
        b = us.bit_length()
        if b >= N_BUCKETS:
            b = N_BUCKETS - 1
        self.hists[which][b] += 1

    # -- sampling accounting --------------------------------------------
    def sampling_rates(self) -> Dict[str, int]:
        """Current 1-in-N period per span category."""
        return {cat: self._period[cid]
                for cat, cid in ((c, _cat_ids[c]) for c in SPAN_CATS)
                if cid < len(self._period)}

    def dropped_by_cat(self) -> Dict[str, int]:
        """Exact per-category loss: sampled-out + overwritten."""
        out = {}
        for cat in SPAN_CATS:
            cid = _cat_ids[cat]
            if cid < len(self._skipped):
                out[cat] = self._skipped[cid] + self._over[cid]
        return out

    def cat_seen(self, cat: str) -> int:
        """Exact total spans observed for a category (kept + sampled
        out) — what the autotuner paces its fold interval on."""
        cid = _cat_ids.get(cat)
        if cid is None or cid >= len(self._cnt):
            return 0
        return self._cnt[cid] + self._skipped[cid]

    # -- reading ---------------------------------------------------------
    def _wall(self, ts_ns: int) -> float:
        return self.anchor_wall + (ts_ns - self.anchor_ns) * 1e-9

    def _live_range(self):
        cur, cap = self.cursor, self.capacity
        if cur <= cap:
            return range(cur)
        first = cur % cap
        return (i % cap for i in range(first, first + cap))

    def _decode_args(self, i: int) -> dict:
        argobj = self._argobj[i]
        if argobj is not None:
            return argobj
        nid = self._name[i]
        cid = self._cat[i]
        vals = (self._a0[i], self._a1[i], self._a2[i], self._a3[i],
                self._a4[i])
        if cid == CAT_P2P:
            # synthesize the cross-rank match id traceview keys on
            return {"mid": f"{vals[0]}:{vals[1]}:{vals[2]}:{vals[3]}",
                    "bytes": vals[4]}
        fields = _name_fields[nid] if nid < len(_name_fields) else ()
        out = {}
        for k, v in zip(fields, vals):
            if k.endswith("$"):
                out[k[:-1]] = _names[v] if 0 <= v < len(_names) else v
            else:
                out[k] = v
        return out

    def snapshot(self) -> List[dict]:
        """Events oldest-first, materialized as span dicts (the dump
        schema — id decode and string synthesis happen here, off the
        hot path).  Timestamps become epoch seconds via the anchor."""
        out = []
        for i in self._live_range():
            e = {"name": _names[self._name[i]],
                 "cat": _cats[self._cat[i]],
                 "ph": "X" if self._ph[i] == 0 else "i",
                 "ts": self._wall(self._ts[i]),
                 "args": self._decode_args(i)}
            if self._ph[i] == 0:
                e["dur"] = self._dur[i] * 1e-9
            out.append(e)
        return out

    def phase_totals(self) -> Dict[str, int]:
        """Total recorded microseconds per phase label (plus compile
        spans, which ARE the compile phase) from the live ring — the
        obs_critpath_phase_us gauge.  Cold path: pvar reads and the
        probe harness only."""
        compile_cid = _cat_ids.get("compile", -1)
        out: Dict[str, int] = {}
        for i in self._live_range():
            if self._ph[i] != 0:
                continue
            cid = self._cat[i]
            if cid == CAT_PHASE or cid == compile_cid:
                name = _names[self._name[i]]
                label = PHASE_LABELS.get(name)
                if label is not None:
                    out[label] = out.get(label, 0) \
                        + int(self._dur[i] // 1000)
        return out

    def span_count(self, cat) -> int:
        cid = _cat_ids.get(cat, -1) if isinstance(cat, str) else cat
        n = 0
        for i in self._live_range():
            if self._cat[i] == cid and self._ph[i] == 0:
                n += 1
        return n

    def hist_total(self, which: int) -> int:
        return sum(self.hists[which])

    def dump(self, path: str) -> None:
        """One self-describing per-rank JSON file — the traceview
        input.  Timestamps are epoch seconds (floats); traceview
        converts to microseconds after clock correction.  The
        sampling/drop accounting rides along so a merged view can say
        exactly what fraction of each category it is looking at."""
        doc = {
            "rank": self.rank,
            "recorded": self.recorded,
            "dropped": self.dropped,
            "capacity": self.capacity,
            "anchor": {"wall_s": self.anchor_wall,
                       "perf_ns": self.anchor_ns},
            "sampling": self.sampling_rates(),
            "dropped_by_cat": self.dropped_by_cat(),
            "buckets_us": list(BUCKET_BOUNDS_US),
            "hists": {n: list(h) for n, h in zip(HIST_NAMES, self.hists)},
            "events": self.snapshot(),
        }
        req = self.req_windows()
        if req:
            # request-tag windows (DESIGN.md §23): traceview --job
            # attributes this rank's spans to requests by these marks
            doc["req_windows"] = req
        if self.sync_offsets_us is not None:
            # auto-embedded clock correction (sync_state): traceview
            # and critpath use it when no --sync file is given
            doc["mpisync"] = {"offsets_us": list(self.sync_offsets_us)}
        with open(path, "w") as fh:
            json.dump(doc, fh)


# -- per-rank attach / dump -------------------------------------------------

def force_attach(state) -> Tracer:
    """Attach a tracer regardless of trace_enable (the autotuner runs
    on trace histograms, so enabling it implies a tracer)."""
    tr = Tracer(state.rank, buffer_var.value)
    state.tracer = tr
    state.progress.tracer = tr
    return tr


def attach(state) -> Optional[Tracer]:
    """Called by mpi_init before pml selection: when trace_enable is
    set, hang a Tracer off the ProcState (and the progress engine so
    the tick histogram needs no state lookup).  When off, the
    attributes stay None — the whole hot-path contract."""
    if not enable_var.value:
        state.tracer = None
        return None
    return force_attach(state)


def _resolve_dump_path(base: str, tag: str) -> str:
    if "%r" in base:
        return base.replace("%r", tag)
    if os.path.isdir(base):
        return os.path.join(base, f"trace-r{tag}.json")
    return f"{base}-r{tag}.json"


def dump_state(state) -> Optional[str]:
    """Finalize-time per-rank dump (diagnostics never take a rank
    down: any OS error is swallowed after best effort)."""
    tr = getattr(state, "tracer", None)
    base = dump_var.value
    if tr is None or not base:
        return None
    path = _resolve_dump_path(base, str(state.rank))
    try:
        tr.dump(path)
    except OSError:
        return None
    return path


def sync_state(state) -> None:
    """Finalize-time mpisync: measure cross-rank clock offsets while
    the pml is still alive (BEFORE the finalize fence) and stash them
    on the tracer so every rank's dump carries the correction table —
    traceview/critpath then merge multi-host timelines with no
    hand-plumbed --sync file.  Collective (every rank of a dumping
    world must enter); any failure just leaves the dumps uncorrected,
    diagnostics never take a rank down."""
    tr = getattr(state, "tracer", None)
    rounds = sync_rounds_var.value
    if tr is None or not dump_var.value or rounds <= 0:
        return
    comm = getattr(state, "comm_world", None)
    if comm is None or comm.size < 2:
        return
    try:
        from ompi_tpu_torch.tools import mpisync
        table = mpisync.measure_offsets(comm, rounds=rounds)
        tr.sync_offsets_us = [round(off * 1e6, 3) for off, _rtt in table]
    except Exception:
        tr.sync_offsets_us = None


def instant_state(state, name: str, cat: str, **args) -> None:
    """Record an instant against a specific rank's tracer (the ULFM
    layer annotates detect/revoke/shrink/agree this way — state in
    hand, no thread-local lookup); no-op when tracing is off."""
    tr = getattr(state, "tracer", None)
    if tr is not None:
        tr.instant(name, cat, **args)


# -- process-global tracer (daemons: no ProcState) --------------------------

_global: Optional[Tracer] = None
_global_lock = threading.Lock()


def global_tracer() -> Optional[Tracer]:
    """The tracer for control-plane processes (tpud daemons, the HNP)
    that have no per-rank state.  None when tracing is off."""
    global _global
    if not enable_var.value:
        return None
    if _global is None:
        with _global_lock:
            if _global is None:
                _global = Tracer(-1, buffer_var.value)
    return _global


def dump_global(tag: str) -> Optional[str]:
    if _global is None or not dump_var.value:
        return None
    path = _resolve_dump_path(dump_var.value, tag)
    try:
        _global.dump(path)
    except OSError:
        return None
    return path


def current_tracer() -> Optional[Tracer]:
    """The calling thread-rank's tracer (pvar getters and module-
    global code resolve through here, the pml/monitoring pattern),
    falling back to the process-global daemon tracer."""
    from ompi_tpu_torch.runtime import state as statemod
    st = statemod.maybe_current()
    tr = getattr(st, "tracer", None) if st is not None else None
    return tr if tr is not None else _global


# -- MPI_T pvars ------------------------------------------------------------

def _tr_attr(attr: str):
    def getter():
        tr = current_tracer()
        return getattr(tr, attr) if tr is not None else 0
    return getter


def _tr_hist(which: int):
    def getter():
        tr = current_tracer()
        return list(tr.hists[which]) if tr is not None else []
    return getter


def _tr_dropped_cat(cat: str):
    cid = _cat_ids[cat]

    def getter():
        tr = current_tracer()
        if tr is None or cid >= len(tr._skipped):
            return 0
        return tr._skipped[cid] + tr._over[cid]
    return getter


registry.register_pvar(
    "trace", "", "events_recorded",
    help="Trace events recorded by this rank (kept + dropped)",
    getter=_tr_attr("recorded"))
registry.register_pvar(
    "trace", "", "events_dropped",
    help="Trace events not retained: sampled out + lost to "
         "ring-buffer wraparound (raise trace_buffer_events)",
    getter=_tr_attr("dropped"))
registry.register_pvar(
    "trace", "", "sampling_rate",
    help="Current per-category 1-in-N sampling periods (dict cat -> "
         "N; N=1 means every span is kept)",
    getter=lambda: (current_tracer().sampling_rates()
                    if current_tracer() is not None else {}))
for _cat in SPAN_CATS:
    registry.register_pvar(
        "trace", "", f"dropped_{_cat}",
        help=f"Exact count of '{_cat}' spans not in the ring "
             "(sampled out + overwritten)",
        getter=_tr_dropped_cat(_cat))
registry.register_pvar(
    "trace", "", "hist_bucket_bounds_us", var_class="size",
    help="Upper bounds (us) of the fixed log2 latency buckets shared "
         "by every trace histogram pvar",
    getter=lambda: list(BUCKET_BOUNDS_US))
registry.register_pvar(
    "trace", "", "hist_progress_tick", var_class="size",
    help="Progress-sweep latency histogram (log2 us buckets)",
    getter=_tr_hist(HIST_PROGRESS_TICK))
registry.register_pvar(
    "trace", "", "hist_coll_dispatch", var_class="size",
    help="Device-collective rendezvous+dispatch latency histogram",
    getter=_tr_hist(HIST_COLL_DISPATCH))
registry.register_pvar(
    "trace", "", "hist_p2p_complete", var_class="size",
    help="Point-to-point activate-to-complete latency histogram",
    getter=_tr_hist(HIST_P2P_COMPLETE))
registry.register_pvar(
    "trace", "", "hist_coll_segment", var_class="size",
    help="Per-segment rendezvous latency histogram of the pipelined "
         "large-message tier (log2 us buckets)",
    getter=_tr_hist(HIST_COLL_SEGMENT))
registry.register_pvar(
    "trace", "", "hist_serve_attach", var_class="size",
    help="DVM service-plane session-attach latency histogram "
         "(log2 us buckets; fed by the pool's global tracer)",
    getter=_tr_hist(HIST_SERVE_ATTACH))
registry.register_pvar(
    "trace", "", "hist_rdv_wait", var_class="size",
    help="Rendezvous-wait phase latency histogram (log2 us buckets; "
         "fed by the phase profiler's ph_rdv_wait spans — device "
         "meeting waits and pml RNDV->ACK windows)",
    getter=_tr_hist(HIST_RDV_WAIT))


# -- shared collective/nbc instrumentation points ---------------------------
# These helpers are the ONE place blocking-collective and nbc
# lifecycles are observed: they record trace spans AND fire the
# extended PERUSE events, so subscribing to peruse and reading traces
# can never disagree about where the hooks sit.

def coll_seq(comm) -> int:
    """Next per-comm collective sequence number — the cross-rank
    correlation key (MPI collective-ordering semantics make every
    member's counter agree)."""
    s = comm._coll_seq + 1
    comm._coll_seq = s
    return s


def coll_begin(comm, name_id: int, _peruse=peruse, _CAT=CAT_COLL):
    """Blocking-collective entry.  ``name_id`` is the collective's
    interned span name (the merged-vtable shim interns once at wrap
    time).  Returns an opaque token for coll_end: None when both
    observability systems are off (the shim passes straight through),
    0 when the span was sampled out (the seq still advanced — the
    cross-rank counter must tick identically on every member, and the
    shim skips coll_end entirely), a positive ns start otherwise, or
    a tuple on the cold peruse path.

    The default-arg bindings turn module-global lookups into local
    loads, and the sampled-out branch of start_sampled is inlined: in
    steady state (63-in-64 once a category is hot) this path is the
    whole per-op cost of tracing, and on the 1-core bench box every
    GIL-held instruction here is multiplied by the rank count."""
    if _peruse.enabled:
        return _coll_begin_slow(comm, name_id)
    tr = comm.state.tracer
    if tr is None:
        return None
    comm._coll_seq = comm._coll_seq + 1
    ctr = tr._ctr
    c = ctr[_CAT]
    if c:
        ctr[_CAT] = c - 1
        tr._skipped[_CAT] += 1
        return 0
    return tr.start_sampled(_CAT)


def coll_end(comm, name_id: int, token) -> None:
    if type(token) is int:
        if token:
            tr = comm.state.tracer
            if tr is not None:
                tr.end(token, name_id, CAT_COLL, comm.cid,
                       comm._coll_seq)
        return
    if token is not None:
        _coll_end_slow(comm, name_id, token)


def _coll_begin_slow(comm, name_id: int):
    seq = coll_seq(comm)
    peruse.fire("coll_begin", cid=comm.cid, coll=_names[name_id],
                seq=seq)
    tr = comm.state.tracer
    t0 = tr.start_sampled(CAT_COLL) if tr is not None else 0
    return (seq, t0)


def _coll_end_slow(comm, name_id: int, token) -> None:
    seq, t0 = token
    if t0:
        tr = comm.state.tracer
        if tr is not None:
            tr.end(t0, name_id, CAT_COLL, comm.cid, seq)
    peruse.fire("coll_end", cid=comm.cid, coll=_names[name_id],
                seq=seq)


def nbc_begin(comm, name_id: int = NAME_NBC):
    """Nonblocking-collective activation (NBCRequest construction).
    Returns the token the request stashes until completion."""
    tr = comm.state.tracer
    if tr is None and not peruse.enabled:
        return None
    seq = coll_seq(comm)
    if peruse.enabled:
        peruse.fire("nbc_activate", cid=comm.cid, coll=_names[name_id],
                    seq=seq)
    t0 = tr.start_sampled(CAT_NBC) if tr is not None else 0
    return (seq, t0, tr, comm.cid, name_id)


def nbc_end(token) -> None:
    if token is None:
        return
    seq, t0, tr, cid, name_id = token
    if tr is not None and t0:
        tr.end(t0, name_id, CAT_NBC, cid, seq)
    if peruse.enabled:
        peruse.fire("nbc_complete", cid=cid, coll=_names[name_id],
                    seq=seq)
