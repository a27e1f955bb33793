"""Observability planes of the port: per-session attribution, the
flight recorder and the rank-local scrape, ported from the reference's
``ompi_tpu/obs/__init__.py``; the integrity (silent-data-corruption)
plane is ``obs/integrity.py``.

* **ScopedPvar** — per-session attribution for hot counters.  The
  global value stays a plain O(1) integer bump on the underlying
  registry PVar (MPI_T readers see exactly what they saw before); a
  parallel per-band integer list accumulates the same adds keyed by the
  session's cid band (``ProcState.cid_band``: resident sessions of one
  process, ``testing.sessions.run_sessions``).  Per-session reads come
  ONLY from the scrape path — the hot path never sums bands.
  ``ScopedHist`` is the same for log2 latency histograms.

* **FlightRecorder** — a bounded ring of typed operational events
  (fault injections, SDC mismatch/retry/conviction; the ULFM, respawn,
  checkpoint and pool events keep their numbers for the planes still
  to port) held as parallel integer columns with perf-counter
  timestamps against a wall anchor adopted from the Tracer when one
  exists — so flight events land on the same timeline as trace spans
  (``trace_dump`` loads in ``tools/traceview``).

* **Scraper** — a rank-local snapshot of the trace latency histograms
  into a preallocated integer buffer, refreshed on the progress tick at
  a bounded cadence (``obs_scrape_interval_ms``), readable from another
  thread through a generation stamp.  ``Scraper.tick`` follows the
  Tracer's columns-not-objects discipline and is held by
  ``tools/hotpath_audit.py``.

Registration is idempotent across looped worlds: ``register_pvars()``
is guarded by a module flag, the recorder is a lazy process singleton,
and ``attach(state)`` may run once per world without duplicating
anything.
"""

from __future__ import annotations

import json
import os
import threading
import time
from array import array
from typing import Any, Dict, List, Optional

from ompi_tpu_torch import trace as _trace
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.runtime import state as _statemod

# -- knobs ------------------------------------------------------------------

_interval_var = registry.register(
    "obs", "", "scrape_interval_ms", 100, int,
    help="Minimum interval between rank-local histogram snapshots on "
         "the progress tick (0 disables the scrape tick; the metrics "
         "RPC then reads tracer histograms directly)")
_ring_var = registry.register(
    "obs", "", "events_ring", 256, int,
    help="Flight-recorder capacity (events); the oldest event is "
         "overwritten and the dropped counter grows")
_prom_var = registry.register(
    "obs", "", "prometheus", True, bool,
    help="Include Prometheus text exposition in the resident pool's "
         "metrics RPC replies")
_wd_ms_var = registry.register(
    "obs", "", "watchdog_ms", 0, int,
    help="Progress-stall watchdog tick interval of the resident pool "
         "(tools/dvm.py), milliseconds (0 = off, the default).  A "
         "running job whose wall time exceeds the pool's EWMA estimate "
         "by obs_watchdog_factor fires a wd_stall flight event and a "
         "doctor capture (stacks + rendezvous/fence/abort state) "
         "within ~2 ticks")
_wd_factor_var = registry.register(
    "obs", "", "watchdog_factor", 4, int,
    help="Stall threshold as a multiple of the pool's EWMA wall "
         "estimate: a job running longer than factor x estimate is "
         "declared stalled.  With the FleetController on, its "
         "published per-tick tolerance (widened under backlog) takes "
         "precedence, this knob seeding its floor")


def watchdog_ms() -> int:
    return max(0, int(_wd_ms_var.value))


def watchdog_factor_pct() -> int:
    """The stall threshold in percent of the EWMA wall estimate (knob
    x100; the FleetController publishes an adaptive override)."""
    return max(100, int(_wd_factor_var.value) * 100)


def prometheus_enabled() -> bool:
    return bool(_prom_var.value)


# -- per-session attribution ------------------------------------------------

# Session ids band into a fixed power-of-two table: adds stay two
# integer bumps with a mask (no dict lookup on the hot serve path).
# Band 0 is the unattributed bucket (non-session work); the global
# read always equals the sum over ALL bands including band 0.
MAX_BANDS = 1024
_BAND_MASK = MAX_BANDS - 1

_scoped: Dict[str, "ScopedPvar"] = {}
_scoped_lock = threading.Lock()


class ScopedPvar:
    """A registry PVar plus a per-session-band shadow accumulator.

    ``add(n, band)`` is two integer adds: the global ``PVar._value``
    (so every existing MPI_T reader, pvar handle and index is
    untouched) and ``bands[band & mask]``, under one lock (the port's
    ranks are threads, and a resident session's count must be exact).
    Global reads stay O(1); per-band reads are served by the scrape
    path only.
    """

    __slots__ = ("pvar", "bands", "lock")

    def __init__(self, pvar) -> None:
        self.pvar = pvar
        self.bands = [0] * MAX_BANDS
        self.lock = threading.Lock()

    @property
    def full_name(self) -> str:
        return self.pvar.full_name

    def add(self, n: int = 1, band: int = 0) -> None:
        with self.lock:
            self.pvar._value += n
            self.bands[band & _BAND_MASK] += n

    def read(self) -> int:
        return self.pvar.read()

    def read_band(self, band: int) -> int:
        return self.bands[band & _BAND_MASK]

    def nonzero_bands(self) -> Dict[int, int]:
        out = {}
        for b, v in enumerate(self.bands):
            if v:
                out[b] = v
        return out


def scoped_pvar(framework: str, component: str, name: str,
                help: str = "", var_class: str = "counter") -> ScopedPvar:
    """Idempotent factory: wraps (or registers) the PVar of that full
    name.  Safe to call at import time and across looped worlds — the
    registry returns the existing PVar on collision and the scoped
    wrapper is cached by full name, so indices never move and bands
    never reset behind a caller's back."""
    pv = registry.register_pvar(framework, component, name,
                                help=help, var_class=var_class)
    with _scoped_lock:
        sp = _scoped.get(pv.full_name)
        if sp is None:
            sp = ScopedPvar(pv)
            _scoped[pv.full_name] = sp
        return sp


def scoped_items() -> List[ScopedPvar]:
    with _scoped_lock:
        return list(_scoped.values())


def scoped_snapshot() -> Dict[str, Dict[str, Any]]:
    """{name: {"global": v, "bands": {band: v}}} — the attribution
    view the metrics RPC exports.  global == sum(bands) always holds
    because every add goes through ScopedPvar.add."""
    out: Dict[str, Dict[str, Any]] = {}
    for sp in scoped_items():
        out[sp.full_name] = {"global": sp.read(),
                             "bands": {str(b): v for b, v in
                                       sp.nonzero_bands().items()}}
    return out


def current_band() -> int:
    """The calling thread's session band (0 when no MPI state)."""
    st = _statemod.maybe_current()
    return st.cid_band if st is not None else 0


class ScopedHist:
    """Per-session log2 latency histogram for serve-plane SLI gauges
    (queue-wait p99 and friends): one global histogram plus a lazy
    per-band shadow keyed by the same cid-band the ScopedPvars use.
    ``add_us`` is a bit_length bucket index and two integer bumps;
    band rows allocate under a lock the FIRST time a session appears
    — adds ride the serve control path (attach/run bookkeeping),
    never a traced rank hot path, so the lazy allocation is fine.
    Buckets are the trace module's fixed log2 bounds, so
    ``hist_percentiles`` reads these directly."""

    __slots__ = ("name", "total", "bands", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.total = [0] * _trace.N_BUCKETS
        self.bands: Dict[int, List[int]] = {}
        self._lock = threading.Lock()

    def add_us(self, us: int, band: int = 0) -> None:
        b = int(us).bit_length()
        if b >= _trace.N_BUCKETS:
            b = _trace.N_BUCKETS - 1
        self.total[b] += 1
        band &= _BAND_MASK
        h = self.bands.get(band)
        if h is None:
            with self._lock:
                h = self.bands.setdefault(band,
                                          [0] * _trace.N_BUCKETS)
        h[b] += 1

    def band_hist(self, band: int) -> Optional[List[int]]:
        return self.bands.get(band & _BAND_MASK)

    def band_percentile(self, band: int, tag: str = "p99") -> int:
        h = self.band_hist(band)
        if h is None:
            return 0
        return int(hist_percentiles(h)[tag])


_scoped_hists: Dict[str, ScopedHist] = {}


def scoped_hist(name: str) -> ScopedHist:
    """Idempotent factory (the scoped_pvar model): one ScopedHist per
    full name, cached for the life of the process so bands never
    reset behind a reader's back."""
    with _scoped_lock:
        sh = _scoped_hists.get(name)
        if sh is None:
            sh = ScopedHist(name)
            _scoped_hists[name] = sh
        return sh


def scoped_hist_snapshot() -> Dict[str, Dict[str, Any]]:
    """{name: {"total": [...], "bands": {band: [...]}}} — the SLI
    attribution view the metrics RPC exports next to ``scoped``."""
    with _scoped_lock:
        hists = list(_scoped_hists.values())
    out: Dict[str, Dict[str, Any]] = {}
    for sh in hists:
        out[sh.name] = {"total": list(sh.total),
                        "bands": {str(b): list(h) for b, h in
                                  sh.bands.items() if sum(h)}}
    return out


# -- flight recorder --------------------------------------------------------

EV_ULFM_DETECT = 0
EV_ULFM_REVOKE = 1
EV_ULFM_AGREE = 2
EV_ULFM_SHRINK = 3
EV_RESPAWN = 4
EV_CKPT_COMMIT = 5
EV_CKPT_ABORT = 6
EV_CKPT_CRC_FALLBACK = 7
EV_ADMIT_REJECT = 8
EV_QUEUE_FULL = 9
EV_FT_INJECT = 10
EV_DVM_ATTACH = 11
EV_DVM_DETACH = 12
EV_DVM_HALT = 13
EV_DVM_RUN = 14
EV_DVM_PREEMPT = 15
EV_DVM_SHED = 16
EV_DVM_RESIZE = 17
EV_DVM_QUOTA = 18
EV_CTRL_ADJUST = 19
EV_KV_FAILOVER = 20
EV_DVM_REHYDRATE = 21
EV_DVM_REPLAY = 22
EV_HOST_LOST = 23
EV_HOST_RESPAWN = 24
# request-scoped tracing + hang doctor (DESIGN.md §23): the ``tid``
# argument is the 63-bit request trace id minted at DvmClient
# attach/run — traceview --job stitches these into one waterfall
EV_REQ_ATTACH = 25
EV_REQ_RUN = 26
EV_REQ_PARK = 27
EV_REQ_RESUME = 28
EV_WD_STALL = 29
EV_REQ_DRAIN = 30
# gray-failure health plane (DESIGN.md §24): hysteresis transitions
# on the host state machine plus the quarantine drain-and-migrate
EV_HOST_DEGRADED = 31
EV_HOST_QUARANTINE = 32
EV_HOST_RECOVERED = 33
EV_MIGRATE = 34
# silent-data-corruption plane (DESIGN.md §25): sampled check
# mismatch, bisection conviction of a rank/chip, retry-from-source
EV_SDC_MISMATCH = 35
EV_SDC_CONVICT = 36
EV_SDC_RETRY = 37

EVENT_NAMES = (
    "ulfm_detect", "ulfm_revoke", "ulfm_agree", "ulfm_shrink",
    "respawn_rejoin", "ckpt_commit", "ckpt_abort", "ckpt_crc_fallback",
    "dvm_reject", "dvm_queue_full", "ft_inject", "dvm_attach",
    "dvm_detach", "dvm_halt", "dvm_run", "dvm_preempt", "dvm_shed",
    "dvm_resize", "dvm_quota", "ctrl_adjust", "kv_failover",
    "dvm_rehydrate", "dvm_replay", "host_lost", "host_respawn",
    "req_attach", "req_run", "req_park", "req_resume", "wd_stall",
    "req_drain", "host_degraded", "host_quarantine", "host_recovered",
    "dvm_migrate", "sdc_mismatch", "sdc_convict", "sdc_retry",
)

# Per-type argument field names (positional a0..a3); a trailing "$"
# marks an interned-string id decoded at snapshot time — the same
# convention the Tracer uses for span args.
EVENT_FIELDS = (
    ("failed", "epoch"),                     # ulfm_detect
    ("cid",),                                # ulfm_revoke
    ("cid", "seq", "flag"),                  # ulfm_agree
    ("cid", "new_cid", "survivors", "us"),   # ulfm_shrink
    ("epoch", "replaced", "us"),             # respawn_rejoin
    ("epoch", "us"),                         # ckpt_commit
    ("epoch",),                              # ckpt_abort
    ("epoch",),                              # ckpt_crc_fallback
    ("sid", "reason$"),                      # dvm_reject
    ("depth",),                              # dvm_queue_full
    ("cls$", "scope$"),                      # ft_inject
    ("sid", "np", "us"),                     # dvm_attach
    ("sid",),                                # dvm_detach
    ("sessions", "jobs"),                    # dvm_halt
    ("sid", "code", "wall_ms"),              # dvm_run
    ("sid", "by_sid", "prio", "us"),         # dvm_preempt
    ("sid", "deadline_ms", "est_ms"),        # dvm_shed
    ("old", "new", "epoch"),                 # dvm_resize
    ("sid", "kind$", "val"),                 # dvm_quota
    ("margin_pct", "qdepth", "p99_us"),      # ctrl_adjust
    ("band", "ep$"),                         # kv_failover
    ("sessions", "jobs_done", "inc$"),       # dvm_rehydrate
    ("sid", "code"),                         # dvm_replay
    ("host", "ranks", "sessions"),           # host_lost
    ("host", "sessions", "ms"),              # host_respawn
    ("sid", "tid", "queued_us"),             # req_attach
    ("sid", "tid", "span", "wall_ms"),       # req_run
    ("sid", "tid"),                          # req_park
    ("sid", "tid", "us"),                    # req_resume
    ("sid", "tid", "run_ms", "est_ms"),      # wd_stall
    ("band", "epoch", "us"),                 # req_drain
    ("host", "score", "state"),              # host_degraded
    ("host", "score", "sessions"),           # host_quarantine
    ("host", "score"),                       # host_recovered
    ("sid", "host", "us"),                   # dvm_migrate
    ("cid", "seq", "kind$"),                 # sdc_mismatch
    ("rank", "host", "kind$"),               # sdc_convict
    ("cid", "seq", "rank"),                  # sdc_retry
)

# interned strings for event args (reason/cls/scope): the ring holds
# only integers; decode happens at snapshot, off the recording path
_strings: List[str] = []
_string_ids: Dict[str, int] = {}
_str_lock = threading.Lock()


def intern(s: str) -> int:
    sid = _string_ids.get(s)
    if sid is not None:
        return sid
    with _str_lock:
        sid = _string_ids.get(s)
        if sid is None:
            sid = len(_strings)
            _strings.append(s)
            _string_ids[s] = sid
        return sid


def intern_lookup(sid: int) -> str:
    return _strings[sid] if 0 <= sid < len(_strings) else str(sid)


class FlightRecorder:
    """Bounded ring of typed operational events as parallel integer
    columns (timestamp ns, type code, rank, four int args).  Recording
    is cold-path (failures, attaches, commits) but still cheap and
    thread-safe — pool threads, rank threads and the OOB thread all
    record into the one process ring."""

    __slots__ = ("cap", "head", "lock", "anchor_wall", "anchor_ns",
                 "_ts", "_type", "_rank", "_a0", "_a1", "_a2", "_a3")

    def __init__(self, cap: int, anchor: Optional[tuple] = None) -> None:
        self.cap = max(8, int(cap))
        self.head = 0  # total events ever recorded
        self.lock = threading.Lock()
        if anchor is not None:
            self.anchor_wall, self.anchor_ns = anchor
        else:
            # same two-clock anchor the Tracer captures: wall epoch +
            # monotonic perf counter sampled back to back
            self.anchor_wall = time.time()
            self.anchor_ns = time.perf_counter_ns()
        self._ts = array("q", [0] * self.cap)
        self._type = array("i", [0] * self.cap)
        self._rank = array("i", [0] * self.cap)
        self._a0 = array("q", [0] * self.cap)
        self._a1 = array("q", [0] * self.cap)
        self._a2 = array("q", [0] * self.cap)
        self._a3 = array("q", [0] * self.cap)

    @property
    def recorded(self) -> int:
        return self.head

    @property
    def dropped(self) -> int:
        return max(0, self.head - self.cap)

    def record(self, ev: int, a0: int = 0, a1: int = 0, a2: int = 0,
               a3: int = 0, rank: int = -1) -> None:
        with self.lock:
            i = self.head % self.cap
            self._ts[i] = time.perf_counter_ns()
            self._type[i] = ev
            self._rank[i] = rank
            self._a0[i] = a0
            self._a1[i] = a1
            self._a2[i] = a2
            self._a3[i] = a3
            self.head += 1

    def _wall(self, ts_ns: int) -> float:
        return self.anchor_wall + (ts_ns - self.anchor_ns) * 1e-9

    def snapshot(self, last: Optional[int] = None) -> List[dict]:
        """Events oldest-first as dicts in the trace-dump event shape
        (name/cat/ph/ts/args) so traceview merges them unchanged.
        ``last`` keeps only the newest N."""
        with self.lock:
            live = min(self.head, self.cap)
            start = self.head - live
            if last is not None and last >= 0:
                start = max(start, self.head - last)
            rows = []
            for n in range(start, self.head):
                i = n % self.cap
                rows.append((self._ts[i], self._type[i], self._rank[i],
                             self._a0[i], self._a1[i], self._a2[i],
                             self._a3[i]))
        out = []
        for ts, typ, rank, a0, a1, a2, a3 in rows:
            fields = EVENT_FIELDS[typ] if 0 <= typ < len(EVENT_FIELDS) \
                else ()
            args: Dict[str, Any] = {}
            vals = (a0, a1, a2, a3)
            for k, v in zip(fields, vals):
                if k.endswith("$"):
                    args[k[:-1]] = intern_lookup(v)
                else:
                    args[k] = v
            out.append({"name": EVENT_NAMES[typ]
                        if 0 <= typ < len(EVENT_NAMES) else str(typ),
                        "cat": "flight", "ph": "i",
                        "ts": self._wall(ts), "rank": rank,
                        "args": args})
        return out

    def trace_dump(self, last: Optional[int] = None) -> dict:
        """A traceview-loadable document (has rank + events; rank -1
        passes through clock correction uncorrected, like daemon
        dumps)."""
        return {"rank": -1, "flight": True,
                "recorded": self.recorded, "dropped": self.dropped,
                "capacity": self.cap,
                "anchor": {"wall_s": self.anchor_wall,
                           "perf_ns": self.anchor_ns},
                "events": self.snapshot(last)}

    def persist(self, path: str, comm=None) -> Optional[str]:
        """Write the ring as JSON.  With a communicator, write through
        the io layer (collective open, rank 0 lays down the bytes) —
        the failure path in an MPI world.  Without one (pool halt, no
        comm in scope) fall back to an atomic plain write.  Returns
        the path on success, None on best-effort failure."""
        try:
            data = json.dumps(self.trace_dump(), indent=1).encode()
            if comm is not None:
                import numpy as np

                from ompi_tpu_torch import io as mpiio
                f = mpiio.open(comm, path,
                               mpiio.MODE_CREATE | mpiio.MODE_RDWR)
                try:
                    if comm.rank == 0:
                        f.write_at(0, np.frombuffer(bytearray(data),
                                                    dtype=np.uint8))
                finally:
                    f.close()
            else:
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "wb") as fh:
                    fh.write(data)
                os.replace(tmp, path)
            return path
        except (OSError, ValueError):
            return None


_recorder: Optional[FlightRecorder] = None
_rec_lock = threading.Lock()


def recorder() -> FlightRecorder:
    """The process flight recorder (lazy singleton; ring sized by
    ``obs_events_ring`` at first use; anchor adopted from the current
    or global tracer when one exists so flight timestamps share the
    trace timeline)."""
    global _recorder
    r = _recorder
    if r is None:
        with _rec_lock:
            r = _recorder
            if r is None:
                anchor = None
                tr = _trace.current_tracer()
                if tr is not None:
                    anchor = (tr.anchor_wall, tr.anchor_ns)
                r = FlightRecorder(_ring_var.value, anchor)
                _recorder = r
    return r


def record_event(ev: int, a0: int = 0, a1: int = 0, a2: int = 0,
                 a3: int = 0, rank: int = -1) -> None:
    """The one-call tap every subsystem uses (ulfm, respawn, ckpt,
    ft_inject, integrity; the pool's events when it is ported).  Never
    raises."""
    try:
        recorder().record(ev, a0, a1, a2, a3, rank)
    except Exception:
        pass


# -- rank-local scrape on the progress tick ---------------------------------

# buffer layout (array('q')):
#   [0] generation (odd while a refresh is in flight — seqlock)
#   [1] perf_counter_ns of the last refresh
#   [2 : 2+n_hists*N_BUCKETS]  trace histogram counts, hist-major
_BUF_HDR = 2


class Scraper:
    """Rank-local snapshot of the trace latency histograms into a
    preallocated integer buffer, refreshed on the progress tick no
    more often than ``obs_scrape_interval_ms``.  A reader on another
    thread (the pool's metrics RPC, when it is ported) reads ``buf``;
    the odd/even generation stamp lets it detect a torn read and
    retry.  ``tick`` is hot-path
    audited: no allocation, no displays, integers only — and no clock
    read of its own: the progress engine passes the timestamp it
    already sampled for tracer tick timing (1-in-16 sweeps), so the
    scrape adds zero clock reads to the hot spin.  The first refresh
    snapshots every histogram; later refreshes copy ONE histogram
    round-robin (21 ints), so the amortized cost stays flat no matter
    how hot the interval is — per-histogram consistency is all the
    percentile math downstream needs, and a histogram is never staler
    than nhists intervals."""

    __slots__ = ("tracer", "interval_ns", "next_ns", "buf",
                 "nhists", "nbuckets", "ticks", "cursor")

    def __init__(self, tracer, interval_ms: int) -> None:
        self.tracer = tracer
        self.interval_ns = max(1, int(interval_ms)) * 1_000_000
        self.next_ns = 0
        self.nhists = len(_trace.HIST_NAMES)
        self.nbuckets = _trace.N_BUCKETS
        self.buf = array("q", [0] * (_BUF_HDR +
                                     self.nhists * self.nbuckets))
        self.ticks = 0
        self.cursor = 0

    def tick(self, now: int) -> int:
        if now < self.next_ns:
            return 0
        self.next_ns = now + self.interval_ns
        buf = self.buf
        hists = self.tracer.hists
        nb = self.nbuckets
        nh = self.nhists
        buf[0] += 1
        if self.ticks == 0:
            j = 2
            k = 0
            while k < nh:
                h = hists[k]
                m = 0
                while m < nb:
                    buf[j] = h[m]
                    j += 1
                    m += 1
                k += 1
        else:
            k = self.cursor
            h = hists[k]
            j = _BUF_HDR + k * nb
            m = 0
            while m < nb:
                buf[j] = h[m]
                j += 1
                m += 1
            k += 1
            if k >= nh:
                k = 0
            self.cursor = k
        buf[1] = now
        buf[0] += 1
        self.ticks += 1
        return 1

    def read_hists(self) -> Optional[List[List[int]]]:
        """Server-thread side: a consistent [hist][bucket] copy, or
        None when no refresh has landed yet (caller falls back to the
        tracer's own lists)."""
        for _ in range(8):
            g0 = self.buf[0]
            if g0 == 0 or g0 & 1:
                if g0 == 0:
                    return None
                continue
            flat = list(self.buf)
            if flat[0] != g0:
                continue
            nb = self.nbuckets
            out = []
            for k in range(self.nhists):
                off = _BUF_HDR + k * nb
                out.append(flat[off:off + nb])
            return out
        return None


# -- percentile gauges ------------------------------------------------------

PCT_TAGS = ("p50", "p90", "p99")
_PCT_QS = (0.50, 0.90, 0.99)


def hist_percentiles(hist) -> Dict[str, float]:
    """p50/p90/p99 in microseconds from a log2 latency histogram
    (bucket b holds durations in [2^(b-1), 2^b) us; the reported
    value is the bucket's upper bound — the resolution the histogram
    actually has)."""
    total = 0
    for c in hist:
        total += c
    out: Dict[str, float] = {}
    if total == 0:
        for tag in PCT_TAGS:
            out[tag] = 0.0
        return out
    for tag, q in zip(PCT_TAGS, _PCT_QS):
        target = q * total
        cum = 0
        for b, c in enumerate(hist):
            cum += c
            if cum >= target:
                out[tag] = _trace.bucket_upper_us(b)
                break
    return out


def _pct_getter(which: int, qi: int):
    def get() -> int:
        tr = _trace.current_tracer()
        if tr is None:
            return 0
        tag = PCT_TAGS[qi]
        return int(hist_percentiles(tr.hists[which])[tag])
    return get


# -- registration (idempotent across looped worlds) -------------------------

_registered = False
_reg_lock = threading.Lock()


def register_pvars() -> None:
    """Register the obs gauges exactly once per process (the pstat
    idempotency model): looped worlds re-enter mpi_init, and MPI_T
    requires that pvar indices never move once handed out — a second
    registration pass must be a no-op, not a duplicate set."""
    global _registered
    with _reg_lock:
        if _registered:
            return
        _registered = True
        for wi, hname in enumerate(_trace.HIST_NAMES):
            for qi, tag in enumerate(PCT_TAGS):
                registry.register_pvar(
                    "obs", tag, hname, var_class="level",
                    getter=_pct_getter(wi, qi),
                    help=f"{tag} of the {hname} latency histogram "
                         f"(us, log2-bucket upper bound)")
        registry.register_pvar(
            "obs", "events", "recorded", var_class="counter",
            getter=lambda: recorder().recorded,
            help="Flight-recorder events recorded (kept + dropped)")
        registry.register_pvar(
            "obs", "events", "dropped", var_class="counter",
            getter=lambda: recorder().dropped,
            help="Flight-recorder events overwritten (ring wrapped)")
        registry.register_pvar(
            "obs", "", "scrapes", var_class="counter",
            getter=_scrapes_getter,
            help="Histogram snapshots taken by this rank's scraper")
        # critical-path profiler gauges (DESIGN.md §18): live view of
        # the phase-span totals tools/critpath.py analyzes offline
        registry.register_pvar(
            "obs", "critpath", "phase_us", var_class="level",
            getter=_critpath_phase_us,
            help="Cumulative us recorded per dispatch phase "
                 "(rendezvous/pack/dispatch/execute/unpack/compile) "
                 "by the phase profiler (trace_phase_enable)")
        registry.register_pvar(
            "obs", "critpath", "gating_phase", var_class="level",
            getter=_gating_phase,
            help="Phase with the largest cumulative recorded time on "
                 "this rank — the local dispatch-tax leader")
        registry.register_pvar(
            "obs", "straggler", "skew_us", var_class="level",
            getter=_straggler_skew_us,
            help="p90 of the rendezvous-wait histogram (us): how long "
                 "this rank typically waits for its slowest peer")


def _critpath_phase_us() -> Dict[str, int]:
    st = _statemod.maybe_current()
    tr = st.tracer if st is not None else None
    return tr.phase_totals() if tr is not None else {}


def _gating_phase() -> str:
    best = ""
    best_v = -1
    for label, us in _critpath_phase_us().items():
        if us > best_v:
            best, best_v = label, us
    return best


def _straggler_skew_us() -> int:
    st = _statemod.maybe_current()
    tr = st.tracer if st is not None else None
    if tr is None:
        return 0
    return int(hist_percentiles(tr.hists[_trace.HIST_RDV_WAIT])["p90"])


def _scrapes_getter() -> int:
    st = _statemod.maybe_current()
    if st is None:
        return 0
    sc = st.extra.get("obs_scraper")
    return sc.ticks if sc is not None else 0


def attach(state) -> None:
    """mpi_init hook (rides next to trace.attach / pstat): register
    the gauges, make sure the recorder exists (adopting this world's
    tracer anchor when it is first built here), and hang a Scraper off
    the progress engine when scraping is enabled and a tracer is on.
    With trace off or interval 0 the progress engine pays exactly one
    is-None check — the same contract as the tracer slot."""
    register_pvars()
    recorder()
    # arm (or refresh) the SDC-detection plane from its knobs — the
    # coll meet path reads the integrity module's cached flag only
    from ompi_tpu_torch.obs import integrity as _integrity
    _integrity.refresh()
    iv = _interval_var.value
    if iv and iv > 0 and state.tracer is not None:
        sc = Scraper(state.tracer, iv)
        state.extra["obs_scraper"] = sc
        state.progress.obs = sc


def detach(state) -> None:
    """mpi_finalize hook: stop the scrape tick for this world.  The
    recorder and registered gauges survive (process-scoped; the next
    looped world reuses them)."""
    state.progress.obs = None
    state.extra.pop("obs_scraper", None)


# -- local metrics + Prometheus exposition ----------------------------------

def local_metrics(events: int = 16, tracer=None,
                  prefix: Optional[str] = None) -> Dict[str, Any]:
    """Process-local metrics document: the full pvar registry, the
    latency histograms + derived percentiles, scoped-counter
    attribution, and the flight-recorder tail.  Used by the tpud
    ``metrics`` OOB op and as the building block of the pool's RPC.
    ``prefix`` narrows the pvar snapshot to one subsystem (a fleet
    scraper polling ``dvm_``/``ctrl_`` state does not ship the whole
    registry per node per tick)."""
    from ompi_tpu_torch import mpit
    if tracer is None:
        tracer = _trace.current_tracer()
    hists: Dict[str, List[int]] = {}
    pcts: Dict[str, Dict[str, float]] = {}
    if tracer is not None:
        for name, h in zip(_trace.HIST_NAMES, tracer.hists):
            hists[name] = list(h)
            pcts[name] = hist_percentiles(h)
    return {
        "ts": time.time(),
        "pvars": mpit.pvar_snapshot(prefix),
        "hists": hists,
        "percentiles": pcts,
        "scoped": scoped_snapshot(),
        "scoped_hists": scoped_hist_snapshot(),
        "events": recorder().snapshot(events),
    }


def _prom_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(metrics: Dict[str, Any],
                    prefix: str = "ompi_tpu") -> str:
    """Prometheus text exposition format (version 0.0.4) rendered from
    a metrics document: scalar pvars as counters/gauges, scoped
    counters as ONE grouped family each — the global sum plus a
    ``session`` label per cid band (0.0.4 requires all samples of a
    family in one group, so scoped names are skipped in the plain
    pvar sweep and rendered here) — per-session SLI histograms as
    labeled percentile gauges, and the latency percentile gauges as a
    labeled ``latency_us`` family."""
    classes: Dict[str, str] = {}
    for p in registry.pvars_in_registration_order():
        classes[p.full_name] = p.var_class
    scoped = metrics.get("scoped", {})
    lines: List[str] = []
    for name, val in metrics.get("pvars", {}).items():
        if name in scoped:
            continue  # rendered grouped with its session series below
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            continue
        typ = "counter" if classes.get(name) == "counter" else "gauge"
        lines.append(f"# TYPE {prefix}_{name} {typ}")
        lines.append(f"{prefix}_{name} {val}")
    for sname, sv in scoped.items():
        typ = "counter" if classes.get(sname, "counter") == "counter" \
            else "gauge"
        lines.append(f"# TYPE {prefix}_{sname} {typ}")
        g = sv.get("global")
        if isinstance(g, (int, float)) and not isinstance(g, bool):
            lines.append(f"{prefix}_{sname} {g}")
        for band, v in sorted(sv.get("bands", {}).items(),
                              key=lambda kv: int(kv[0])):
            lines.append(f'{prefix}_{sname}'
                         f'{{session="{_prom_escape(str(band))}"}} {v}')
    for hname, hv in sorted(metrics.get("scoped_hists", {}).items()):
        lines.append(f"# TYPE {prefix}_{hname} gauge")
        tot = hist_percentiles(hv.get("total") or [])
        for tag in PCT_TAGS:
            lines.append(f'{prefix}_{hname}{{q="{tag}"}} '
                         f'{tot.get(tag, 0.0)}')
        for band, h in sorted(hv.get("bands", {}).items(),
                              key=lambda kv: int(kv[0])):
            p = hist_percentiles(h)
            for tag in PCT_TAGS:
                lines.append(f'{prefix}_{hname}'
                             f'{{session="{_prom_escape(str(band))}",'
                             f'q="{tag}"}} {p.get(tag, 0.0)}')
    # per-host gray-failure health rows (DESIGN.md §24): numeric
    # state (0 healthy / 1 degraded / 2 quarantined) + score as one
    # host-labeled family each, so alerting can key on max() directly
    hh = metrics.get("host_health")
    if hh:
        lines.append(f"# TYPE {prefix}_host_health_state gauge")
        for row in hh:
            st = row.get("state", "healthy")
            code = st if isinstance(st, int) else \
                {"healthy": 0, "degraded": 1, "quarantined": 2}.get(st, 0)
            lines.append(f'{prefix}_host_health_state'
                         f'{{host="{row.get("host", 0)}"}} {code}')
        lines.append(f"# TYPE {prefix}_host_health_score gauge")
        for row in hh:
            lines.append(f'{prefix}_host_health_score'
                         f'{{host="{row.get("host", 0)}"}} '
                         f'{row.get("score", 0)}')
    pct = metrics.get("percentiles", {})
    if pct:
        lines.append(f"# TYPE {prefix}_latency_us gauge")
        for hname in sorted(pct):
            for tag in PCT_TAGS:
                v = pct[hname].get(tag, 0.0)
                lines.append(f'{prefix}_latency_us'
                             f'{{hist="{_prom_escape(hname)}",'
                             f'q="{tag}"}} {v}')
    return "\n".join(lines) + "\n"
