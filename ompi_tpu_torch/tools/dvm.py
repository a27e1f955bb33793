"""tpu-dvm: the resident pool — a persistent, multiplexed service plane
for jobs.

Port of the reference's ``ompi_tpu/tools/dvm.py`` (a re-design of
orte-dvm, ref: orte/tools/orte-dvm/orte-dvm.c:1 — start the runtime
once, run many jobs against the warm daemons).  One resident pool
process owns the cards and runs each submitted job as rank-threads
inside it (the hostrun execution model).  Across jobs the pool retains:

  * the CUDA context and the devices, initialised once (``--devices
    auto`` gives session rank r the card ``r % count``),
  * the kernel libraries (kernels/build.py loads each once a process;
    a later session builds and loads nothing),
  * imported modules (no interpreter warm-up).

Jobs are NOT serialized: a client ATTACHes a session (np rank-threads,
brought up and left resident), RUNs one or more programs against it,
and DETACHes.  Many sessions are resident at once, sharing the cards:

  * admission control — rank-capacity accounting plus a bounded
    priority wait queue (dvm_queue_max) with immediate-reject
    backpressure, preemption of preemptible sessions by a
    higher-priority attach, and deadline shedding,
  * isolation — each session gets a cid band (state.cid_band), a KV
    namespace on ONE shared long-lived KV server (KVClient ns=...),
    per-session stdout/argv capture (thread-local proxies, never a
    process-global sys.stdout swap), and a SessionRTE whose abort
    poisons only its own world + namespace (never os._exit),
  * sharing — small fused batches from concurrently resident sessions
    can ride ONE combined kernel launch (coll/fusion's cross-session
    batcher, dvm_batch_window_us: one K3 a group for every session's
    slots).

Session programs call ompi_tpu_torch.init()/finalize() unchanged: init
finds the pre-initialized resident world (warm attach) and finalize
degrades to a flush+fence run boundary (state.serve_resident), keeping
the world warm for the next run.

Usage:
    python -m ompi_tpu_torch.tools.dvm --np 8 --uri-file /tmp/dvm.uri &
    python -m ompi_tpu_torch.tools.mpirun --dvm /tmp/dvm.uri -np 8 app.py
    python -m ompi_tpu_torch.tools.dvm --halt /tmp/dvm.uri

``--devices auto`` (the default) needs a CUDA card and exits non-zero
before any session is brought up when there is none; ``--devices cpu``
puts every rank on the CPU (the kernels' plain versions), ``--devices
none`` gives the ranks no device (host-only collectives).

``{uri-file}.proctable.json`` maps every resident session rank to its
pool pid/thread.

Host failure domains (``--hosts N``): the pool models N hosts.  Session
ranks band contiguously onto them (rank r on host ``r * N // np``, its
``node_id``); a ``tpud --fleet URI --host H`` agent a host registers and
beats on the pool port, and silence past the grace horizon, a
``--kill-host H`` or the ft_inject ``host_kill`` fault fails every
resident rank of the host as ONE ULFM failure record.  ``--respawn-host
H`` rejoins it and reports its MTTR.  Session journal records federate
across per-host files (``{uri}.journal.h{H}.jsonl``) under one
incarnation, and a health plane (obs/health) scores live hosts from
their beats and degrades, quarantines and drains the slow ones.  The
domains are failure domains of this one pool process: a session rank's
device is ``devices[r % len(devices)]`` whatever its host.
"""
from __future__ import annotations

import argparse
import collections
import faulthandler
import io
import itertools
import json
import os
import signal
import socket
import struct
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Dict, List, Optional
from ompi_tpu_torch import obs as _obs
from ompi_tpu_torch import trace
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.obs import reqtrace as _reqtrace

_session_max_var = registry.register(
    "dvm", "", "session_max", 8, int,
    help="Most sessions concurrently resident in one DVM pool; an "
         "attach beyond it queues (or rejects, see dvm_queue_max) "
         "even when rank capacity remains")
_queue_max_var = registry.register(
    "dvm", "", "queue_max", 16, int,
    help="Bounded FIFO admission queue: attaches that cannot be "
         "admitted wait here; beyond this depth they are rejected "
         "immediately (backpressure, never unbounded memory)")
_hb_var = registry.register(
    "dvm", "", "heartbeat_s", 2.0, float,
    help="Pool-to-client heartbeat period while a request is in "
         "flight; a client that misses ~3 beats declares the pool "
         "dead instead of hanging forever")
_drain_var = registry.register(
    "dvm", "", "drain_timeout_s", 30.0, float,
    help="Halt waits this long for in-flight runs to finish before "
         "force-detaching their sessions")
_queue_timeout_var = registry.register(
    "dvm", "", "queue_timeout_s", 0.0, float,
    help="Server-side deadline for queued attaches that gave no "
         "timeout of their own: past it the waiter gets a friendly "
         "DvmBusy (retry later) instead of parking forever "
         "(0 = park until capacity or client timeout)")
_ctrl_var = registry.register(
    "dvm", "", "ctrl", 0, int,
    help="Enable the FleetController closed loop (serve/controller): "
         "queue-depth-driven pool resizes and adaptive deadline-shed "
         "margins")
_ctrl_max_var = registry.register(
    "dvm", "", "ctrl_max_ranks", 0, int,
    help="Capacity ceiling the FleetController may grow the pool to "
         "(0 = 4x the starting capacity)")

_pv_active = registry.register_pvar(
    "dvm", "", "sessions_active", var_class="level",
    help="Sessions currently resident in the pool")
_pv_peak = registry.register_pvar(
    "dvm", "", "sessions_peak", var_class="highwatermark",
    help="Most sessions ever concurrently resident")
_pv_qdepth = registry.register_pvar(
    "dvm", "", "queue_depth", var_class="level",
    help="Attaches currently parked in the admission queue")
_pv_qpeak = registry.register_pvar(
    "dvm", "", "queue_peak", var_class="highwatermark",
    help="Deepest the admission queue has been")
_pv_rejects = registry.register_pvar(
    "dvm", "", "rejects",
    help="Attaches rejected (wait=False while busy, queue full, or "
         "queue-wait timeout)")
_pv_attaches = registry.register_pvar(
    "dvm", "", "attaches",
    help="Sessions successfully attached (world brought up resident)")
_pv_preempts = registry.register_pvar(
    "dvm", "", "preemptions",
    help="Sessions preempted by a higher-priority attach (parked and "
         "transparently resumed — never a failed job)")
_pv_sheds = registry.register_pvar(
    "dvm", "", "sheds",
    help="Runs shed at admission: the wall-time estimator said the "
         "deadline was infeasible (fast typed reject, no pool time "
         "spent)")
_pv_resizes = registry.register_pvar(
    "dvm", "", "resizes",
    help="Live pool capacity changes applied (grow or shrink), each "
         "opening a new pool epoch")
# host failure domains: the fleet-granularity liveness counters
_pv_hosts_active = registry.register_pvar(
    "fleet", "", "hosts_active", var_class="level",
    help="Live failure domains (hosts) currently backing the fleet")
_pv_hosts_lost = registry.register_pvar(
    "fleet", "", "hosts_lost",
    help="Whole-host failures declared (heartbeat silence past the "
         "grace horizon, or host_kill chaos) — each one atomic ULFM "
         "domain record, never N racing per-rank detections")
# session-banded (ompi_tpu_torch/obs): a pool serves many tenants; global
# reads through the registry stay O(1), per-session values come from
# the metrics RPC only
_pv_jobs = _obs.scoped_pvar(
    "dvm", "", "jobs",
    help="Programs run to completion against resident sessions")
_pv_job_wall_us = _obs.scoped_pvar(
    "dvm", "", "job_wall_us",
    help="Wall microseconds spent running programs (dispatch-to-exit, "
         "summed; per-session via the metrics RPC)")
_pv_queue_wait_us = _obs.scoped_pvar(
    "dvm", "", "queue_wait_us",
    help="Microseconds attaches spent parked in the admission queue "
         "(summed; per-session via the metrics RPC)")
_pv_attach_us_max = registry.register_pvar(
    "dvm", "", "attach_us_max", var_class="highwatermark",
    help="Slowest session attach (microseconds, queue wait included)")
_attach_hist: List[int] = [0] * trace.N_BUCKETS
_pv_attach_hist = registry.register_pvar(
    "dvm", "", "attach_hist", var_class="size",
    help="Session-attach latency histogram (log2 us buckets, bounds "
         "in trace_hist_bucket_bounds_us)",
    getter=lambda: list(_attach_hist))
# per-session SLI gauges: the request-scoped health triple a fleet
# operator reads per tenant — queue-wait distribution
# (p99 via the banded histogram), preemptions suffered, and goodput
# (wall microseconds of SUCCESSFUL runs; failed-run wall is burned
# pool time, not service delivered)
_pv_sli_qwait = _obs.scoped_hist("dvm_sli_queue_wait_us")
_pv_sli_preempts = _obs.scoped_pvar(
    "dvm", "sli", "preempts",
    help="Preemptions suffered by resident sessions (summed; "
         "per-session via the metrics RPC)")
_pv_sli_goodput = _obs.scoped_pvar(
    "dvm", "sli", "goodput_us",
    help="Wall microseconds of successful (code 0) runs — the "
         "goodput half of job_wall_us (summed; per-session via the "
         "metrics RPC)")


class DvmError(RuntimeError):
    """Service-plane error with a client-worthy message."""

    busy = False


class DvmBusy(DvmError):
    """Admission backpressure: the pool rejected the attach."""

    busy = True


class DvmDeadline(DvmError):
    """Deadline shed: the pool's wall-time estimator says this run
    cannot finish inside the client's deadline, so it was rejected at
    admission — fast and typed, before any rank-thread was spent."""

    shed = True


class DvmDisconnect(DvmError):
    """The pool connection died mid-request.  Retryable: a client
    holding a session token reconnects (polling the uri file, which a
    supervisor-respawned server rewrites), reattaches by token, and
    replays the in-flight run under its original jobid — the server
    dedups against its journal, so the job runs exactly once."""


def _integrity_snapshot() -> list:
    """Process-global sdc conviction rows for doctor reports."""
    from ompi_tpu_torch.obs import integrity as _integrity
    return _integrity.convicted_snapshot()


def _kernel_state():
    """({wrapper: launches}, [loaded kernel libraries]) of this process:
    the count every kernel wrapper of ``ompi_tpu_torch.kernels`` keeps
    in its ``launches`` attribute (the counters the chip checks read)
    and the libraries kernels/build.py has loaded.  Read only from
    kernel modules already imported (a pool that ran nothing on a card
    imports none)."""
    launches: Dict[str, int] = {}
    for mod_name, mod in list(sys.modules.items()):
        if not mod_name.startswith("ompi_tpu_torch.kernels.") or mod is None:
            continue
        for name, obj in list(vars(mod).items()):
            c = getattr(obj, "launches", None) if callable(obj) else None
            if c is not None and hasattr(c, "value"):
                launches[name] = c.value
    b = sys.modules.get("ompi_tpu_torch.kernels.build")
    libs = sorted(getattr(b, "_libs", {})) if b is not None else []
    return launches, libs


def _send(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv(sock: socket.socket) -> Optional[dict]:
    hdr = b""
    while len(hdr) < 4:
        c = sock.recv(4 - len(hdr))
        if not c:
            return None
        hdr += c
    (ln,) = struct.unpack(">I", hdr)
    data = b""
    while len(data) < ln:
        c = sock.recv(ln - len(data))
        if not c:
            return None
        data += c
    return json.loads(data)


# -- per-session stdio/argv (thread-local, never a global swap) -------------

class _SessionBuf:
    """One run's captured output: shared by all its rank-threads."""

    def __init__(self) -> None:
        self._buf = io.StringIO()
        self._lock = threading.Lock()

    def write(self, s: str) -> None:
        with self._lock:
            self._buf.write(s)

    def value(self) -> str:
        with self._lock:
            return self._buf.getvalue()


# Overlay state lives in MODULE-level TLS, not on proxy instances: a
# host (pytest capture, user tooling) may swap sys.stdout at any time,
# so the proxy that happens to be installed when a rank-thread writes
# need not be the one that was installed when the run began.
_stdio_tls = threading.local()
_stdio_lock = threading.Lock()


class _ThreadStdio(io.TextIOBase):
    """Per-thread stdout/stderr overlay for the pool process.
    Rank-threads of a run register their session's capture buffer in
    thread-local state; every other thread (the pool's own logging,
    user helper threads) falls through to the real stream.  This is
    what lets two concurrent sessions print without seeing each
    other's output — the old process-global sys.stdout swap could
    not."""

    def __init__(self, real, kind: str) -> None:
        self.real = real
        self.kind = kind  # "out" | "err"

    def write(self, s: str) -> int:
        sink = getattr(_stdio_tls, self.kind, None)
        if sink is not None:
            sink.write(s)
        self.real.write(s)
        return len(s)

    def flush(self) -> None:
        self.real.flush()


class _ThreadArgv(list):
    """sys.argv proxy: rank-threads see their run's [prog, *args],
    everyone else sees the pool's own argv.  A real list subclass so
    argparse/slicing in user programs work unchanged."""

    def __init__(self, base) -> None:
        super().__init__(base)

    @staticmethod
    def _cur():
        return getattr(_stdio_tls, "argv", None)

    def __getitem__(self, i):
        o = self._cur()
        return o[i] if o is not None else list.__getitem__(self, i)

    def __len__(self):
        o = self._cur()
        return len(o) if o is not None else list.__len__(self)

    def __iter__(self):
        o = self._cur()
        return iter(o) if o is not None else list.__iter__(self)

    def __repr__(self):
        o = self._cur()
        return repr(o) if o is not None else list.__repr__(self)


def _ensure_stdio() -> None:
    """Idempotently wrap the CURRENT sys.stdout/stderr/argv with the
    per-thread overlays.  Called before every run, not just at pool
    start: hosts (pytest capture) swap sys.stdout under us, and an
    overlay that is no longer installed captures nothing.  Overlays
    pass writes through when no thread-local sink is set, so leaving
    one installed is always harmless."""
    with _stdio_lock:
        if not isinstance(sys.stdout, _ThreadStdio):
            sys.stdout = _ThreadStdio(sys.stdout, "out")
        if not isinstance(sys.stderr, _ThreadStdio):
            sys.stderr = _ThreadStdio(sys.stderr, "err")
        if not isinstance(sys.argv, _ThreadArgv):
            sys.argv = _ThreadArgv(sys.argv)



def _restore_stdio() -> None:
    """Undo ``_ensure_stdio``: put back the streams and argv the
    overlays wrap (an embedded pool's ``stop()``; a host that swapped
    its own stream over an overlay keeps it)."""
    with _stdio_lock:
        while isinstance(sys.stdout, _ThreadStdio):
            sys.stdout = sys.stdout.real
        while isinstance(sys.stderr, _ThreadStdio):
            sys.stderr = sys.stderr.real
        if isinstance(sys.argv, _ThreadArgv):
            sys.argv = list(list.__iter__(sys.argv))


def _stdio_push(out: _SessionBuf, err: _SessionBuf,
                argv: List[str]) -> None:
    _stdio_tls.out = out
    _stdio_tls.err = err
    _stdio_tls.argv = argv


def _stdio_pop() -> None:
    _stdio_tls.out = None
    _stdio_tls.err = None
    _stdio_tls.argv = None


# -- session runtime --------------------------------------------------------


def _make_session_rte():
    """SessionRTE built lazily: the client half of this module (mpirun
    --dvm, --halt) must import without touching the runtime stack."""
    from ompi_tpu_torch.runtime.rte import HybridRTE

    class SessionRTE(HybridRTE):
        """Abort confined to the session.  EnvRTE.abort os._exit()s —
        correct for a process-rank, fatal for a POOL hosting other
        sessions.  Here a failing rank poisons its own world and KV
        namespace (releasing peers parked in fences/rendezvous of
        THIS session only) and unwinds just its rank-thread."""

        def abort(self, code: int, msg: str = "") -> None:
            if self.world.aborted is None:
                self.world.aborted = (self.rank, code, msg)
            for st in self.world.states:
                if st is not None and getattr(st, "progress",
                                              None) is not None:
                    st.progress.wakeup()
            try:
                self.kv.abort(self.rank, code, msg)
            except OSError:
                pass
            sys.stderr.write(
                f"[dvm session rank {self.rank}] abort({code}): {msg}\n")
            raise SystemExit(code or 1)

    return SessionRTE


class _Journal:
    """Write-ahead session journal: the DVM analog of the KV
    replication stream (docs/DESIGN.md §20).  One JSONL record per
    control-plane transition — attach / run (WAL, before the program
    starts) / run_done / detach / pool epoch / quota snapshot — living
    NEXT TO the uri file, so a restarted server rehydrates its session
    table from disk exactly like the KV standby rebuilds fences from
    replicated arrivals.

    Durability policy: records that a crash must not lose (the run WAL
    — it is what makes an in-flight jobid provably in-flight) are
    flushed synchronously; bookkeeping records ride the buffered file
    and are flushed by ``tick()`` from the heartbeat loop (and within
    one hb period at the latest).  ``tick`` is allocation-free when
    nothing is pending — it is audited as a progress-sweep hook
    (tools/hotpath_audit)."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=65536)
        self._dirty = False

    def append(self, rec: dict, sync: bool = False) -> None:
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.write(line)
                if sync:
                    self._f.flush()
                    self._dirty = False
                else:
                    self._dirty = True
            except OSError:
                pass  # a full disk must never take the pool down

    def tick(self) -> None:
        """Flush buffered records; no-op (and no allocation) when
        clean.  Called from the pool heartbeat loop."""
        if not self._dirty:
            return
        with self._lock:
            if self._f is None or not self._dirty:
                return
            try:
                self._f.flush()
            except OSError:
                pass
            self._dirty = False

    def rewrite(self, records: List[dict]) -> None:
        """Compaction: replace the journal with just the records that
        still matter (done at rehydration, so the file never grows
        across restarts)."""
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                for rec in records:
                    f.write(json.dumps(rec, separators=(",", ":"))
                            + "\n")
            os.replace(tmp, self.path)
            self._f = open(self.path, "a", buffering=65536)
            self._dirty = False

    def close(self, delete: bool = False) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    self._f.close()
                except OSError:
                    pass
                self._f = None
            if delete:
                try:
                    os.unlink(self.path)
                except OSError:
                    pass

    @staticmethod
    def load(path: str) -> List[dict]:
        """Read every intact record; a torn tail line (killed mid-
        write) is ignored, records before it are good — append-only
        JSONL has no other failure mode."""
        out: List[dict] = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        break
        except OSError:
            pass
        return out


class _Session:
    def __init__(self, sid: int, np_: int, conn) -> None:
        self.sid = sid
        self.np = np_
        self.ns = f"s{sid}"
        self.jobid = f"dvm-{os.getpid()}-s{sid}"
        self.conn = conn  # owning client connection (auto-detach on close)
        self.dir = ""
        self.world: Any = None
        self.states: List[Any] = []
        self.lock = threading.Lock()
        self.running = False
        self.dead = False
        self.detaching = False
        # legacy one-shot (submit) warm cache: True while this
        # session sits resident between submits, claimable by the
        # next same-np submit and evictable under capacity pressure
        self.legacy_idle = False
        # serving control plane: admission priority, and
        # whether a higher-priority attach may preempt this session.
        # A preempted session is PARKED — world torn down, ranks
        # released, sid/ns/jobid kept — and transparently re-admitted
        # and resumed (its program restores from checkpoint), never
        # failed.
        self.priority = 0
        self.preemptible = False
        self.parked = False
        # True from journal rehydration until the owner's first
        # resume (or a detach): the controller must not read the
        # recovering pool as idle while these wait for their clients
        self.rehydrated = False
        self.preempt_requested = False
        self.preempt_count = 0
        self.epoch = 0  # pool epoch at (re)admission — cid-bands
        #                 derived comms per resize epoch (ft/respawn)
        # health-plane placement override: rank -> host band stamped
        # at _bringup when any domain is degraded, quarantined or
        # dead.  None = the static contiguous banding.
        self.placement: Optional[List[int]] = None
        # crash recovery (DESIGN.md §20): the reattach credential, the
        # jobid->exit-code dedup memory for replayed runs, and the
        # set of jobids whose run WAL has no run_done (in flight at a
        # crash — the client must resubmit them)
        self.token = os.urandom(8).hex()
        self.completed: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()
        self.wal_jobs: set = set()
        # request trace context (DESIGN.md §23): minted client-side at
        # attach (obs_reqtrace_enable), carried by every run RPC.
        # 0 = untraced.  span is the parent span of the CURRENT run.
        self.tid = 0
        self.span = 0
        # progress-stall watchdog state: perf_counter_ns at run start
        # (0 = no run in flight) and a per-run one-shot latch so one
        # stalled run fires exactly one doctor capture
        self.run_start_ns = 0
        self.wd_fired = False

    def remember_done(self, jobid: str, code: int) -> None:
        self.completed[jobid] = code
        while len(self.completed) > 64:  # bounded replay memory
            self.completed.popitem(last=False)


class _Waiter:
    def __init__(self, np_: int, conn, priority: int = 0,
                 preemptible: bool = False,
                 resume: Optional[_Session] = None) -> None:
        self.np = np_
        self.conn = conn
        self.priority = priority
        self.preemptible = preemptible
        # re-admission of a parked (preempted) session: _pump hands
        # back THIS session object — same sid/ns — instead of minting
        # a new one
        self.resume = resume
        self.event = threading.Event()
        self.sess: Optional[_Session] = None
        self.error: Optional[str] = None
        self.abandoned = False


class _Conn:
    """One client connection: serialized sends (the reply writer and
    the heartbeat ticker share the socket) and a busy counter so the
    ticker only beats while a request is actually in flight."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.send_lock = threading.Lock()
        self.busy = 0
        self.dead = False
        self.agent_pid = 0  # set when this conn is a tpud host agent

    def reply(self, obj: dict) -> None:
        with self.send_lock:
            _send(self.sock, obj)


class DVMServer:
    """The resident pool: accept loop + admission control + session
    lifecycle.  Embeddable (tests: .start()/.stop()) or CLI-driven
    (.serve_forever()).

    ``devices`` is the list of devices the sessions' ranks take in turn
    (rank r gets ``devices[r % len(devices)]``: ``[torch.device("cuda",
    0)]`` puts every rank of a session on card 0, the coll/hbm tier;
    ``[torch.device("cpu")]`` is the CPU with the kernels' plain
    versions), or None for host-only ranks.  ``hosts`` is the number
    of host failure domains the session ranks band onto (rank r of a
    session of np on host ``r * hosts // np``)."""

    def __init__(self, capacity: int, devices=None,
                 uri_file: Optional[str] = None,
                 hosts: int = 1) -> None:
        self.capacity = capacity
        self.devices = list(devices) if devices else None
        self.uri_file = uri_file
        self.lock = threading.Lock()
        self._pt_lock = threading.Lock()  # serializes proctable writes
        self.sessions: Dict[int, _Session] = {}
        self.active_ranks = 0
        self._waiters: collections.deque = collections.deque()
        self._sid_counter = itertools.count(1)
        self._conns: set = set()
        self._jobs = 0
        # serving control plane
        self.pool_epoch = 0      # bumped per live resize
        self.est_wall_us = 0     # EWMA of run wall time (shed input)
        self.ctrl: Any = None    # FleetController when dvm_ctrl=1
        self._draining = False
        self._halted = False
        self._started = False
        self._accept_thread: Optional[threading.Thread] = None
        self.kv_server: Any = None
        self.listener: Optional[socket.socket] = None
        self.port = 0
        # crash recovery: every server life gets a fresh incarnation id
        # (published in the uri doc, so clients detect a restart behind
        # a reused endpoint), a session journal when uri_file is set,
        # and — armed only for real subprocess servers (serve()) — the
        # dvm_kill chaos injector
        self.incarnation = os.urandom(6).hex()
        self._journal: Optional[_Journal] = None
        self._kill: Any = None
        self.rehydrated = 0
        # hang doctor: sids flagged by the audited watchdog tick
        # (collected off-path), and the in-process verdict documents
        # tests/tools read without touching disk
        self._wd_hits: List[int] = []
        self.doctor_reports: List[dict] = []
        # rehydrated sessions still parked (no client resumed them
        # yet): read by FleetController.tick as a shrink inhibitor —
        # a just-recovered pool with zero active ranks is NOT idle
        self.rehydrated_parked = 0
        self._stdio = False
        # host failure domains: the pool models `hosts` domains.
        # Resident ranks band onto them contiguously (_bringup stamps
        # the band as the rank's node_id), session journal records
        # federate across per-host files under ONE incarnation id, and
        # a per-host liveness plane (tpud host agents beating over the
        # pool port) turns silence into one atomic domain record.
        # All-int preallocated state: _host_tick scans it on the
        # audited hot path.
        self.hosts = max(1, int(hosts))
        self._host_beat = [0] * self.hosts     # last beat ns (0 = no agent)
        self._host_dead = [0] * self.hosts     # 1 = lost domain
        self._host_pending = [0] * self.hosts  # silence marks to collect
        self._host_lost_ns = [0] * self.hosts  # MTTR clock starts
        self._host_grace_ns = 0
        self._host_agents: Dict[int, Any] = {}
        self._host_lost_sids: Dict[int, List[int]] = {}
        self._hjournals: List[Optional[_Journal]] = [None] * self.hosts
        self._hkill: Any = None
        self._sdc_hook: Any = None
        # lost domains not yet replaced: read by FleetController.tick
        # as a shrink inhibitor (a fleet mid-rehydration is not idle)
        self.hosts_rehydrating = 0
        # gray-failure health plane (obs/health): scores slow-but-alive
        # domains and drives the degrade/quarantine ladder.  None on
        # one-host pools and when health_enable=0 — every consumer
        # null-checks.
        self.health: Any = None
        # last health state _health_collect applied per host: the
        # delta against HealthPlane.state tells escalation from
        # recovery when transitions are drained
        self._health_applied = [0] * self.hosts

    # -- lifecycle ---------------------------------------------------------

    def _setup(self) -> None:
        if self._started:
            return
        # arm the serving-plane quota tap first (per-band HBM
        # attribution is useful telemetry even with no budget set;
        # budgets only bite when dvm_quota_hbm_bytes is nonzero): it
        # refuses a quota the port cannot honor before the pool binds
        # or publishes anything
        from ompi_tpu_torch.serve import quota as _squota
        _squota.install()
        self._started = True
        from ompi_tpu_torch.runtime.kvstore import KVServer
        # a fleet homes the KV primary on host 0 and places the hot
        # standby on host 1 (a standby sharing the primary's host dies
        # with it on a host kill)
        self.kv_server = KVServer(
            self.capacity, host_id=0,
            standby_host=1 if self.hosts > 1 else None)
        from ompi_tpu_torch.runtime import oob as _oob
        self._host_grace_ns = int(
            (3.0 * max(0.2, _hb_var.value)
             + max(0.0, _oob.host_grace_var.value)) * 1e9)
        if self.hosts > 1:
            # host_kill is in-process safe (no os._exit): embedded
            # pools arm it too, unlike dvm_kill
            from ompi_tpu_torch import ft_inject as _fi
            self._hkill = _fi.host_kill_injector()
            from ompi_tpu_torch.obs import health as _health
            if _health._enable_var.value:
                # the expected beat interval mirrors the agent's own
                # pacing (tools/tpud beats at grace/6); the adaptive
                # grace floors at the static horizon computed above
                self.health = _health.HealthPlane(
                    self.hosts,
                    expect_beat_ns=max(50_000_000,
                                       self._host_grace_ns // 6),
                    floor_grace_ns=self._host_grace_ns)
                # a collective-integrity conviction on any resident
                # rank feeds the decisive per-host sdc signal: the next
                # health tick quarantines
                from ompi_tpu_torch.obs import integrity as _integrity
                hp = self.health

                def _on_sdc(rec, _hp=hp):
                    _hp.note_sdc(int(rec.get("host", 0)))

                self._sdc_hook = _on_sdc
                _integrity.install_convict_hook(_on_sdc)
        _pv_hosts_active.add(self.hosts)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("127.0.0.1", 0))
        self.listener.listen(16)
        self.port = self.listener.getsockname()[1]
        if self.uri_file:
            # rehydrate BEFORE publishing the uri: a reconnecting
            # client must never reattach into a half-rebuilt table
            self._rehydrate(f"{self.uri_file}.journal.jsonl")
            tmp = self.uri_file + ".tmp"
            with open(tmp, "w") as f:
                # line 1 stays bare host:port; line 2 is the
                # incarnation doc clients use to detect a restart
                # behind the same endpoint
                f.write(f"127.0.0.1:{self.port}\n")
                f.write(json.dumps({"incarnation": self.incarnation,
                                    "pid": os.getpid()}) + "\n")
            os.replace(tmp, self.uri_file)  # submitters never see a torn file
        _ensure_stdio()
        self._stdio = True
        if _ctrl_var.value:
            from ompi_tpu_torch.serve.controller import FleetController
            ceil = _ctrl_max_var.value or self.capacity * 4
            self.ctrl = FleetController(self, floor=self.capacity,
                                        ceil=ceil)
        self._write_proctable()
        try:
            # debugger attach support: SIGUSR1 dumps EVERY pool thread
            # (all resident session ranks)
            faulthandler.register(signal.SIGUSR1, all_threads=True,
                                  chain=True)
        except (AttributeError, ValueError, OSError):
            pass  # non-main thread or unsupported platform
        threading.Thread(target=self._hb_loop, daemon=True,
                         name="dvm-hb").start()
        if _obs.watchdog_ms() > 0:
            # progress-stall watchdog: its own thread, NOT the
            # heartbeat loop — detection latency is bounded by
            # 2·obs_watchdog_ms, far below the 2 s heartbeat period
            threading.Thread(target=self._wd_loop, daemon=True,
                             name="dvm-watchdog").start()
        devs = ("none" if not self.devices else
                ", ".join(sorted({str(d) for d in self.devices})))
        sys.stderr.write(
            f"tpu-dvm: ready on 127.0.0.1:{self.port} "
            f"(capacity {self.capacity} ranks, "
            f"sessions<={_session_max_var.value}, "
            f"queue<={_queue_max_var.value}, devices {devs})\n")

    def start(self) -> "DVMServer":
        self._setup()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="dvm-accept")
        self._accept_thread.start()
        return self

    def serve_forever(self) -> int:
        self._setup()
        self._accept_loop()
        return 0

    def stop(self) -> None:
        self._drain()
        if self._sdc_hook is not None:
            from ompi_tpu_torch.obs import integrity as _integrity
            _integrity.remove_convict_hook(self._sdc_hook)
            self._sdc_hook = None
        # orderly stop == clean halt: drop the journals, nothing
        # should rehydrate from an intentional shutdown
        self._close_journals()
        if self._started:
            _pv_hosts_active.add(-(self.hosts - sum(self._host_dead)))
        self._halted = True
        self._close_listener()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=10)
        if self.kv_server is not None:
            self.kv_server.close()
        if self._stdio:
            # an embedded pool hands the host its own streams back
            _restore_stdio()
            self._stdio = False

    def _close_listener(self) -> None:
        """Close the listener so a blocked accept() wakes up.  On
        Linux close() alone does NOT interrupt a thread parked in
        accept(); shutdown() first makes it return EINVAL."""
        if self.listener is None:
            return
        try:
            self.listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.listener.close()
        except OSError:
            pass

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    # -- accept / client loops ---------------------------------------------

    def _accept_loop(self) -> None:
        while not self._halted:
            try:
                sock, _ = self.listener.accept()
            except OSError:
                break
            conn = _Conn(sock)
            with self.lock:
                self._conns.add(conn)
            threading.Thread(target=self._client, args=(conn,),
                             daemon=True, name="dvm-client").start()


    def _hb_loop(self) -> None:
        while not self._halted:
            time.sleep(max(0.2, _hb_var.value))
            with self.lock:
                conns = list(self._conns)
            swept = False
            for c in conns:
                if c.busy > 0 and not c.dead:
                    try:
                        c.reply({"event": "hb"})
                    except OSError:
                        c.dead = True
                if c.dead:
                    swept = True
            if swept:
                # a dead client's queued attach must not hold its
                # place in line: wake the waiter (its thread marks
                # itself abandoned / fails the reply) and re-pump so
                # the session parked BEHIND it is admitted now, not
                # at the next capacity change
                with self.lock:
                    for w in self._waiters:
                        if (w.conn.dead and not w.abandoned
                                and w.sess is None and w.error is None):
                            w.abandoned = True
                            w.error = "client connection lost"
                            w.event.set()
                self._pump()
            # host liveness plane: the audited tick only MARKS silent
            # domains; declaration (allocating, socket-touching) runs
            # here, off any hot path
            if self.hosts > 1 \
                    and self._host_tick(time.perf_counter_ns()):
                self._host_collect()
            # gray-failure plane: same split — the audited score and
            # hysteresis tick latches transitions, the cold collect
            # applies the mitigation ladder (the skew corroboration
            # sample is cold too: pure reads)
            hp = self.health
            if hp is not None:
                self._health_sample(hp)
                if hp.tick(time.perf_counter_ns()):
                    self._health_collect()
            ctrl = self.ctrl
            if ctrl is not None:
                # idle-pool coverage: rank-threads only tick the
                # controller DURING runs; the heartbeat keeps the
                # loop deciding (and applies its decisions, which
                # must stay off the rank hot path) while none run
                ctrl.tick(time.perf_counter_ns())
                ctrl.apply()
            for j in [self._journal] + self._hjournals:
                if j is not None:
                    j.tick()  # flush buffered bookkeeping records

    def _client(self, conn: _Conn) -> None:
        owned: List[int] = []
        try:
            while not self._halted:
                try:
                    msg = _recv(conn.sock)
                except OSError:
                    break
                if msg is None:
                    break
                try:
                    if self._dispatch(conn, msg, owned):
                        break  # halt
                except DvmError as e:
                    try:
                        conn.reply({"error": str(e), "busy": e.busy,
                                    "shed": getattr(e, "shed", False)})
                    except OSError:
                        break
                except OSError:
                    break
                except Exception as e:  # noqa: BLE001 — a bad request
                    # must never take the pool's client loop down
                    try:
                        conn.reply({"error": f"{type(e).__name__}: "
                                             f"{str(e)[:300]}"})
                    except OSError:
                        break
        finally:
            with self.lock:
                self._conns.discard(conn)
            # client death is a detach: a dying submitter must never
            # strand its sessions' ranks (or poison anyone else's).
            # force=True: the owner is gone, nobody else may detach
            # these sids (dispatch is serial per connection, so no run
            # of ours can still be in flight here).  A session whose
            # owner RE-BOUND it by token (reattach on a fresh
            # connection) is skipped — ownership moved, this dead
            # socket no longer speaks for it.
            for sid in owned:
                with self.lock:
                    sess = self.sessions.get(sid)
                    if sess is not None and sess.conn is not conn:
                        continue
                try:
                    self._detach(sid, force=True)
                except DvmError:
                    pass
            try:
                conn.sock.close()
            except OSError:
                pass

    def _dispatch(self, conn: _Conn, msg: dict,
                  owned: List[int]) -> bool:
        op = msg.get("op")
        if self._kill is not None and self._kill.op():
            # chaos (ft_inject dvm_kill): hard process death at the
            # armed op count — no journal flush, no reply, no
            # teardown; exactly what SIGKILL leaves behind.  Armed
            # only on real subprocess servers (serve()).
            sys.stderr.write("tpu-dvm: ft_inject dvm_kill — dying at "
                             f"op {op}\n")
            sys.stderr.flush()
            os._exit(70)
        if self._hkill is not None and op != "host_beat" \
                and self._hkill.op():
            # chaos (ft_inject host_kill): deterministic whole-host
            # sever at the armed op count — the victim domain's agent,
            # KV endpoint and resident ranks all die as one record.
            # The agents' beats are not counted (the reference counts
            # them): they arrive on the wall clock, and counting them
            # would make the kill point depend on time
            from ompi_tpu_torch import ft_inject as _fi
            self.kill_host(_fi.host_kill_victim())
        if op == "halt":
            conn.busy += 1
            try:
                jobs = self._drain()
            finally:
                conn.busy -= 1
            _obs.record_event(_obs.EV_DVM_HALT, len(self.sessions), jobs)
            self._persist_events("halt")
            # clean halt: nothing to rehydrate — a journal (the pool's
            # or a host's) left behind would resurrect sessions nobody
            # wants back
            self._close_journals()
            conn.reply({"ok": True, "jobs": jobs})
            sys.stderr.write(f"tpu-dvm: halt after {jobs} jobs\n")
            self._halted = True
            self._close_listener()
            return True
        if op == "ping":
            conn.reply({"ok": True, "pid": os.getpid(),
                        "capacity": self.capacity})
            return False
        if op == "stats":
            with self.lock:
                conn.reply({"ok": True, "sessions": len(self.sessions),
                            "active_ranks": self.active_ranks,
                            "queued": len(self._waiters),
                            "jobs": self._jobs,
                            "capacity": self.capacity,
                            "epoch": self.pool_epoch,
                            "hosts": self.hosts,
                            "hosts_lost": sum(self._host_dead),
                            "hosts_rehydrating":
                                self.hosts_rehydrating,
                            "hosts_degraded":
                                self.health.degraded_n
                                if self.health else 0,
                            "hosts_quarantined":
                                self.health.quarantined_n
                                if self.health else 0})
            return False
        if op == "host_register":
            # a tpud host agent (one per failure domain) announces
            # itself on the pool port and starts beating — silence past
            # the grace horizon marks the WHOLE domain lost (one
            # atomic ULFM record)
            h = int(msg.get("host", -1))
            if not 0 <= h < self.hosts:
                raise DvmError(f"host {h} outside fleet "
                               f"(hosts={self.hosts})")
            conn.agent_pid = int(msg.get("pid", 0))
            with self.lock:
                self._host_agents[h] = conn
                self._host_beat[h] = time.perf_counter_ns()
                self._host_dead[h] = 0
                self._host_pending[h] = 0
            conn.reply({"ok": True, "host": h,
                        "incarnation": self.incarnation,
                        "grace_s": self._host_grace_ns / 1e9})
            return False
        if op == "host_beat":
            h = int(msg.get("host", -1))
            if 0 <= h < self.hosts and self._host_dead[h] == 0:
                now = time.perf_counter_ns()
                self._host_beat[h] = now
                if self.health is not None:
                    # feeds the shared beat estimator: inter-arrival
                    # EWMA + jitter drive both the health score and
                    # the adaptive per-host liveness grace
                    self.health.note_beat(h, now)
            conn.reply({"ok": True})
            return False
        if op == "host_kill":
            h = int(msg.get("host", -1))
            conn.busy += 1
            try:
                self.kill_host(h)
            finally:
                conn.busy -= 1
            conn.reply({"ok": True, "host": h})
            return False
        if op == "host_respawn":
            h = int(msg.get("host", -1))
            conn.busy += 1
            try:
                mttr_ms = self.respawn_host(h)
            finally:
                conn.busy -= 1
            conn.reply({"ok": True, "host": h,
                        "mttr_ms": round(mttr_ms, 3)})
            return False
        if op == "resize":
            new_cap = int(msg.get("np", 0))
            conn.busy += 1
            try:
                old, epoch = self.resize(new_cap)
            finally:
                conn.busy -= 1
            conn.reply({"ok": True, "capacity": new_cap, "was": old,
                        "epoch": epoch})
            return False
        if op == "attach":
            np_ = int(msg.get("np", self.capacity))
            timeout = msg.get("timeout")
            conn.busy += 1
            try:
                sess, attach_us, queued_us = self._attach(
                    np_, conn, wait=bool(msg.get("wait", True)),
                    timeout=float(timeout) if timeout else None,
                    priority=int(msg.get("priority", 0)),
                    preemptible=bool(msg.get("preemptible", False)),
                    tid=int(msg.get("tid") or 0))
            finally:
                conn.busy -= 1
            owned.append(sess.sid)
            self._jrec({"t": "attach", "sid": sess.sid, "np": np_,
                        "prio": sess.priority,
                        "pre": sess.preemptible,
                        "token": sess.token}, sync=True)
            conn.reply({"ok": True, "sid": sess.sid, "np": np_,
                        "token": sess.token,
                        "incarnation": self.incarnation,
                        "hosts": self.hosts,
                        "attach_us": attach_us, "queued_us": queued_us})
            return False
        if op == "reattach":
            # crash recovery: a client re-binds its session (possibly
            # rehydrated by a NEW incarnation) by token, on a fresh
            # connection.  Replies with the jobids journaled as
            # in-flight at the crash — the client resubmits those.
            sid = int(msg.get("sid", -1))
            sess = self._session_for(sid)
            if msg.get("token") != sess.token:
                raise DvmError(f"reattach s{sid}: bad session token "
                               "(session belongs to someone else)")
            with self.lock:
                stale = sess.conn
                sess.conn = conn
            if stale is not None and stale is not conn:
                stale.dead = True  # the old owner connection, if any,
                # must not auto-detach this session when it reaps
            if sid not in owned:
                owned.append(sid)
            inflight = sorted(sess.wal_jobs)
            sess.wal_jobs = set()
            conn.reply({"ok": True, "sid": sid, "np": sess.np,
                        "incarnation": self.incarnation,
                        "inflight": inflight,
                        "parked": sess.parked})
            return False
        if op == "run":
            sid = int(msg.get("sid", -1))
            if sid not in owned:
                raise DvmError(f"unknown session s{sid} (not attached "
                               "on this connection)")
            sess = self._session_for(sid)
            jobid = msg.get("jobid")
            if jobid and jobid in sess.completed:
                # reconnect-with-replay dedup: this jobid already ran
                # to completion (the reply was lost with the old
                # connection) — acknowledge it, never run it twice
                code = sess.completed[jobid]
                _obs.record_event(_obs.EV_DVM_REPLAY, sid, code)
                conn.reply({"code": code, "stdout": "", "stderr": "",
                            "wall_s": 0.0, "replayed": True,
                            "preempted": sess.preempt_count})
                return False
            # request trace context (DESIGN.md §23): every run of a
            # session carries the attach-minted tid plus its own span
            # id — re-sent on every run so a token reattach onto a
            # rehydrated session restores the correlation key too
            tid = int(msg.get("tid") or 0)
            if tid:
                sess.tid = tid
            sess.span = int(msg.get("span") or 0)
            deadline_ms = msg.get("deadline_ms")
            if deadline_ms:
                self._shed_check(sess, int(deadline_ms))
            if jobid:
                # WAL before the program starts: a crash mid-run
                # leaves proof this jobid was in flight, so reattach
                # hands it back for resubmission
                self._jrec({"t": "run", "sid": sid, "jobid": jobid},
                           sync=True)
            conn.busy += 1
            try:
                code, out, err, wall = self._run(
                    sess, msg["prog"], msg.get("args") or [])
            finally:
                conn.busy -= 1
            if jobid:
                sess.remember_done(jobid, code)
                self._jrec({"t": "run_done", "sid": sid,
                            "jobid": jobid, "code": code})
            conn.reply({"code": code, "stdout": out, "stderr": err,
                        "wall_s": round(wall, 3),
                        "preempted": sess.preempt_count})
            return False
        if op == "detach":
            sid = int(msg.get("sid", -1))
            if sid not in owned:
                # mirror the run op: a connection may only detach
                # sessions IT attached — sids are small and monotonic,
                # and a cross-client detach would scrub a world whose
                # rank-threads another client is still driving
                raise DvmError(f"unknown session s{sid} (not attached "
                               "on this connection)")
            self._detach(sid)
            owned.remove(sid)
            conn.reply({"ok": True})
            return False
        if op == "submit":
            # legacy one-shot (mpirun --dvm): attach + run, serial-
            # pool reply shape.  The session stays RESIDENT between
            # submits (the second job's world, devices and fences are
            # all reused) — claimed by the next same-np submit,
            # evicted when an attach needs the ranks.
            np_ = int(msg.get("np", self.capacity))
            if np_ > self.capacity:
                conn.reply({"error": f"np {np_} exceeds DVM "
                                     f"capacity {self.capacity}"})
                return False
            deadline = msg.get("timeout")
            conn.busy += 1
            try:
                with self.lock:
                    sess = next(
                        (s for s in self.sessions.values()
                         if s.legacy_idle and s.np == np_
                         and not s.dead and not s.detaching), None)
                    if sess is not None:
                        sess.legacy_idle = False  # claimed
                if sess is None:
                    sess, _, _ = self._attach(
                        np_, conn, wait=True,
                        timeout=float(deadline) if deadline else 600.0)
                try:
                    code, out, err, wall = self._run(
                        sess, msg["prog"], msg.get("args") or [])
                finally:
                    with self.lock:
                        keep = (not sess.dead and not self._draining
                                and not any(not w.abandoned
                                            for w in self._waiters))
                        if keep:
                            sess.legacy_idle = True
                    if not keep:
                        self._detach(sess.sid)
            finally:
                conn.busy -= 1
            conn.reply({"code": code, "stdout": out, "stderr": err,
                        "wall_s": round(wall, 3)})
            return False
        if op == "metrics":
            conn.reply(self._metrics(
                events=int(msg.get("events", 16)),
                want_prom=msg.get("prometheus")))
            return False
        conn.reply({"error": "bad op"})
        return False

    # -- telemetry ---------------------------------------------------------

    def _metrics(self, events: int = 16,
                 want_prom: Optional[bool] = None) -> dict:
        """The live scrape: pvar registry snapshot, per-session
        attribution, latency histograms aggregated across resident
        ranks (read from each rank's scrape buffer — the ranks are
        never stopped), derived percentiles, the flight-recorder tail,
        and the kernel wrappers' launch counts and loaded kernel
        libraries (process-wide: every session's launches and loads).
        Runs on the pool's client thread; everything it reads is either
        generation-stamped (scrape buffers), lock-free append-only
        (pvar values), or snapshotted under the recorder lock."""
        from ompi_tpu_torch import mpit
        agg = [[0] * trace.N_BUCKETS for _ in trace.HIST_NAMES]
        scraped = 0
        sessions: Dict[str, dict] = {}
        with self.lock:
            items = list(self.sessions.items())
            queue_depth = len(self._waiters)
            active_ranks = self.active_ranks
        for sid, sess in items:
            row = {"np": sess.np, "dead": sess.dead}
            for sp in _obs.scoped_items():
                row[sp.full_name] = sp.read_band(sid)
            # derived SLI: per-tenant queue-wait p99 from the banded
            # histogram
            row["queue_wait_p99_us"] = \
                _pv_sli_qwait.band_percentile(sid)
            if sess.tid:
                row["tid"] = sess.tid
            sessions[str(sid)] = row
            for st in sess.states:
                if st is None:
                    continue
                sc = st.progress.obs
                hists = sc.read_hists() if sc is not None else None
                if hists is not None:
                    scraped += 1
                elif st.tracer is not None:
                    # scrape tick off (or no refresh yet): fall back
                    # to the tracer's own lists — integer reads, safe
                    # against a concurrently-bumping rank
                    hists = st.tracer.hists
                if hists is not None:
                    for w in range(len(trace.HIST_NAMES)):
                        h = hists[w]
                        row_a = agg[w]
                        for b in range(trace.N_BUCKETS):
                            row_a[b] += h[b]
        # the pool's own serve_attach histogram (module-level: attach
        # latency is a pool property, not any one rank's)
        ah = agg[trace.HIST_SERVE_ATTACH]
        for b in range(trace.N_BUCKETS):
            ah[b] += _attach_hist[b]
        hists_doc = {}
        pcts = {}
        for w, name in enumerate(trace.HIST_NAMES):
            hists_doc[name] = agg[w]
            pcts[name] = _obs.hist_percentiles(agg[w])
        rec = _obs.recorder()
        launches, libs = _kernel_state()
        out = {
            "ok": True,
            "ts": time.time(),
            "pid": os.getpid(),
            "capacity": self.capacity,
            "active_ranks": active_ranks,
            "queue_depth": queue_depth,
            "jobs": self._jobs,
            "epoch": self.pool_epoch,
            "est_wall_us": self.est_wall_us,
            "hosts": self.hosts,
            "hosts_lost": sum(self._host_dead),
            "hosts_rehydrating": self.hosts_rehydrating,
            "host_health": (self.health.snapshot()
                            if self.health is not None else None),
            "sdc": _integrity_snapshot(),
            "ctrl": None if self.ctrl is None else {
                "ticks": self.ctrl.ticks,
                "shed_margin_pct": self.ctrl.shed_margin_pct,
                "want_capacity": self.ctrl.want_capacity,
            },
            "scraped_ranks": scraped,
            "pvars": mpit.pvar_snapshot(),
            "scoped": _obs.scoped_snapshot(),
            "scoped_hists": _obs.scoped_hist_snapshot(),
            "doctor_reports": len(self.doctor_reports),
            "sessions": sessions,
            "hists": hists_doc,
            "percentiles": pcts,
            "events": rec.snapshot(events),
            "events_recorded": rec.recorded,
            "events_dropped": rec.dropped,
            "launches": launches,
            "kernel_libs": libs,
        }
        prom = (_obs.prometheus_enabled() if want_prom is None
                else bool(want_prom))
        if prom:
            out["prometheus"] = _obs.prometheus_text(out)
        return out

    def _persist_events(self, why: str) -> None:
        """Flight-recorder durability: on halt and on session failure
        the ring is written next to the uri file, so the record of
        what happened survives the pool process.  Best-effort."""
        if not self.uri_file:
            return
        path = f"{self.uri_file}.events.json"
        if _obs.recorder().persist(path) is not None:
            sys.stderr.write(f"tpu-dvm: flight recorder -> {path} "
                             f"({why})\n")

    # -- crash recovery ----------------------------------------------------

    def _journal_path(self, h: int) -> str:
        """Per-host journal file: host 0 shares the legacy path (so a
        one-host pool's on-disk format is unchanged), host k >= 1 gets
        a `.h<k>` sibling.  All federated under one incarnation id."""
        base = f"{self.uri_file}.journal"
        return f"{base}.jsonl" if h == 0 else f"{base}.h{h}.jsonl"

    def _jrec_h(self, h: int, rec: dict, sync: bool = False) -> None:
        j = self._journal if h == 0 else self._hjournals[h]
        if j is not None:
            j.append(rec, sync=sync)

    def _jrec(self, rec: dict, sync: bool = False) -> None:
        if self._journal is None:
            return
        h = 0
        if self.hosts > 1:
            # federate: each session's write-ahead records land in the
            # journal of the host domain that owns it, so losing one
            # host loses exactly that host's tail — the survivors'
            # journals stay intact and replayable
            sid = rec.get("sid")
            if sid is not None:
                h = int(sid) % self.hosts
        self._jrec_h(h, rec, sync=sync)

    def _close_journals(self) -> None:
        """Clean halt: close and delete the pool's journal and every
        host's — a journal on disk always means a crash, and would
        resurrect sessions nobody wants back."""
        if self._journal is not None:
            self._journal.close(delete=True)
            self._journal = None
        for h in range(1, self.hosts):
            jh = self._hjournals[h]
            if jh is not None:
                jh.close(delete=True)
                self._hjournals[h] = None

    def _quota_snapshot(self) -> Dict[str, Any]:
        return {"dvm_quota_hbm_bytes":
                registry.get("dvm_quota_hbm_bytes", 0)}

    def _rehydrate(self, path: str) -> None:
        """Rebuild the session table from the journal a dead
        incarnation left behind.  Every journaled-attached session
        comes back PARKED — sid, ns, token, priority and replay
        memory restored, world torn down (it died with the process);
        the existing preemption machinery (_run -> _unpark) brings
        the world back up on the owner's next run, after it
        reattaches by token.  Jobids journaled as in-flight (run WAL
        without run_done) are handed back at reattach so the client
        resubmits them — never silently lost.

        With hosts > 1 the journal is FEDERATED: one file per host
        domain, all stamped with the same fleet incarnation id.  A
        new incarnation loads every surviving host journal (a torn
        tail in any one of them is tolerated independently) and
        compacts each back to its own host's state."""
        recs = _Journal.load(path)
        self._journal = _Journal(path)
        for h in range(1, self.hosts):
            hp = self._journal_path(h)
            recs.extend(_Journal.load(hp))
            self._hjournals[h] = _Journal(hp)
        if not recs:
            opened = {"t": "open", "inc": self.incarnation,
                      "pid": os.getpid(), "cap": self.capacity}
            self._jrec_h(0, opened, sync=True)
            self._jrec_h(0, {"t": "quota", **self._quota_snapshot()})
            for h in range(1, self.hosts):
                self._jrec_h(h, opened, sync=True)
            return
        live: Dict[int, dict] = {}
        done: Dict[int, "collections.OrderedDict[str, int]"] = {}
        wal: Dict[int, set] = {}
        jobs = 0
        epoch = 0
        max_sid = 0
        for rec in recs:
            t = rec.get("t")
            if t == "attach":
                sid = int(rec["sid"])
                live[sid] = rec
                max_sid = max(max_sid, sid)
            elif t == "detach":
                sid = int(rec["sid"])
                live.pop(sid, None)
                done.pop(sid, None)
                wal.pop(sid, None)
            elif t == "run":
                wal.setdefault(int(rec["sid"]), set()).add(
                    rec["jobid"])
            elif t == "run_done":
                sid = int(rec["sid"])
                wal.get(sid, set()).discard(rec["jobid"])
                d = done.setdefault(sid, collections.OrderedDict())
                d[rec["jobid"]] = int(rec["code"])
                # bound replay memory exactly like the live path
                # (remember_done): without this, a long-lived session
                # rehydrated across incarnations accretes its entire
                # completed-jobid history into RAM and back into the
                # compacted journal, growing without bound
                while len(d) > 64:
                    d.popitem(last=False)
                jobs += 1
            elif t == "epoch":
                epoch = int(rec["epoch"])
            elif t == "quota":
                for k, v in rec.items():
                    if k != "t" and v:
                        registry.set(k, v)
        self._sid_counter = itertools.count(max_sid + 1)
        self._jobs = jobs
        self.pool_epoch = epoch
        for sid, arec in live.items():
            sess = _Session(sid, int(arec["np"]), None)
            sess.priority = int(arec.get("prio", 0))
            sess.preemptible = bool(arec.get("pre", False))
            sess.token = arec.get("token", sess.token)
            sess.parked = True  # world died with the old process;
            # the owner's next run re-admits + re-brings-up (the
            # same path a preempted session resumes through)
            sess.completed = done.get(sid, collections.OrderedDict())
            sess.wal_jobs = wal.get(sid, set())
            sess.rehydrated = True
            self.sessions[sid] = sess
            _pv_active.add(1)
        self.rehydrated = len(live)
        self.rehydrated_parked = len(live)
        if live:
            _pv_peak.update_max(len(self.sessions))
            self._set_xsession_hint(len(self.sessions))
        # compact: each journal starts from the rehydrated state, not
        # the dead incarnation's full history.  Session records route
        # back to their owning host's journal; pool-level records
        # (quota, epoch) live in host 0's.
        opened = {"t": "open", "inc": self.incarnation,
                  "pid": os.getpid(), "cap": self.capacity}
        outs: List[List[dict]] = [[opened] for _ in range(self.hosts)]
        outs[0].append({"t": "quota", **self._quota_snapshot()})
        if epoch:
            outs[0].append({"t": "epoch", "epoch": epoch,
                            "cap": self.capacity})
        for sid, arec in live.items():
            out = outs[sid % self.hosts if self.hosts > 1 else 0]
            out.append(arec)
            for jobid, code in done.get(sid, {}).items():
                out.append({"t": "run_done", "sid": sid,
                            "jobid": jobid, "code": code})
            for jobid in wal.get(sid, set()):
                out.append({"t": "run", "sid": sid, "jobid": jobid})
        self._journal.rewrite(outs[0])
        for h in range(1, self.hosts):
            jh = self._hjournals[h]
            if jh is not None:
                jh.rewrite(outs[h])
        _obs.record_event(_obs.EV_DVM_REHYDRATE, len(live), jobs,
                          _obs.intern(self.incarnation))
        inflight = sum(len(s) for s in wal.values())
        sys.stderr.write(
            f"tpu-dvm: rehydrated {len(live)} session(s), {jobs} "
            f"completed job(s), {inflight} in-flight jobid(s) from "
            f"{path} (incarnation {self.incarnation})\n")

    # -- host failure domains ----------------------------------------------

    def host_ranks(self, sess: _Session, h: int) -> List[int]:
        """Ranks of `sess` resident on host domain `h` — the same
        contiguous banding _bringup stamps into each rank's node_id,
        so liveness, placement and the modex all agree on who lives
        where.  A health-plane placement override (sess.placement,
        stamped at _bringup when a domain is degraded/quarantined)
        wins over the static banding — liveness must kill exactly the
        ranks that actually live on the dead host."""
        if self.hosts < 2:
            return list(range(sess.np)) if h == 0 else []
        if sess.placement is not None:
            return [r for r in range(sess.np)
                    if sess.placement[r] == h]
        return [r for r in range(sess.np)
                if r * self.hosts // sess.np == h]

    def _host_tick(self, now: int) -> int:
        """Hot-path host-liveness sweep (hotpath_audit-enforced):
        mark every host whose agent has beaten at least once but has
        now been silent past the grace horizon.  Pure integer
        arithmetic over preallocated lists — no allocation, no
        formatting; the expensive collection (ULFM publication,
        parking, KV failover) runs off-path in _host_collect."""
        if self.hosts < 2:
            return 0
        grace = self._host_grace_ns
        beat = self._host_beat
        dead = self._host_dead
        pend = self._host_pending
        hp = self.health
        graces = hp.grace_ns if hp is not None else None
        n = self.hosts
        hit = 0
        h = 0
        while h < n:
            b = beat[h]
            # adaptive per-host grace (obs/health): the shared
            # beat estimator widens a jittery-but-alive host's
            # horizon and keeps a crisp host at the static floor
            g = grace
            if graces is not None:
                g = graces[h]
                if g < grace:
                    g = grace
            if b > 0 and dead[h] == 0 and pend[h] == 0 \
                    and now - b > g:
                pend[h] = 1
                hit += 1
            h += 1
        return hit

    def _host_collect(self) -> None:
        """Off-hot-path half of the liveness plane: turn every host
        _host_tick marked into one atomic lost-domain record."""
        h = 0
        while h < self.hosts:
            if self._host_pending[h] == 1 and self._host_dead[h] == 0:
                self._host_lost(h, "heartbeat silence past "
                                   "oob_host_grace_s")
            h += 1

    def _host_lost(self, h: int, why: str) -> None:
        """A whole host failure domain died.  Every resident rank of
        every session is marked failed as ONE atomic record — ULFM
        waiters see a single consistent failure set instead of N
        racing per-rank detections.  Per session:

        - running + ULFM-aware: publish the batched failure set and
          let the program shrink around it (survivors continue);
        - running, not ULFM-aware: publish, then poison + park — the
          session replays transparently on respawn (the preemption
          machinery; the client sees a slower run, never a failed
          one);
        - idle: park directly, no ULFM publication (a graceful
          finalize with dead ranks pre-counted would over-fill the
          fence quorum).

        Also fails the host's KV endpoint (crash_host — the off-host
        standby takes over mid-fence) and closes — without deleting —
        its federated journal, so the tail replays at respawn."""
        from ompi_tpu_torch.ft import ulfm as _ulfm
        with self.lock:
            if self._host_dead[h]:
                return
            self._host_dead[h] = 1
            self._host_pending[h] = 0
            self._host_lost_ns[h] = time.perf_counter_ns()
            self.hosts_rehydrating += 1
            agent = self._host_agents.pop(h, None)
            sessions = list(self.sessions.values())
        _pv_hosts_lost.add(1)
        _pv_hosts_active.add(-1)
        if self.health is not None:
            # a dead domain leaves the gray-failure sweep: the
            # liveness plane owns it now (scores/state reset so a
            # respawned host starts healthy with fresh estimates)
            self.health.exclude(h, True)
            self._health_applied[h] = 0
        lost_sids: List[int] = []
        nranks = 0
        for sess in sessions:
            ranks = self.host_ranks(sess, h)
            if not ranks:
                continue
            park = False
            with sess.lock:
                if sess.dead or sess.parked or sess.world is None:
                    continue
                lost_sids.append(sess.sid)
                nranks += len(ranks)
                if sess.running:
                    aware = False
                    for st in sess.states:
                        if st is not None and getattr(
                                st, "ulfm", None) is not None:
                            aware = True
                            break
                    # mark each resident rank's incarnation dead (the
                    # arm_rank_kill marker): the rank-thread standing
                    # in for a vanished process must see its own death
                    # — a rank never ingests its own global-rank into
                    # ulfm.failed — and last-rank accounting must stop
                    # waiting for it
                    for r in ranks:
                        if r < len(sess.states):
                            st = sess.states[r]
                            if st is not None:
                                st.ulfm_dead = True
                    _ulfm.publish_world_failures(sess.world, ranks)
                    if not aware:
                        sess.preempt_requested = True
                        self._poison_session(
                            sess, 75, f"host {h} lost ({why})")
                else:
                    sess.preempt_requested = False
                    sess.parked = True
                    park = True
            if park:
                self._park(sess)
        self._host_lost_sids[h] = lost_sids
        if self.kv_server is not None:
            try:
                self.kv_server.crash_host(h)
            except OSError:
                pass
        if agent is not None:
            agent.dead = True
            try:
                agent.sock.close()
            except OSError:
                pass
        jh = self._hjournals[h]
        if jh is not None:
            jh.close()  # keep the file: its tail replays at respawn
            self._hjournals[h] = None
        _obs.record_event(_obs.EV_HOST_LOST, h, nranks,
                          len(lost_sids))
        tr = trace.global_tracer()
        if tr is not None:
            tr.instant("host_lost", "fleet", host=h, ranks=nranks,
                       sessions=len(lost_sids))
        sys.stderr.write(
            f"tpu-dvm: host {h} LOST ({why}) — {nranks} rank(s) in "
            f"{len(lost_sids)} session(s) failed as one domain\n")

    def kill_host(self, h: int) -> None:
        """Deterministic whole-host sever (ft_inject host_kill and
        the `tpu-dvm --kill-host` path): SIGKILL the host's tpud
        agent if it is a real process, then run the same lost-domain
        handling heartbeat silence would have reached — minus the
        grace wait."""
        if not 0 <= h < self.hosts:
            raise DvmError(f"host {h} outside fleet "
                           f"(hosts={self.hosts})")
        if self._host_dead[h]:
            return
        agent = self._host_agents.get(h)
        pid = getattr(agent, "agent_pid", 0) if agent is not None else 0
        if pid:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        self._host_lost(h, "host_kill")

    def respawn_host(self, h: int) -> float:
        """Host-granularity rehydration: a replacement host (fresh
        tpud agent re-registers after this) rejoins the fleet under
        the SAME incarnation id.  Its federated journal is rebuilt
        from the live session table (the dead tail already did its
        job: parked sessions replay through _unpark).  Returns the
        domain's MTTR in milliseconds — lost-mark to rejoin."""
        if not 0 <= h < self.hosts:
            raise DvmError(f"host {h} outside fleet "
                           f"(hosts={self.hosts})")
        with self.lock:
            if not self._host_dead[h]:
                return 0.0
            self._host_dead[h] = 0
            self._host_pending[h] = 0
            self._host_beat[h] = 0
            lost_ns = self._host_lost_ns[h]
            self._host_lost_ns[h] = 0
            self.hosts_rehydrating = max(0, self.hosts_rehydrating - 1)
            sids = self._host_lost_sids.pop(h, [])
        if self.health is not None:
            self.health.exclude(h, False)
        if h > 0 and self.uri_file and self._journal is not None:
            jh = _Journal(self._journal_path(h))
            self._hjournals[h] = jh
            outs = [{"t": "open", "inc": self.incarnation,
                     "pid": os.getpid(), "cap": self.capacity}]
            with self.lock:
                for sid, sess in self.sessions.items():
                    if sid % self.hosts != h:
                        continue
                    outs.append({"t": "attach", "sid": sid,
                                 "np": sess.np, "prio": sess.priority,
                                 "pre": sess.preemptible,
                                 "token": sess.token})
                    for jobid, code in sess.completed.items():
                        outs.append({"t": "run_done", "sid": sid,
                                     "jobid": jobid, "code": code})
            jh.rewrite(outs)
        _pv_hosts_active.add(1)
        mttr_ms = ((time.perf_counter_ns() - lost_ns) / 1e6
                   if lost_ns else 0.0)
        _obs.record_event(_obs.EV_HOST_RESPAWN, h, len(sids),
                          int(mttr_ms))
        tr = trace.global_tracer()
        if tr is not None:
            tr.instant("host_respawn", "fleet", host=h,
                       sessions=len(sids), ms=round(mttr_ms, 3))
        sys.stderr.write(
            f"tpu-dvm: host {h} respawned in {mttr_ms:.1f} ms "
            f"({len(sids)} session(s) rehydrating)\n")
        self._pump()
        return mttr_ms

    # -- gray-failure health plane -----------------------------------------

    def _health_collect(self) -> None:
        """Cold half of the gray-failure plane: drain the transitions
        the audited tick latched and walk the mitigation ladder —
        degraded stops new placement (and reroutes hier leaders,
        widens deadlines), quarantined drains-and-migrates, recovery
        walks back down.  Never declares death: that stays the
        liveness plane's job."""
        hp = self.health
        if hp is None:
            return
        from ompi_tpu_torch.obs import health as _health
        tr = trace.global_tracer()
        for h in hp.collect():
            new = hp.state[h]
            old = self._health_applied[h]
            self._health_applied[h] = new
            score = hp.score[h]
            if new > old and new == _health.DEGRADED:
                _obs.record_event(_obs.EV_HOST_DEGRADED, h, score, new)
                if tr is not None:
                    tr.instant("host_degraded", "fleet", host=h,
                               score=score)
                sys.stderr.write(
                    f"tpu-dvm: host {h} DEGRADED (score {score}, "
                    f"signals {','.join(hp.tripped(h)) or 'beat'}) — "
                    f"new placements avoid it, deadlines widened\n")
            elif new > old and new == _health.QUARANTINED:
                hp.note_quarantine()
                moved = self._quarantine_drain(h)
                _obs.record_event(_obs.EV_HOST_QUARANTINE, h, score,
                                  moved)
                if tr is not None:
                    tr.instant("host_quarantine", "fleet", host=h,
                               score=score, sessions=moved)
                sys.stderr.write(
                    f"tpu-dvm: host {h} QUARANTINED (score {score}) — "
                    f"{moved} session(s) draining onto healthy "
                    f"domains\n")
                if _health._respawn_var.value:
                    # operator opted into cycling the offender: the
                    # death path is safe here because the drain just
                    # parked every resident (never-failed-jobs holds)
                    self.kill_host(h)
                    self.respawn_host(h)
                    hp.exclude(h, False)
                    self._health_applied[h] = 0
            elif new < old:
                _obs.record_event(_obs.EV_HOST_RECOVERED, h, score)
                if tr is not None:
                    tr.instant("host_recovered", "fleet", host=h,
                               score=score)
                sys.stderr.write(
                    f"tpu-dvm: host {h} recovered to "
                    f"{_health.STATE_NAMES[new]} (score {score})\n")

    def _health_sample(self, hp) -> None:
        """Cold corroboration sweep (rides the heartbeat loop):
        approximate per-host rendezvous-wait microseconds from each
        resident rank's straggler-skew histogram (trace.HIST_RDV_WAIT,
        the critpath phase gauge) and feed the cross-host SKEW to the
        health plane — attributed to the host everyone else waits FOR
        (stragglers arrive last, so their own rdv_wait is the
        smallest)."""
        tot = [0] * self.hosts
        cnt = [0] * self.hosts
        with self.lock:
            sessions = list(self.sessions.values())
        for sess in sessions:
            states = sess.states
            for r in range(len(states)):
                st = states[r]
                if st is None:
                    continue
                tr_ = getattr(st, "tracer", None)
                if tr_ is None:
                    continue
                h = self._place_node(sess, r)
                if not 0 <= h < self.hosts:
                    continue
                hist = tr_.hists[trace.HIST_RDV_WAIT]
                us = 0
                for b in range(len(hist)):
                    c = hist[b]
                    if c:
                        us += c * (1 << b) >> 1  # mid-bucket estimate
                tot[h] += us
                cnt[h] += 1
        lo_h = -1
        lo_v = -1
        hi_v = -1
        for h in range(self.hosts):
            if cnt[h] == 0:
                continue
            avg = tot[h] // cnt[h]
            if lo_v < 0 or avg < lo_v:
                lo_v = avg
                lo_h = h
            if avg > hi_v:
                hi_v = avg
        if lo_h >= 0 and hi_v > lo_v:
            hp.note_rdv_skew(lo_h, hi_v - lo_v)

    def _quarantine_drain(self, h: int) -> int:
        """Drain-and-migrate every session resident on quarantined
        host `h` through the preemption machinery: running
        sessions are poisoned with preempt_requested (the run replays
        from checkpoint after re-bringup — the client sees a slower
        run, never a failed one), idle sessions are parked directly.
        The next _bringup places them off the quarantined domain
        (_plan_placement skips non-healthy hosts).  No ULFM
        publication, no KV crash, no journal close: the host is ALIVE
        — just too slow to serve."""
        hp = self.health
        with self.lock:
            sessions = list(self.sessions.values())
        moved = 0
        t0 = time.perf_counter_ns()
        for sess in sessions:
            ranks = self.host_ranks(sess, h)
            if not ranks:
                continue
            park = False
            with sess.lock:
                if sess.dead or sess.parked or sess.world is None:
                    continue
                if sess.running:
                    sess.preempt_requested = True
                    self._poison_session(
                        sess, 75, f"host {h} quarantined (migrating)")
                else:
                    sess.preempt_requested = False
                    sess.parked = True
                    park = True
            if park:
                self._park(sess)
            moved += 1
            us = (time.perf_counter_ns() - t0) // 1000
            _obs.record_event(_obs.EV_MIGRATE, sess.sid, h, us)
        if moved and hp is not None:
            hp.note_migration(moved)
        return moved

    def _plan_placement(self, np_: int) -> Optional[List[int]]:
        """Rank->host bands for a new (or re-admitted) session.  All
        domains healthy: None — the static contiguous banding
        `rank*hosts//np` is unchanged.  Any
        domain degraded/quarantined/dead: band over the healthy-host
        list only, so new placements simply never land on a sick
        domain (the admission path is unchanged — capacity still
        gates; this only decides WHERE)."""
        if self.hosts < 2:
            return None
        hp = self.health
        healthy = [h for h in range(self.hosts)
                   if self._host_dead[h] == 0
                   and (hp is None or hp.placement_ok(h))]
        if len(healthy) == self.hosts:
            return None
        if not healthy:
            # every domain sick: fall back to the static banding
            # rather than refusing service (degraded > dead)
            return None
        return [healthy[r * len(healthy) // np_] for r in range(np_)]

    def _place_node(self, sess: _Session, rank: int) -> int:
        if self.hosts < 2:
            return 0
        if sess.placement is not None:
            return sess.placement[rank]
        return rank * self.hosts // sess.np

    def _touches_degraded(self, sess: _Session) -> bool:
        """Does any of this session's resident ranks live on a
        degraded (or worse) domain?  Drives the deadline-widening arm
        of the mitigation ladder."""
        hp = self.health
        if hp is None or self.hosts < 2:
            return False
        for r in range(sess.np):
            h = self._place_node(sess, r)
            if hp.state[h] >= 1 and hp.excluded[h] == 0:
                return True
        return False

    # -- admission ---------------------------------------------------------

    def _can_admit_locked(self, np_: int, resume: bool = False) -> bool:
        if self.active_ranks + np_ > self.capacity:
            return False
        # a parked session being re-admitted is already counted in
        # the session table; only rank capacity gates it
        return (resume
                or len(self.sessions) < max(1, _session_max_var.value))

    def _admit_locked(self, np_: int, conn, priority: int = 0,
                      preemptible: bool = False) -> _Session:
        sess = _Session(next(self._sid_counter), np_, conn)
        sess.priority = priority
        sess.preemptible = preemptible
        sess.epoch = self.pool_epoch
        self.sessions[sess.sid] = sess
        self.active_ranks += np_
        _pv_active.add(1)
        _pv_peak.update_max(len(self.sessions))
        self._set_xsession_hint(len(self.sessions))
        return sess

    def _enqueue_waiter_locked(self, w: _Waiter) -> None:
        """Priority insertion, FIFO within a priority level: the queue
        stays a deque whose head is always the best-admissible claim,
        so _pump's head-of-line discipline is unchanged."""
        idx = len(self._waiters)
        for j, ex in enumerate(self._waiters):
            if ex.priority < w.priority:
                idx = j
                break
        self._waiters.insert(idx, w)
        _pv_qdepth.add(1)
        _pv_qpeak.update_max(len(self._waiters))

    def _set_xsession_hint(self, n: int) -> None:
        from ompi_tpu_torch.coll import fusion
        fusion.set_xsession_hint(n)

    def _pump(self) -> None:
        """Admit queued waiters in priority order (FIFO within a
        level).  Head-of-line blocking is deliberate: a big-np attach
        at the front must not starve behind a stream of small ones
        slipping past it."""
        with self.lock:
            while self._waiters:
                w = self._waiters[0]
                if w.abandoned:
                    self._waiters.popleft()
                    _pv_qdepth.add(-1)
                    continue
                if self._draining:
                    self._waiters.popleft()
                    _pv_qdepth.add(-1)
                    w.error = "pool is halting"
                    w.event.set()
                    continue
                if not self._can_admit_locked(
                        w.np, resume=w.resume is not None):
                    break
                self._waiters.popleft()
                _pv_qdepth.add(-1)
                if w.resume is not None:
                    sess = w.resume
                    self.active_ranks += w.np
                    sess.parked = False
                    if sess.rehydrated:
                        sess.rehydrated = False
                        self.rehydrated_parked -= 1
                    sess.epoch = self.pool_epoch
                    w.sess = sess
                else:
                    w.sess = self._admit_locked(w.np, w.conn,
                                                w.priority,
                                                w.preemptible)
                w.event.set()

    def _attach(self, np_: int, conn, wait: bool = True,
                timeout: Optional[float] = None, priority: int = 0,
                preemptible: bool = False, tid: int = 0):
        t0 = time.perf_counter()
        if np_ < 1 or np_ > self.capacity:
            raise DvmError(
                f"np {np_} exceeds DVM capacity {self.capacity}")
        w: Optional[_Waiter] = None
        sess: Optional[_Session] = None
        pvictim: Optional[_Session] = None
        queued_us = 0
        while True:
            victim: Optional[_Session] = None
            with self.lock:
                if self._draining:
                    raise DvmError("pool is halting")
                if self._can_admit_locked(np_):
                    sess = self._admit_locked(np_, conn, priority,
                                              preemptible)
                else:
                    victim = next(
                        (s for s in self.sessions.values()
                         if s.legacy_idle and not s.detaching), None)
                    if victim is not None:
                        victim.legacy_idle = False
                    elif not wait:
                        _pv_rejects.add(1)
                        _obs.record_event(_obs.EV_ADMIT_REJECT, -1,
                                          _obs.intern("busy"))
                        raise DvmBusy(
                            f"pool busy ({self.active_ranks}/"
                            f"{self.capacity} ranks, "
                            f"{len(self.sessions)} sessions) and "
                            "wait=False")
                    elif len(self._waiters) >= max(
                            0, _queue_max_var.value):
                        _pv_rejects.add(1)
                        _obs.record_event(_obs.EV_QUEUE_FULL,
                                          len(self._waiters))
                        raise DvmBusy(
                            f"admission queue full "
                            f"({len(self._waiters)} waiting, "
                            f"dvm_queue_max={_queue_max_var.value})")
                    else:
                        # overload and we must park.  A priority
                        # attach first claims a lower-priority
                        # preemptible victim (marked under this lock;
                        # preempted outside it) — its release pumps
                        # our queue entry, which priority-sorts ahead
                        # of lower-priority waiters either way.
                        if priority > 0:
                            pvictim = self._pick_preempt_locked(
                                priority)
                        w = _Waiter(np_, conn, priority, preemptible)
                        self._enqueue_waiter_locked(w)
            if victim is None:
                break
            # a parked one-shot warm session is the lowest-priority
            # tenant: reclaim its ranks for the live attach, then
            # re-try admission
            self._detach(victim.sid)
        if w is not None:
            if pvictim is not None:
                self._preempt(pvictim, priority)
            qt = _queue_timeout_var.value
            eff = timeout if timeout is not None else (
                qt if qt and qt > 0 else None)
            qt0 = time.perf_counter()
            w.event.wait(timeout=eff)
            with self.lock:
                if w.sess is None and w.error is None:
                    w.abandoned = True
            if w.error is not None:
                raise DvmError(w.error)
            if w.sess is None:
                self._pump()  # sweep the abandoned entry, admit behind it
                _pv_rejects.add(1)
                _obs.record_event(_obs.EV_ADMIT_REJECT, -1,
                                  _obs.intern("timeout"))
                if timeout is None:
                    raise DvmBusy(
                        f"pool still saturated after queueing "
                        f"{eff:.1f}s (dvm_queue_timeout_s) — "
                        "try again later")
                raise DvmBusy(
                    f"timed out after {timeout}s waiting for capacity")
            sess = w.sess
            queued_us = int((time.perf_counter() - qt0) * 1e6)
        try:
            self._bringup(sess)
        except BaseException:
            self._release(sess)
            raise
        attach_us = int((time.perf_counter() - t0) * 1e6)
        sess.tid = tid
        _pv_attaches.add(1)
        _pv_queue_wait_us.add(queued_us, sess.sid)
        _pv_sli_qwait.add_us(queued_us, sess.sid)
        if self.health is not None and queued_us > 0:
            # queue-wait SLI corroboration: attributed to the hosts
            # this session actually landed on (small weight — the
            # beat estimator stays the load-bearing signal)
            for h in set(self._place_node(sess, r)
                         for r in range(sess.np)):
                self.health.note_queue_wait(h, queued_us)
        _pv_attach_us_max.update_max(attach_us)
        _obs.record_event(_obs.EV_DVM_ATTACH, sess.sid, np_, attach_us)
        if tid:
            _obs.record_event(_obs.EV_REQ_ATTACH, sess.sid, tid,
                              queued_us)
        b = attach_us.bit_length()
        _attach_hist[b if b < trace.N_BUCKETS else trace.N_BUCKETS - 1] += 1
        tr = trace.global_tracer()
        if tr is not None:
            tr.hist_add(trace.HIST_SERVE_ATTACH, attach_us / 1e6)
            tr.instant("dvm_attach", "serve", sid=sess.sid, np=np_,
                       us=attach_us, queued_us=queued_us)
        self._write_proctable()
        return sess, attach_us, queued_us

    def _release(self, sess: _Session) -> None:
        with self.lock:
            if self.sessions.pop(sess.sid, None) is not None:
                if not sess.parked:  # a parked session's ranks were
                    # already returned when it was preempted
                    self.active_ranks -= sess.np
                if sess.rehydrated:
                    sess.rehydrated = False
                    self.rehydrated_parked -= 1
                _pv_active.add(-1)
                self._set_xsession_hint(len(self.sessions))
        self._pump()

    # -- preemption / shedding / live resize -------------------------------

    def _pick_preempt_locked(self, priority: int) -> Optional[_Session]:
        """Lowest-priority preemptible victim (oldest sid breaks
        ties), marked preempt_requested under the caller's lock so two
        racing priority attaches never claim the same ranks twice."""
        best: Optional[_Session] = None
        for s in self.sessions.values():
            if (not s.preemptible or s.priority >= priority
                    or s.detaching or s.dead or s.parked
                    or s.preempt_requested):
                continue
            if best is None or (s.priority, s.sid) < (best.priority,
                                                      best.sid):
                best = s
        if best is not None:
            best.preempt_requested = True
        return best

    def _poison_session(self, sess: _Session, code: int,
                        why: str) -> None:
        """Session-confined abort from outside the session's own
        rank-threads: poison its world (testing.sessions.poison) and KV
        namespace so every blocking fence/rendezvous of THIS session
        unwinds — the same machinery SessionRTE.abort uses, never
        os._exit."""
        from ompi_tpu_torch.runtime.kvstore import KVClient
        from ompi_tpu_torch.testing import sessions as _sessions
        if sess.world is not None:
            _sessions.poison(sess.world, code, why)
        try:
            kvc = KVClient(self.kv_server.uri, ns=sess.ns)
            kvc.abort(-1, code, why)
            kvc.close()
        except OSError:
            pass

    def _preempt(self, victim: _Session, by_priority: int) -> None:
        """Evict `victim` for a higher-priority attach.  Running: its
        world is poisoned and its own _run thread parks and resumes it
        (restoring from checkpoint) — the victim's client sees a
        slower run, never a failed one.  Idle: parked here directly;
        its next run re-admits and re-brings-up transparently."""
        _pv_preempts.add(1)
        _pv_sli_preempts.add(1, victim.sid)
        _obs.record_event(_obs.EV_DVM_PREEMPT, victim.sid, by_priority,
                          victim.priority)
        tr = trace.global_tracer()
        if tr is not None:
            tr.instant("dvm_preempt", "serve", sid=victim.sid,
                       prio=victim.priority, by=by_priority)
        with victim.lock:
            if victim.running:
                self._poison_session(victim, 75,
                                     "preempted by higher-priority "
                                     "attach")
                return
            if victim.parked or victim.dead:
                return
            # idle path: the park is consumed HERE, not by a _run
            # thread — clear the request so the next run doesn't
            # re-park a session that was already preempted
            victim.preempt_requested = False
            victim.parked = True
        self._park(victim)

    def _park(self, sess: _Session) -> None:
        """Tear down a parked session's world and return its ranks.
        The session object (sid, ns, jobid, priority) stays in the
        table; _unpark re-admits and re-brings it up."""
        sess.preempt_count += 1
        _obs.record_event(_obs.EV_REQ_PARK, sess.sid, sess.tid)
        self._destroy(sess)
        sess.world = None
        sess.states = []
        with self.lock:
            self.active_ranks -= sess.np
        self._write_proctable()
        self._pump()

    def _unpark(self, sess: _Session) -> None:
        """Wait for re-admission of a parked session, then bring its
        world back up (fresh rank-threads, same sid/cid-band/KV ns).
        Runs on the owning connection's dispatch thread — the client
        keeps getting heartbeats while we wait."""
        t0 = time.perf_counter()
        if self.hosts > 1 and self.hosts_rehydrating > 0:
            # a replay admitted while a host domain is still a hole
            # would band ranks onto the dead host: hold until the
            # fleet rehydrates (bounded — a domain nobody replaces
            # must not wedge the client forever; the pool can still
            # bring the band up on the survivors)
            deadline = time.monotonic() + max(
                5.0, 4.0 * self._host_grace_ns / 1e9)
            while (self.hosts_rehydrating > 0
                   and time.monotonic() < deadline):
                time.sleep(0.02)
        w = _Waiter(sess.np, sess.conn, sess.priority,
                    sess.preemptible, resume=sess)
        with self.lock:
            if self._draining:
                raise DvmError("pool is halting")
            self._enqueue_waiter_locked(w)
        self._pump()
        qt = _queue_timeout_var.value
        w.event.wait(timeout=max(60.0, qt * 4) if qt else None)
        with self.lock:
            if w.sess is None and w.error is None:
                w.abandoned = True
        if w.error is not None:
            raise DvmError(w.error)
        if w.sess is None:
            self._pump()
            raise DvmError(f"preempted session s{sess.sid} could not "
                           "be re-admitted (pool saturated)")
        self._bringup(sess)
        # the park->resume gap a request waterfall renders: queue wait
        # for re-admission plus the fresh bring-up
        _obs.record_event(_obs.EV_REQ_RESUME, sess.sid, sess.tid,
                          int((time.perf_counter() - t0) * 1e6))
        self._write_proctable()

    def _shed_check(self, sess: _Session, deadline_ms: int) -> None:
        """Deadline admission: against the pool's EWMA run-wall
        estimator widened by the controller's shed margin — infeasible
        work is rejected here in microseconds instead of burning
        rank-time and missing its deadline anyway."""
        est = self.est_wall_us
        if est <= 0:
            return  # no completed run yet: nothing to estimate from
        ctrl = self.ctrl
        if ctrl is not None:
            margin = ctrl.shed_margin_pct
        else:
            margin = 100 + 25 * len(self._waiters)
            if margin > 400:
                margin = 400
        eff_deadline = deadline_ms
        hp = self.health
        if hp is not None and hp.degraded_n > 0 \
                and self._touches_degraded(sess):
            # mitigation ladder: a session whose ranks sit on a
            # degraded host runs slow ON PURPOSE — widen its deadline
            # instead of shedding its work
            eff_deadline = deadline_ms * hp.widen_pct() // 100
        if est * margin // 100 <= eff_deadline * 1000:
            return
        _pv_sheds.add(1)
        _obs.record_event(_obs.EV_DVM_SHED, sess.sid, deadline_ms,
                          est // 1000)
        raise DvmDeadline(
            f"deadline {deadline_ms}ms infeasible: pool estimates "
            f"~{est // 1000}ms wall at {margin}% margin — shed at "
            "admission")

    # -- hang doctor -------------------------------------------------------

    def _wd_loop(self) -> None:
        """Progress-stall watchdog thread: ticks at half the knob
        period so a stall is DETECTED within 2·obs_watchdog_ms of
        crossing the threshold.  The tick is audited (integer scans
        only); the capture — stacks, rendezvous/fence state, JSON —
        runs here, off every hot path."""
        wd_ms = _obs.watchdog_ms()
        while not self._halted:
            time.sleep(wd_ms / 2000.0)
            # re-resolved every tick (cold path) so the factor knob
            # is live-tunable on a running pool
            base_pct = _obs.watchdog_factor_pct()
            if self._watchdog_tick(time.perf_counter_ns(), base_pct):
                self._watchdog_collect(base_pct)

    def _watchdog_tick(self, now: int, base_pct: int) -> int:
        # audited (tools/hotpath_audit): the scan itself is the
        # per-tick cost and must stay integer compares over the
        # session table — flagged sids go to _wd_hits; everything
        # that allocates happens in _watchdog_collect
        est = self.est_wall_us
        if est <= 0:
            return 0  # no completed run yet: nothing to compare with
        ctrl = self.ctrl
        factor = ctrl.wd_factor_pct if ctrl is not None else base_pct
        limit = est * 1000 * factor // 100
        hits = 0
        try:
            for sess in self.sessions.values():
                t0 = sess.run_start_ns
                if t0 and not sess.wd_fired and now - t0 > limit:
                    sess.wd_fired = True
                    self._wd_hits.append(sess.sid)
                    hits += 1
        except RuntimeError:
            return hits  # table mutated mid-scan: catch them next tick
        return hits

    def _watchdog_collect(self, base_pct: int) -> None:
        hits = self._wd_hits
        if not hits:
            return
        self._wd_hits = []
        for sid in hits:
            with self.lock:
                sess = self.sessions.get(sid)
            if sess is None or sess.run_start_ns == 0:
                continue  # the run finished between tick and collect
            self._doctor_capture(sess, base_pct)

    def _doctor_capture(self, sess: _Session, base_pct: int) -> None:
        """Auto-capture on a detected stall: every resident rank's
        stack, the session world's rendezvous arrival state and abort
        state (testing.sessions.doctor_capture, over the run's rank
        threads), its KV namespace's in-flight fences, and the flight
        tail — reduced to a verdict by tools/doctor.py."""
        from ompi_tpu_torch.testing import sessions as _sessions
        now = time.perf_counter_ns()
        ctrl = self.ctrl
        factor = ctrl.wd_factor_pct if ctrl is not None else base_pct
        limit_ns = self.est_wall_us * 1000 * factor // 100
        run_ms = (now - sess.run_start_ns) // 1_000_000
        est_ms = self.est_wall_us // 1000
        # detection latency past the moment the threshold was crossed
        mttd_ms = (now - (sess.run_start_ns + limit_ns)) / 1e6
        _obs.record_event(_obs.EV_WD_STALL, sess.sid, sess.tid,
                          run_ms, est_ms)
        w = sess.world
        if w is None:
            return
        doc = _sessions.doctor_capture(
            w, sid=sess.sid, tid=sess.tid, run_ms=run_ms, est_ms=est_ms,
            factor_pct=factor, health=self.health)
        doc["np"] = sess.np
        doc["span"] = sess.span
        doc["mttd_ms"] = round(mttd_ms, 3)
        doc["placement"] = [self._place_node(sess, r)
                            for r in range(sess.np)]
        try:
            doc["fences"] = self.kv_server.fence_snapshot(f"{sess.ns}/")
        except Exception:  # noqa: BLE001 — diagnostics never raise
            pass
        self.doctor_reports.append(doc)
        if self.uri_file:
            path = f"{self.uri_file}.doctor.s{sess.sid}.json"
            tmp = path + ".tmp"
            try:
                with open(tmp, "w") as f:
                    json.dump(doc, f, indent=1)
                os.replace(tmp, path)
                sys.stderr.write(
                    f"tpu-dvm: wd_stall s{sess.sid} "
                    f"(run {run_ms}ms > {factor}% of est {est_ms}ms) "
                    f"— doctor capture -> {path}\n")
            except OSError:
                pass
        self._persist_events(f"wd_stall s{sess.sid}")

    def resize(self, new_cap: int):
        """Live pool resize: change resident rank capacity WITHOUT
        draining.  Grow admits queued waiters immediately; shrink
        only parks ranks between runs — in-flight sessions finish on
        the old capacity, over-capacity idle warm sessions are
        evicted, and admission simply stops filling beyond the new
        bound.  Each resize opens a pool epoch: sessions admitted
        after it band their derived comm cids on the new epoch
        (ft/respawn.epoch_cid_floor), so executables and cid spaces
        never collide across the boundary.  Returns (old, epoch)."""
        if new_cap < 1:
            raise DvmError(f"resize to {new_cap} ranks: capacity must "
                           "be >= 1")
        with self.lock:
            if self._draining:
                raise DvmError("pool is halting")
            old = self.capacity
            self.capacity = new_cap
            self.pool_epoch += 1
            epoch = self.pool_epoch
        _pv_resizes.add(1)
        self._jrec({"t": "epoch", "epoch": epoch, "cap": new_cap})
        _obs.record_event(_obs.EV_DVM_RESIZE, old, new_cap, epoch)
        tr = trace.global_tracer()
        if tr is not None:
            tr.instant("dvm_resize", "serve", old=old, new=new_cap,
                       epoch=epoch)
        sys.stderr.write(f"tpu-dvm: resize {old} -> {new_cap} ranks "
                         f"(epoch {epoch})\n")
        if new_cap < old:
            # reclaim idle warm one-shot sessions until we fit (never
            # a running or attached-and-driven session: those park
            # only between runs, via normal detach/admission flow)
            while True:
                with self.lock:
                    if self.active_ranks <= new_cap:
                        break
                    victim = next(
                        (s for s in self.sessions.values()
                         if s.legacy_idle and not s.detaching), None)
                    if victim is None:
                        break
                    victim.legacy_idle = False
                try:
                    self._detach(victim.sid)
                except DvmError:
                    break
        self._pump()
        self._write_proctable()
        return old, epoch

    def _session_for(self, sid: int) -> _Session:
        with self.lock:
            sess = self.sessions.get(sid)
        if sess is None:
            raise DvmError(f"unknown session s{sid} (already detached?)")
        return sess

    # -- session lifecycle -------------------------------------------------

    def _bringup(self, sess: _Session) -> None:
        """Pre-initialize np resident rank-threads: fresh HybridWorld,
        KV namespace, cid band — but the SHARED devices, so the kernel
        libraries the pool already loaded serve every session.  Each
        rank gets its device explicitly (``mpi_init(device=...)``): the
        current CUDA device is per thread, and no rank relies on it."""
        from ompi_tpu_torch.comm.communicator import MAX_RESPAWN_EPOCHS
        from ompi_tpu_torch.runtime import state as statemod
        from ompi_tpu_torch.runtime.init import mpi_init
        from ompi_tpu_torch.runtime.kvstore import KVClient
        from ompi_tpu_torch.runtime.rte import HybridWorld, set_thread_rte

        SessionRTE = _make_session_rte()
        sess.dir = tempfile.mkdtemp(prefix=f"dvm_s{sess.sid}_")
        world = HybridWorld(sess.np, 0, sess.np)
        sess.world = world
        sess.states = [None] * sess.np
        # health-aware placement: recomputed at every bring-up — a
        # session parked off a quarantined or dead host comes back
        # banded onto the healthy domains only; with an all-healthy
        # fleet this is None and the static banding holds
        sess.placement = self._plan_placement(sess.np)
        errs: List[tuple] = []

        def boot(rank: int) -> None:
            try:
                # hosts > 1: band ranks contiguously onto host failure
                # domains — node_id flows into the modex, so topology-
                # aware consumers (buddy placement, the hierarchical
                # tier) see the fleet's placement.  The device stays
                # devices[rank % len]: the domains share this pool's
                # cards
                rte = SessionRTE(world, rank, self.kv_server.uri,
                                 node_id=self._place_node(sess, rank),
                                 jobid=sess.jobid,
                                 session_dir=sess.dir, kv_ns=sess.ns)
                if self.devices:
                    rte.default_device = self.devices[
                        rank % len(self.devices)]
                set_thread_rte(rte)
                st = statemod.ProcState(rank, sess.np, rte)
                st.cid_band = sess.sid
                st.serve_resident = True
                # pool-resize epoch rides the respawn epoch machinery:
                # derived comm cids of a session admitted after a live
                # resize band on the new epoch, so they can never
                # collide with cid spaces from before the boundary
                st.respawn_epoch = sess.epoch % MAX_RESPAWN_EPOCHS
                mpi_init(st, device=rte.default_device)

                def _abort_check(world=world, rank=rank) -> int:
                    # a poisoned session (a failed peer, a preemption,
                    # the watchdog) unwinds every blocking wait of its
                    # ranks, the host paths' included, as run_ranks'
                    # and the app shells' worlds do
                    if world.aborted and world.aborted[0] != rank:
                        raise RuntimeError(
                            f"session rank {world.aborted[0]} aborted: "
                            f"{world.aborted[2]}")
                    return 0

                st.progress.register(_abort_check, low_priority=True)
                if self.ctrl is not None:
                    # resident rank-threads drive the FleetController
                    # on their sampled progress sweeps; the hb loop
                    # covers idle periods
                    st.progress.ctrl = self.ctrl
                sess.states[rank] = st
            except BaseException as e:  # noqa: BLE001
                errs.append((rank, e))
                if world.aborted is None:
                    world.aborted = (rank, 1, f"bring-up failed: {e}")
                # release peers parked in this session's init fences
                try:
                    kvc = KVClient(self.kv_server.uri, ns=sess.ns)
                    kvc.abort(rank, 1, f"bring-up failed: {e}")
                    kvc.close()
                except OSError:
                    pass
            finally:
                statemod.set_current(None)
                set_thread_rte(None)

        threads = [threading.Thread(target=boot, args=(r,), daemon=True,
                                    name=f"dvm-s{sess.sid}-boot-r{r}")
                   for r in range(sess.np)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs or any(st is None for st in sess.states):
            sess.dead = True
            self._scrub(sess)
            rank, e = errs[0] if errs else (
                -1, RuntimeError("bring-up incomplete"))
            raise DvmError(
                f"session bring-up failed at rank {rank}: {e}")

    def _run(self, sess: _Session, prog: str, args: List[str]):
        if not os.path.isfile(prog):
            raise DvmError(f"program not found: {prog}")
        with sess.lock:
            if sess.dead:
                raise DvmError(f"session s{sess.sid} is dead "
                               "(a prior run aborted)")
            if sess.running:
                raise DvmError(f"session s{sess.sid} already has a "
                               "run in progress")
            sess.running = True
            parked = sess.parked
        try:
            if parked:
                # preempted while idle: re-admit + fresh bring-up
                # before the program starts — invisible to the client
                # beyond latency
                self._unpark(sess)
            while True:
                code, out, err, wall = self._run_once(sess, prog, args)
                with sess.lock:
                    preempted = sess.preempt_requested
                    sess.preempt_requested = False
                    if preempted:
                        sess.parked = True
                    elif code:
                        sess.dead = True
                if preempted:
                    # retreat: the world is poisoned either way —
                    # tear it down, hand the ranks to the preemptor,
                    # then resume from checkpoint.  The victim's
                    # client sees ONE slower successful run, never a
                    # failed job.
                    self._park(sess)
                    if code and not self._draining:
                        self._unpark(sess)
                        continue
                    if code:  # pool is halting: nowhere to resume
                        with sess.lock:
                            sess.dead = True
                break
        finally:
            with sess.lock:
                sess.running = False
        if sess.dead:
            # a dead session is exactly the moment the flight record
            # must outlive the process that wrote it
            self._persist_events(f"s{sess.sid} failed")
        return (code, out, err, wall)


    def _run_once(self, sess: _Session, prog: str, args: List[str]):
        import runpy

        from ompi_tpu_torch.ft import ulfm as _ulfm
        from ompi_tpu_torch.runtime import state as statemod
        from ompi_tpu_torch.runtime.rte import set_thread_rte
        from ompi_tpu_torch.serve import quota as _squota

        _squota.begin_run(sess.sid)  # quotas are per run
        t0 = time.perf_counter()
        # watchdog anchors: run start first, THEN clear the one-shot
        # latch — the reverse order would let a tick fire on the
        # previous run's stale start
        sess.run_start_ns = time.perf_counter_ns()
        sess.wd_fired = False
        if sess.tid:
            # propagate the trace context across the KV fence plane:
            # other components correlate this session's fences with
            # the request by reading its namespace.  Cold path, gated
            # on a carried context.
            from ompi_tpu_torch.runtime.kvstore import KVClient
            try:
                kvc = KVClient(self.kv_server.uri, ns=sess.ns)
                kvc.put("reqtrace", {"tid": sess.tid,
                                     "span": sess.span,
                                     "sid": sess.sid})
                kvc.close()
            except OSError:
                pass
        _ensure_stdio()  # per run, not just at pool start: the host
        # may have swapped sys.stdout since (pytest capture does)
        out, err = _SessionBuf(), _SessionBuf()
        argv = [prog] + [str(a) for a in args]
        failure: List[Optional[int]] = [None]
        flock = threading.Lock()

        def poison(st, code: int, why: str) -> None:
            w = st.rte.world
            if w.aborted is None:
                w.aborted = (st.rank, code, why)
            for ps in w.states:
                if ps is not None and getattr(ps, "progress",
                                              None) is not None:
                    ps.progress.wakeup()
            try:
                st.rte.kv.abort(st.rank, code, why)
            except OSError:
                pass

        def run_rank(st) -> None:
            set_thread_rte(st.rte)
            statemod.set_current(st)
            _stdio_push(out, err, argv)
            # per-job tracer tag: two int stores bracket the program,
            # so every span the rank records in between is
            # attributable to this request by timestamp containment
            rtr = st.tracer if sess.tid else None
            if rtr is not None:
                rtr.req_mark(sess.tid)
            try:
                runpy.run_path(prog, run_name="__main__")
                # run boundary: flush deferred fused batches and meet
                # the peers, so the NEXT program on this session
                # starts from a quiet warm world.  Symmetric whether
                # or not the program called finalize() — the
                # serve_resident deferral makes finalize itself
                # exactly this flush+fence.
                from ompi_tpu_torch.coll import fusion as _fusion
                _fusion.flush_state(st)
                st.rte.fence()
            except SystemExit as e:
                code = e.code if isinstance(e.code, int) else (
                    0 if e.code is None else 1)
                if (isinstance(e, _ulfm.RankKilled)
                        and getattr(st, "ulfm", None) is not None):
                    # injected permanent rank death on a ULFM-enabled
                    # world: publish it like the host-kill path does
                    # instead of poisoning the session — an aware
                    # program shrinks around the corpse and the run
                    # completes (never a failed job); a non-aware one
                    # dies on the survivors' ERR_PROC_FAILED below
                    st.ulfm_dead = True
                    err.write(f"[dvm s{sess.sid} rank {st.rank}] "
                              f"ft_inject rank_kill: ULFM failure "
                              f"published, survivors may shrink\n")
                    _ulfm.publish_world_failure(st.rte.world, st.rank)
                elif code != 0:
                    with flock:
                        failure[0] = failure[0] or code
                    poison(st, code, "SystemExit")
            except BaseException:  # noqa: BLE001
                err.write(f"[dvm s{sess.sid} rank {st.rank}] uncaught:\n"
                          f"{traceback.format_exc()}")
                with flock:
                    failure[0] = failure[0] or 1
                poison(st, 1, "uncaught exception")
            finally:
                if rtr is not None:
                    rtr.req_mark(0)  # close this rank's tag window
                _stdio_pop()
                statemod.set_current(None)
                set_thread_rte(None)

        threads = [threading.Thread(target=run_rank, args=(st,),
                                    daemon=True,
                                    name=f"dvm-s{sess.sid}-r{st.rank}")
                   for st in sess.states]
        # the hang doctor reads the stacks of the run's rank threads
        sess.world.threads = threads
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        sess.run_start_ns = 0  # watchdog: no run in flight
        with self.lock:
            self._jobs += 1
        wus = int(wall * 1e6)
        # EWMA (alpha=1/4) run-wall estimator feeding deadline sheds
        if self.est_wall_us <= 0:
            self.est_wall_us = wus
        else:
            self.est_wall_us += (wus - self.est_wall_us) >> 2
        _pv_jobs.add(1, sess.sid)
        _pv_job_wall_us.add(wus, sess.sid)
        if not failure[0]:
            _pv_sli_goodput.add(wus, sess.sid)
        _obs.record_event(_obs.EV_DVM_RUN, sess.sid, failure[0] or 0,
                          int(wall * 1000))
        if sess.tid:
            _obs.record_event(_obs.EV_REQ_RUN, sess.sid, sess.tid,
                              sess.span, int(wall * 1000))
        tr = trace.global_tracer()
        if tr is not None:
            tr.instant("dvm_run", "serve", sid=sess.sid,
                       code=failure[0] or 0,
                       wall_ms=int(wall * 1000))
        return (failure[0] or 0, out.value(), err.value(), wall)

    def _detach(self, sid: int, force: bool = False) -> None:
        with self.lock:
            sess = self.sessions.get(sid)
            if sess is None:
                raise DvmError(f"unknown session s{sid} "
                               "(already detached?)")
            if sess.detaching:
                return
            if sess.running and not force:
                # finalizing/scrubbing a world while rank-threads are
                # executing in it breaks the isolation contract; only
                # drain (which already waited out its deadline) and
                # owner-death cleanup may force through
                raise DvmError(f"session s{sid} has a run in "
                               "progress; detach after it completes")
            sess.detaching = True
        _obs.record_event(_obs.EV_DVM_DETACH, sid)
        self._jrec({"t": "detach", "sid": sid})
        self._destroy(sess)
        self._release(sess)
        self._write_proctable()

    def _destroy(self, sess: _Session) -> None:
        from ompi_tpu_torch.runtime import state as statemod
        from ompi_tpu_torch.runtime.init import mpi_finalize
        from ompi_tpu_torch.runtime.rte import set_thread_rte

        if not sess.dead:
            def fin(st) -> None:
                try:
                    set_thread_rte(st.rte)
                    statemod.set_current(st)
                    st.serve_resident = False
                    if st.initialized and not st.finalized:
                        mpi_finalize(st)
                except BaseException:  # noqa: BLE001 — teardown of one
                    pass  # session must never take the pool down
                finally:
                    statemod.set_current(None)
                    set_thread_rte(None)

            threads = [threading.Thread(
                target=fin, args=(st,), daemon=True,
                name=f"dvm-s{sess.sid}-fin-r{st.rank}")
                for st in sess.states if st is not None]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        # a dead session's world is poisoned: fences would only time
        # out, so skip the graceful finalize and let GC take the world
        self._scrub(sess)

    def _scrub(self, sess: _Session) -> None:
        """Sweep the session's KV namespace (data, counters, put-once
        tickets, the namespace abort record) and its session dir —
        the pool is long-lived, leaks accumulate forever."""
        from ompi_tpu_torch.runtime.kvstore import KVClient
        try:
            kvc = KVClient(self.kv_server.uri, ns=sess.ns)
            kvc.purge("")
            kvc.close()
        except OSError:
            pass
        if sess.dir:
            import shutil
            shutil.rmtree(sess.dir, ignore_errors=True)

    # -- drain / proctable -------------------------------------------------

    def _drain(self) -> int:
        with self.lock:
            self._draining = True
        self._pump()  # flushes every queued waiter with "pool is halting"
        deadline = time.monotonic() + max(0.0, _drain_var.value)
        while time.monotonic() < deadline:
            with self.lock:
                if not any(s.running for s in self.sessions.values()):
                    break
            time.sleep(0.05)
        with self.lock:
            sids = list(self.sessions)
        for sid in sids:
            try:
                self._detach(sid, force=True)
            except DvmError:
                pass
        with self.lock:
            return self._jobs

    def _write_proctable(self) -> None:
        if not self.uri_file:
            return
        # _pt_lock serializes snapshot+write: concurrent attach/detach
        # writers share ONE fixed tmp path, so unserialized they could
        # interleave into (and then publish) a torn JSON file, or
        # os.replace a stale snapshot over a newer one
        with self._pt_lock:
            host = socket.gethostname()
            pid = os.getpid()
            entries = [{"tag": "pool", "pid": pid, "host": host,
                        "thread": "dvm-accept"}]
            with self.lock:
                sessions = list(self.sessions.values())
            for sess in sessions:
                for r in range(sess.np):
                    ent = {"tag": f"s{sess.sid}:r{r}",
                           "pid": pid, "host": host,
                           "thread": f"dvm-s{sess.sid}-r{r}"}
                    if self.hosts > 1:
                        # failure-domain column: which host's death
                        # takes this rank with it
                        ent["hdom"] = self._place_node(sess, r)
                    entries.append(ent)
            path = self.uri_file + ".proctable.json"
            try:
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(entries, f, indent=1)
                os.replace(tmp, path)
            except OSError:
                pass  # diagnostics must never take the pool down

# -- client -----------------------------------------------------------------

class DvmClient:
    """Session-multiplexing client.  Heartbeat-aware: while a request
    is in flight the pool beats every dvm_heartbeat_s; a client that
    misses ~3 beats raises a friendly DvmError instead of the old
    settimeout(None) forever-hang.

    Crash recovery: ``attach`` hands back a session
    token; if the pool connection dies mid-``run`` the client re-reads
    the uri file (a supervisor-respawned server rewrites it with a NEW
    incarnation id), reconnects, ``reattach``es by token, and replays
    the run under its original client-generated jobid — the server's
    journal-backed dedup makes the replay exactly-once."""

    def __init__(self, uri_file: str,
                 connect_timeout: float = 10.0) -> None:
        self.uri_file = uri_file
        self.incarnation: Optional[str] = None
        self._tokens: Dict[int, str] = {}
        self._tids: Dict[int, int] = {}  # sid -> request trace id
        self._jobid_n = itertools.count()
        self._dial(connect_timeout)
        self._hb = max(0.5, float(_hb_var.value))
        from ompi_tpu_torch import ft_inject
        self._inject = ft_inject.dvm_injector(0)

    def _dial(self, connect_timeout: float = 10.0) -> None:
        """(Re)connect from the uri file.  Line 1 is host:port (the
        original one-line format still parses); line 2, when present,
        is the incarnation doc — a changed incarnation means the
        server was restarted behind the same file."""
        try:
            with open(self.uri_file) as f:
                host, _, port = f.readline().strip().partition(":")
                doc_line = f.readline().strip()
        except FileNotFoundError:
            raise DvmError(
                f"DVM uri-file {self.uri_file} not found — is the "
                "pool running?  (start one: python -m "
                "ompi_tpu_torch.tools.dvm "
                f"--np N --uri-file {self.uri_file})") from None
        try:
            self.sock = socket.create_connection(
                (host, int(port)), timeout=connect_timeout)
        except OSError as e:
            raise DvmError(
                f"stale uri-file {self.uri_file}: no DVM pool "
                f"listening at {host}:{port} ({e}) — the pool has "
                "likely exited; remove the file and start a new "
                "pool") from None
        self.incarnation = None
        if doc_line:
            try:
                self.incarnation = json.loads(doc_line).get(
                    "incarnation")
            except ValueError:
                pass

    def _await(self, deadline: Optional[float] = None) -> dict:
        while True:
            if deadline is not None and time.monotonic() > deadline:
                raise DvmError("deadline exceeded waiting for the "
                               "DVM pool")
            self.sock.settimeout(max(5.0, 3.0 * self._hb))
            try:
                resp = _recv(self.sock)
            except socket.timeout:
                raise DvmError(
                    "DVM pool stopped responding (no heartbeat for "
                    f"{max(5.0, 3.0 * self._hb):.0f}s) — the pool is "
                    "hung or dead") from None
            except OSError as e:
                raise DvmDisconnect(
                    f"lost connection to the DVM pool: {e}") from None
            if resp is None:
                raise DvmDisconnect("DVM pool closed the connection")
            if resp.get("event") == "hb":
                continue
            return resp

    def _rpc(self, msg: dict,
             deadline: Optional[float] = None) -> dict:
        try:
            _send(self.sock, msg)
        except OSError as e:
            raise DvmDisconnect(
                f"lost connection to the DVM pool: {e}") from None
        return self._await(deadline)

    def _reconnect(self, sid: int,
                   timeout: float = 30.0) -> List[str]:
        """Kill-to-reattach recovery: poll the uri file until a live
        server answers (the supervisor needs a moment to respawn),
        then re-bind the session by token.  Returns the jobids the
        server journaled as in-flight at the crash (the caller must
        resubmit those).  Raises DvmError when the session cannot be
        recovered — never silently."""
        token = self._tokens.get(sid)
        if token is None:
            raise DvmError(f"cannot recover session s{sid}: no "
                           "session token (attached elsewhere?)")
        try:
            self.sock.close()
        except OSError:
            pass
        deadline = time.monotonic() + timeout
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                self._dial(connect_timeout=2.0)
                resp = self._rpc({"op": "reattach", "sid": sid,
                                  "token": token})
            except DvmDisconnect as e:
                last = e  # dialed a dying socket: keep polling
                time.sleep(0.05)
                continue
            except DvmError as e:
                last = e  # uri file stale/missing: server respawning
                time.sleep(0.05)
                continue
            if "error" in resp:
                # the server ANSWERED: this verdict is final (bad
                # token, session truly gone) — do not spin on it
                raise DvmError(f"session s{sid} not recovered: "
                               f"{resp['error']}")
            return list(resp.get("inflight") or [])
        raise DvmError(
            f"session s{sid} not recovered within {timeout:.0f}s: "
            f"{last}")

    @staticmethod
    def _raise_typed(resp: dict) -> None:
        if resp.get("shed"):
            raise DvmDeadline(resp["error"])
        raise (DvmBusy if resp.get("busy") else DvmError)(
            resp["error"])

    def attach(self, np_: int, wait: bool = True,
               timeout: Optional[float] = None, priority: int = 0,
               preemptible: bool = False) -> dict:
        msg: Dict[str, Any] = {"op": "attach", "np": np_,
                               "wait": wait, "timeout": timeout,
                               "priority": priority,
                               "preemptible": preemptible}
        tid = 0
        if _reqtrace.enabled():
            # mint the request trace context HERE, at the client edge —
            # everything downstream (RPC, admission queue, rank
            # tracers, KV plane, flight events) carries this id
            tid, span = _reqtrace.mint()
            msg["tid"] = tid
            msg["span"] = span
        resp = self._rpc(
            msg,
            deadline=(time.monotonic() + timeout + 30.0)
            if timeout else None)
        if "error" in resp:
            self._raise_typed(resp)
        if "token" in resp:
            self._tokens[int(resp["sid"])] = resp["token"]
        if tid:
            self._tids[int(resp["sid"])] = tid
            resp["tid"] = tid
        return resp

    def reattach(self, sid: int, token: Optional[str] = None) -> dict:
        """Re-bind a session on this connection by token (after a
        reconnect, or from a different client process that was handed
        the token).  Returns the server reply, whose ``inflight`` list
        names jobids journaled as started but never completed."""
        if token is not None:
            self._tokens[sid] = token
        tok = self._tokens.get(sid)
        if tok is None:
            raise DvmError(f"reattach s{sid}: no session token")
        resp = self._rpc({"op": "reattach", "sid": sid, "token": tok})
        if "error" in resp:
            self._raise_typed(resp)
        return resp

    def run(self, sid: int, prog: str, args=(),
            timeout: Optional[float] = None,
            deadline_ms: Optional[int] = None) -> dict:
        msg: Dict[str, Any] = {"op": "run", "sid": sid,
                               "prog": os.path.abspath(prog),
                               "args": list(args),
                               "jobid": f"c{os.getpid()}-"
                                        f"{next(self._jobid_n)}"}
        if deadline_ms is not None:
            msg["deadline_ms"] = int(deadline_ms)
        tid = self._tids.get(sid)
        if tid:
            # every run shares the session's attach-minted trace id
            # and carries its own span — a (tid, span) pair names one
            # causal step of the request
            msg["tid"] = tid
            msg["span"] = _reqtrace.next_span()
        try:
            _send(self.sock, msg)
        except OSError as e:
            if sid in self._tokens:
                return self._replay_run(sid, msg, timeout)
            raise DvmError(
                f"lost connection to the DVM pool: {e}") from None
        if self._inject is not None and self._inject.disconnect():
            # chaos (ft_inject dvm_disconnect): the run request is in
            # flight — die NOW, mid-collective from the pool's view.
            # The pool must finish/poison only this session.
            self.close()
            raise DvmError(
                "ft_inject dvm_disconnect: client dropped mid-run")
        try:
            resp = self._await(
                time.monotonic() + timeout if timeout else None)
        except DvmDisconnect:
            if sid in self._tokens:
                # the pool died with our run in flight: reconnect
                # (the supervisor respawns it), reattach by token,
                # and resubmit THE SAME jobid — the journal dedup
                # makes this exactly-once, never silently lost
                return self._replay_run(sid, msg, timeout)
            raise
        if "error" in resp:
            self._raise_typed(resp)
        return resp

    def _replay_run(self, sid: int, msg: dict,
                    timeout: Optional[float]) -> dict:
        self._reconnect(sid)
        resp = self._rpc(msg, deadline=(time.monotonic() + timeout
                                        if timeout else None))
        if "error" in resp:
            self._raise_typed(resp)
        return resp

    def resize(self, np_: int) -> dict:
        """Live-resize the pool's rank capacity (no drain)."""
        resp = self._rpc({"op": "resize", "np": np_})
        if "error" in resp:
            self._raise_typed(resp)
        return resp

    def detach(self, sid: int) -> dict:
        resp = self._rpc({"op": "detach", "sid": sid})
        if "error" in resp:
            raise DvmError(resp["error"])
        return resp

    def submit_job(self, np_: int, prog: str, args=(),
                   timeout: Optional[float] = None) -> dict:
        return self._rpc(
            {"op": "submit", "np": np_,
             "prog": os.path.abspath(prog), "args": list(args),
             "timeout": timeout},
            deadline=time.monotonic() + timeout if timeout else None)

    def kill_host(self, host: int) -> dict:
        """Sever a whole host failure domain (agent + ranks)."""
        resp = self._rpc({"op": "host_kill", "host": host})
        if "error" in resp:
            raise DvmError(resp["error"])
        return resp

    def respawn_host(self, host: int) -> dict:
        """Rejoin a lost host domain; resp['mttr_ms'] is the MTTR."""
        resp = self._rpc({"op": "host_respawn", "host": host})
        if "error" in resp:
            raise DvmError(resp["error"])
        return resp

    def halt(self) -> dict:
        return self._rpc({"op": "halt"})

    def ping(self) -> dict:
        return self._rpc({"op": "ping"})

    def stats(self) -> dict:
        return self._rpc({"op": "stats"})

    def metrics(self, events: int = 16,
                prometheus: Optional[bool] = None) -> dict:
        """Live telemetry scrape: pvar snapshot,
        per-session attribution, aggregated latency histograms with
        p50/p90/p99, and the flight-recorder tail — without stopping
        any resident rank."""
        msg: Dict[str, Any] = {"op": "metrics", "events": int(events)}
        if prometheus is not None:
            msg["prometheus"] = bool(prometheus)
        return self._rpc(msg)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self) -> "DvmClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# -- legacy one-shot helpers ------------------------------------------------

_jobid_counter = itertools.count()


def run_job_inproc(np_: int, prog: str, args: List[str],
                   devices) -> tuple:
    """One job as rank-threads in THIS process (hostrun model), with
    a job-private KV server and session dir.  Returns (exit_code,
    stdout_text, stderr_text).  Kept for embedders that want the
    serial model without a service plane; the jobid rides a
    process-monotonic counter (the old time.time()-ms scheme collided
    when two jobs started within a millisecond)."""
    import runpy

    from ompi_tpu_torch.runtime.kvstore import KVServer
    from ompi_tpu_torch.runtime.rte import (HybridRTE, HybridWorld,
                                            set_thread_rte)

    session = tempfile.mkdtemp(prefix="dvm_job_")
    server = KVServer(np_)
    world = HybridWorld(np_, 0, np_)
    jobid = f"dvm-{os.getpid()}-j{next(_jobid_counter)}"
    failure: List[Optional[int]] = [None]
    flock = threading.Lock()

    def run_rank(rank: int) -> None:
        try:
            rte = HybridRTE(world, rank, server.addr, node_id=0,
                            jobid=jobid, session_dir=session)
            if devices:
                rte.default_device = devices[rank % len(devices)]
            set_thread_rte(rte)
            runpy.run_path(prog, run_name="__main__")
        except SystemExit as e:
            code = e.code if isinstance(e.code, int) else (
                0 if e.code is None else 1)
            if code != 0:
                with flock:
                    failure[0] = failure[0] or code
        except BaseException:  # noqa: BLE001
            sys.stderr.write(f"[dvm rank {rank}] uncaught:\n"
                             f"{traceback.format_exc()}")
            with flock:
                failure[0] = failure[0] or 1
            if world.aborted is None:
                world.aborted = (rank, 1, "uncaught exception")

    out, err = _Tee(sys.__stdout__), _Tee(sys.__stderr__)
    old_argv = sys.argv
    sys.argv = [prog] + list(args)
    sys.stdout, sys.stderr = out, err
    try:
        threads = [threading.Thread(target=run_rank, args=(r,),
                                    daemon=True,
                                    name=f"dvm-rank-{r}")
                   for r in range(np_)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
        sys.argv = old_argv
        server.close()
        import shutil
        shutil.rmtree(session, ignore_errors=True)  # the pool is
        # long-lived: leaked per-job session dirs accumulate forever
    return (failure[0] or 0, out.buf.getvalue(), err.buf.getvalue())


class _Tee(io.TextIOBase):
    """Captures a job's stdout/stderr for the submitting client while
    still echoing to the DVM console (run_job_inproc legacy path)."""

    def __init__(self, real) -> None:
        self.real = real
        self.buf = io.StringIO()
        self.lock = threading.Lock()

    def write(self, s: str) -> int:
        with self.lock:
            self.buf.write(s)
        self.real.write(s)
        return len(s)

    def flush(self) -> None:
        self.real.flush()


# -- supervisor -------------------------------------------------------------

class Supervisor:
    """Respawn loop for a control-plane subprocess (the errmgr/HNP
    restart analog): start the child, wait, and while it keeps dying
    abnormally, start it again — the rewritten uri file plus journal
    rehydration make the respawn invisible to token-holding clients
    beyond a reconnect.  A clean exit (halt → rc 0) ends the loop."""

    def __init__(self, child_argv: List[str],
                 env: Optional[Dict[str, str]] = None,
                 max_restarts: int = 16,
                 respawn_env: Optional[Dict[str, str]] = None) -> None:
        self.child_argv = list(child_argv)
        self.env = env
        # chaos probes arm a one-shot ft_inject kill in the FIRST
        # child's env; respawns must come up with the plan cleared or
        # every incarnation re-arms and dies at the same op count —
        # respawn_env is the "kill once, then heal" environment
        self.respawn_env = respawn_env
        self.max_restarts = max_restarts
        self.restarts = 0
        self.proc: Any = None
        self._stop = False
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def _spawn(self):
        import subprocess
        env = self.env
        if self.restarts > 0 and self.respawn_env is not None:
            env = self.respawn_env
        return subprocess.Popen(self.child_argv, env=env)

    def run_forever(self) -> int:
        """Foreground mode (CLI --supervise): returns the child's
        final exit code once it exits cleanly or restarts are
        exhausted."""
        while True:
            with self._lock:
                if self._stop:
                    return 0
                self.proc = self._spawn()
            rc = self.proc.wait()
            if self._stop or rc == 0:
                return rc
            if self.restarts >= self.max_restarts:
                sys.stderr.write(
                    f"tpu-dvm supervisor: child died rc={rc} and "
                    f"restart budget ({self.max_restarts}) is spent "
                    "— giving up\n")
                return rc
            self.restarts += 1
            sys.stderr.write(
                f"tpu-dvm supervisor: child died rc={rc}; respawn "
                f"{self.restarts}/{self.max_restarts}\n")

    def start(self) -> "Supervisor":
        """Background mode (embedders, chaos probes)."""
        self._thread = threading.Thread(target=self.run_forever,
                                        daemon=True,
                                        name="dvm-supervisor")
        self._thread.start()
        return self

    def stop(self, kill: bool = False) -> None:
        with self._lock:
            self._stop = True
            proc = self.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.kill() if kill else proc.terminate()
            except OSError:
                pass
            try:
                proc.wait(timeout=10)
            except Exception:  # noqa: BLE001
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)



# -- CLI entry points -------------------------------------------------------

def pool_devices(choice: str) -> Optional[list]:
    """The devices a pool's session ranks take in turn (``--devices``):

    * ``auto`` — the cards, rank r on ``cuda:(r % count)``; CUDA is
      initialised here, once for the pool's life, with a context on
      every card.  Raises RuntimeError when there is no card: a pool
      asked for cards never runs its sessions on the CPU;
    * ``cpu`` — every rank on the CPU (the kernels' plain versions);
    * ``none`` — host-only ranks (None)."""
    if choice == "none":
        return None
    import torch
    if choice == "cpu":
        return [torch.device("cpu")]
    if choice != "auto":
        raise ValueError(f"--devices {choice!r}: auto, cpu or none")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "tpu-dvm --devices auto: no CUDA card is visible to the pool; "
            "no session was brought up (run with --devices cpu to use "
            "the CPU, or --devices none for host-only ranks)")
    cards = [torch.device("cuda", i) for i in range(count)]
    for d in cards:
        torch.empty(1, device=d)  # the card's context, made here once
    return cards


def serve(opts) -> int:
    try:
        devices = pool_devices(opts.devices)
    except (RuntimeError, ValueError) as e:
        sys.stderr.write(f"tpu-dvm: {e}\n")
        return 1
    server = DVMServer(opts.np, devices=devices, uri_file=opts.uri_file,
                       hosts=getattr(opts, "hosts", 1))
    # chaos: dvm_kill is armed ONLY here, on a real subprocess server
    # — an embedded pool shares the host process, and os._exit(70)
    # would take the host with it
    from ompi_tpu_torch import ft_inject
    server._kill = ft_inject.dvm_kill_injector()

    def _on_signal(signum, frame) -> None:
        # an operator (or supervisor) killed the pool: the flight
        # recorder and journal must outlive the process — the journal
        # is what the respawned incarnation rehydrates from
        try:
            server._persist_events(signal.Signals(signum).name)
        except Exception:  # noqa: BLE001
            pass
        j = server._journal
        if j is not None:
            j.tick()
        raise SystemExit(128 + signum)

    try:
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)
    except ValueError:
        pass  # not the main thread (embedded serve): skip handlers
    return server.serve_forever()


def submit(uri_file: str, np_: int, prog: str, args: List[str],
           timeout: Optional[float] = None) -> int:
    """Client side (used by mpirun --dvm): one-shot submit."""
    try:
        client = DvmClient(uri_file)
    except DvmError as e:
        sys.stderr.write(f"mpirun --dvm: {e}\n")
        return 1
    try:
        resp = client.submit_job(np_, prog, args, timeout=timeout)
    except DvmError as e:
        sys.stderr.write(f"mpirun --dvm: {e}\n")
        return 1
    finally:
        client.close()
    if "error" in resp:
        sys.stderr.write(f"mpirun --dvm: {resp['error']}\n")
        return 1
    sys.stdout.write(resp.get("stdout", ""))
    sys.stderr.write(resp.get("stderr", ""))
    return int(resp.get("code", 1))


def halt(uri_file: str) -> int:
    try:
        client = DvmClient(uri_file)
        try:
            resp = client.halt()
        finally:
            client.close()
    except DvmError as e:
        sys.stderr.write(f"tpu-dvm: {e}\n")
        return 1
    return 0 if resp.get("ok") else 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="tpu-dvm")
    ap.add_argument("--np", type=int, default=8,
                    help="rank capacity of the pool")
    ap.add_argument("--uri-file", default=None,
                    help="where to write the contact address")
    ap.add_argument("--devices", default="auto",
                    choices=("auto", "cpu", "none"),
                    help="auto: the CUDA cards (rank r on card r %% "
                         "count; exits non-zero without one), cpu: "
                         "every rank on the CPU, none: host-only ranks")
    ap.add_argument("--session-max", type=int, default=None,
                    help="max concurrently-resident sessions "
                         "(dvm_session_max)")
    ap.add_argument("--queue-max", type=int, default=None,
                    help="admission queue bound (dvm_queue_max)")
    ap.add_argument("--batch-window-us", type=int, default=None,
                    help="cross-session fused-dispatch window "
                         "(dvm_batch_window_us; 0 disables)")
    ap.add_argument("--halt", default=None, metavar="URI_FILE",
                    help="stop a running DVM")
    ap.add_argument("--resize", type=int, default=None, metavar="N",
                    help="live-resize a running DVM (named by "
                         "--uri-file) to N ranks, no drain")
    ap.add_argument("--ctrl", action="store_true",
                    help="enable the FleetController closed loop "
                         "(dvm_ctrl=1)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="host failure domains in the fleet: ranks "
                         "band contiguously across N domains, each "
                         "watched by a tpud host agent over the pool "
                         "port (silence = the whole domain fails as "
                         "one atomic ULFM record)")
    ap.add_argument("--kill-host", type=int, default=None,
                    metavar="H",
                    help="sever host domain H of a running fleet "
                         "(named by --uri-file): agent + ranks die "
                         "as one record")
    ap.add_argument("--respawn-host", type=int, default=None,
                    metavar="H",
                    help="rejoin host domain H of a running fleet; "
                         "prints the domain's MTTR")
    ap.add_argument("--supervise", action="store_true",
                    help="run the pool under a respawning supervisor: "
                         "an abnormally-dying server is restarted and "
                         "rehydrates its sessions from the journal "
                         "(clean halt ends the loop)")
    opts = ap.parse_args(argv)
    if opts.supervise:
        if not opts.uri_file:
            ap.error("--supervise needs --uri-file (the journal "
                     "lives next to it)")
        child = [sys.executable, "-m", "ompi_tpu_torch.tools.dvm"] + [
            a for a in (argv if argv is not None else sys.argv[1:])
            if a != "--supervise"]
        return Supervisor(child).run_forever()
    if opts.halt:
        return halt(opts.halt)
    if opts.kill_host is not None or opts.respawn_host is not None:
        if not opts.uri_file:
            ap.error("--kill-host/--respawn-host need --uri-file to "
                     "find the fleet")
        try:
            client = DvmClient(opts.uri_file)
            try:
                if opts.kill_host is not None:
                    client.kill_host(opts.kill_host)
                    sys.stderr.write(
                        f"tpu-dvm: host {opts.kill_host} severed\n")
                if opts.respawn_host is not None:
                    resp = client.respawn_host(opts.respawn_host)
                    sys.stderr.write(
                        f"tpu-dvm: host {opts.respawn_host} rejoined "
                        f"(mttr {resp.get('mttr_ms')} ms)\n")
            finally:
                client.close()
        except DvmError as e:
            sys.stderr.write(f"tpu-dvm: {e}\n")
            return 1
        return 0
    if opts.resize is not None:
        if not opts.uri_file:
            ap.error("--resize needs --uri-file to find the pool")
        try:
            client = DvmClient(opts.uri_file)
            try:
                resp = client.resize(opts.resize)
            finally:
                client.close()
        except DvmError as e:
            sys.stderr.write(f"tpu-dvm: {e}\n")
            return 1
        sys.stderr.write(
            f"tpu-dvm: resized {resp.get('was')} -> "
            f"{resp.get('capacity')} (epoch {resp.get('epoch')})\n")
        return 0
    if not opts.uri_file:
        ap.error("--uri-file is required to serve")
    if opts.session_max is not None:
        registry.set("dvm_session_max", opts.session_max)
    if opts.queue_max is not None:
        registry.set("dvm_queue_max", opts.queue_max)
    if opts.batch_window_us is not None:
        registry.set("dvm_batch_window_us", opts.batch_window_us)
    if opts.ctrl:
        registry.set("dvm_ctrl", 1)
    return serve(opts)


if __name__ == "__main__":
    sys.exit(main())
