"""ULFM-style rank-failure mitigation: detect -> ERR_PROC_FAILED ->
revoke / shrink / agree.

Port of the reference's ft/ulfm.py (a re-design of the ULFM
prototype's run-through-stabilization surface, ref: the MPI-4 FT
proposal's MPIX_Comm_revoke/shrink/agree + failure_ack,
ompi/communicator/ft and the errmgr framework):

* **detect** — a permanently dead rank (``kill_now``, the ft_inject
  ``rank_kill`` timer, a process rank or app shell that exited under
  mpirun's ulfm or respawn policy, a lost host domain of the resident
  pool) becomes a failure *record* carried world-wide: a thread-rank
  world delivers it directly to every survivor's ``UlfmState``; a job
  whose ranks live in several processes also appends
  ``ulfm:note:<n>`` records to the KV store, consumed by a per-rank
  watcher thread (``start_watcher``, started by ``init()`` for a rank
  launched with ``TPUMPI_ULFM=1``).  Each ingested failure bumps a
  monotonic local failure epoch.
* **report** — pending and future p2p/collective operations naming a
  failed peer complete with ``ERR_PROC_FAILED`` instead of hanging:
  ``pml/ob1`` has a ``ulfm_sweep`` that drains parked requests, and
  the coll shim, the device rendezvous's abort check and the window
  waits consult ``check_comm``.
* **mitigate** — ``Comm.revoke()`` poisons a communicator world-wide
  (in-flight ops drain with ``ERR_REVOKED``); ``Comm.agree(flag)``
  runs a fault-tolerant agreement whose decision is published
  put-once, so every survivor returns the SAME flag no matter when
  the killer strikes; ``Comm.shrink()`` returns a survivor
  communicator and drops every per-comm cache keyed on the old group.
* **observe** — detect/revoke/shrink/agree emit trace instants,
  flight-recorder events and ``ulfm_*`` pvars.

Agreement/shrink run over a *store*, not over p2p: the control plane
must stay usable on a communicator whose data plane is already revoked
or holed.  A thread-rank world holding every rank uses the world-shared
dict (``_InprocStore``); ranks in several processes use KV put-once
records (``_KvStore``).  The reference picks the KV store whenever the
rank has a KV client, a resident pool session included; the port keeps
a pool session, whose world holds every rank, on the shared dict.

The reference's shrink also drops compiled executables keyed on the
old mesh (``compile_cache.drop_mesh``); the
port has no process-wide compiled-program cache — its kernel libraries
do not depend on the device set, and the per-comm plan and pick
caches below are the whole purge.

Documented simplifications, as the reference's: an ANY_SOURCE receive
with unacknowledged failures completes with
``ERR_PROC_FAILED_PENDING``; rendezvous deposits of a dead generation
are abandoned (the shrunk comm gets a fresh rendezvous keyed on its
new cid).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, List, Optional, Set, Tuple

from ompi_tpu_torch import errhandler as _eh
from ompi_tpu_torch import obs as _obs
from ompi_tpu_torch import trace as _trace
from ompi_tpu_torch.mca.params import registry

_enable_var = registry.register(
    "mpi", "ft", "ulfm", True, bool,
    help="Attach the ULFM failure-mitigation layer at MPI_Init "
         "(detect dead ranks, raise MPI_ERR_PROC_FAILED, enable "
         "Comm.revoke/agree/shrink).  Off: permanent failures hang "
         "or abort, the pre-ULFM behavior")
_agree_timeout_var = registry.register(
    "mpi", "ft", "ulfm_agree_timeout", 60.0, float,
    help="Deadline (s) for the agree/shrink decision loop; expiry "
         "raises MPI_ERR_OTHER (survivors unreachable, not dead)")

_pv_failures = registry.register_pvar(
    "ulfm", "", "failures_detected",
    help="Rank failures ingested by this rank's ULFM state")
_pv_revokes = registry.register_pvar(
    "ulfm", "", "revokes",
    help="Communicator revocations ingested by this rank")
_pv_agreements = registry.register_pvar(
    "ulfm", "", "agreements",
    help="Fault-tolerant agreements completed by this rank")
_pv_shrink_us = registry.register_pvar(
    "ulfm", "", "shrink_rebuild_us", var_class="highwatermark",
    help="Slowest Comm.shrink on this rank: survivor agreement + "
         "communicator build + per-comm cache invalidation (us)")


class RankKilled(SystemExit):
    """Injected permanent rank death (``kill_now``, ft_inject
    ``rank_kill``).

    A SystemExit subclass on purpose: it must behave exactly like the
    process dying — no error handler may absorb the kill, and the
    ``except Exception`` clauses of the stack let it through."""


# -- per-rank state ---------------------------------------------------------


class UlfmState:
    """One per rank: the failure/revocation view plus the plumbing
    that turns delivered records into drained requests.

    ``active`` flips True on the first delivered record and never
    flips back — the hot-path cost while healthy is one attribute
    fetch and one falsy check (the trace-layer zero-cost contract)."""

    def __init__(self, state) -> None:
        self.state = state
        self.lock = threading.Lock()
        self.failed: Set[int] = set()          # global ranks
        self.acked: Set[int] = set()           # failure_ack'd ranks
        # revoked communicators as (cid, group-tuple): the group keeps
        # a revoke from poisoning an unrelated communicator that
        # shares the cid
        self.revoked: Set[Tuple[int, Tuple[int, ...]]] = set()
        self.epoch = 0                         # monotonic failure epoch
        self.active = False
        self._dirty = False
        self._seen: Set[tuple] = set()
        self._pending: List[tuple] = []
        # test seam: called at named agreement phases so kill-at-every-
        # phase tests are deterministic instead of timer-raced
        self._agree_test_hook = None

    # -- record delivery (any thread) -----------------------------------
    def deliver(self, rec: tuple) -> None:
        with self.lock:
            if rec in self._seen:
                return
            self._seen.add(rec)
            self._pending.append(rec)
            self._dirty = True
            self.active = True
        self.state.progress.wakeup()

    # -- ingestion (the rank's own thread, via poll) --------------------
    def poll(self) -> int:
        if not self._dirty:
            return 0
        with self.lock:
            pending, self._pending = self._pending, []
            self._dirty = False
        n = 0
        for rec in pending:
            n += self._ingest(rec)
        return n

    def _ingest(self, rec: tuple) -> int:
        if rec[0] == "fail":
            grank = int(rec[1])
            if grank == self.state.rank:
                # a respawned replacement meets its predecessor's
                # death record: its own rank is alive by construction
                return 0
            # a replacement still joining (ft/respawn) is the recovery
            # of its launch epoch: that epoch's records are the deaths
            # it replaces (its own, and those of the other ranks its
            # relaunched app shell holds)
            done = self.state.respawn_epoch + (
                1 if self.state.respawn_joining else 0)
            if len(rec) > 2 and int(rec[2]) <= done:
                # epoch-tagged record of a failure the respawn
                # protocol already recovered: ingesting it would
                # re-mark a revived rank dead forever
                return 0
            if grank in self.failed:
                return 0
            self.failed.add(grank)
            self._sync_rte()
            self.epoch += 1
            _pv_failures.add(1)
            _trace.instant_state(self.state, "ulfm_detect", "ft",
                                 failed=grank, epoch=self.epoch)
            _obs.record_event(_obs.EV_ULFM_DETECT, grank, self.epoch,
                              rank=self.state.rank)
        elif rec[0] == "revoke":
            key = (int(rec[1]), tuple(rec[2]))
            if key in self.revoked:
                return 0
            self.revoked.add(key)
            _pv_revokes.add(1)
            _trace.instant_state(self.state, "ulfm_revoke", "ft",
                                 cid=key[0])
            _obs.record_event(_obs.EV_ULFM_REVOKE, key[0],
                              rank=self.state.rank)
        else:
            return 0
        self._sweep_pml()
        return 1

    def unfail(self, grank: int) -> None:
        """Respawn rejoin (ft/respawn): ``grank`` has been replaced in
        place — stop treating it as dead.  The delivery dedup for its
        old failure records is cleared too, so a LATER kill of the same
        world rank is detected again (``active`` stays True: the
        entry-check cost is already paid and a re-kill must drain
        instantly)."""
        with self.lock:
            self.failed.discard(grank)
            self.acked.discard(grank)
            self._seen = {
                r for r in self._seen
                if not (r[0] == "fail" and int(r[1]) == grank)}
            self._pending = [
                r for r in self._pending
                if not (r[0] == "fail" and int(r[1]) == grank)]
        self._sync_rte()

    def _sync_rte(self) -> None:
        """A KV-fenced rank (EnvRTE, HybridRTE, a pool's SessionRTE)
        shrinks its fence quorum by this set: dead ranks never arrive
        at a fence."""
        rte = self.state.rte
        if getattr(rte, "kv", None) is not None:
            rte.ulfm_failed = set(self.failed)

    def _sweep_pml(self) -> None:
        sweep = getattr(self.state.pml, "ulfm_sweep", None)
        if sweep is not None:
            sweep(self.failed, self.revoked)

    def _progress_cb(self) -> int:
        return self.poll()

    # -- entry checks (raise, callers route through dispatch) -----------
    def check_comm(self, comm) -> None:
        """Collective-entry check: a revoked comm raises ERR_REVOKED,
        a comm with a failed member raises ERR_PROC_FAILED."""
        if (comm.cid, tuple(comm.group)) in self.revoked:
            raise _eh.MPIException(
                _eh.ERR_REVOKED,
                f"MPI_ERR_REVOKED: communicator {comm.name or comm.cid} "
                f"was revoked")
        dead = self.failed.intersection(comm.group)
        if dead:
            raise _eh.MPIException(
                _eh.ERR_PROC_FAILED,
                f"MPI_ERR_PROC_FAILED: rank(s) "
                f"{sorted(dead)} of {comm.name or comm.cid} failed")

    def check_peer(self, comm, peer: int) -> None:
        """P2P-entry check for an op naming comm-rank ``peer``."""
        if (comm.cid, tuple(comm.group)) in self.revoked:
            raise _eh.MPIException(
                _eh.ERR_REVOKED,
                f"MPI_ERR_REVOKED: communicator {comm.name or comm.cid} "
                f"was revoked")
        if peer >= 0:
            if comm.group[peer] in self.failed:
                raise _eh.MPIException(
                    _eh.ERR_PROC_FAILED,
                    f"MPI_ERR_PROC_FAILED: peer rank {peer} failed")
        else:  # ANY_SOURCE with unacknowledged failures
            pending = (self.failed.intersection(comm.group)
                       - self.acked)
            if pending:
                raise _eh.MPIException(
                    _eh.ERR_PROC_FAILED_PENDING,
                    f"MPI_ERR_PROC_FAILED_PENDING: unacknowledged "
                    f"failed rank(s) {sorted(pending)}")


def attach(state) -> Optional[UlfmState]:
    """Install a UlfmState on ``state`` (before pml selection, so the
    pml can cache the reference) and hook the progress engine."""
    if not _enable_var.value:
        state.ulfm = None
        return None
    u = UlfmState(state)
    state.ulfm = u
    state.progress.register(u._progress_cb)
    return u


# -- failure/revoke publication ---------------------------------------------


def publish_world_failure(world, grank: int) -> None:
    """Thread-rank delivery: mark the rank failed on the world (its
    fences stop counting it) and deliver the record to every live
    rank's UlfmState."""
    publish_world_failures(world, (grank,))


def publish_world_failures(world, granks) -> None:
    """Atomic failure-DOMAIN delivery: mark EVERY rank in ``granks``
    failed before any waiter wakes, so several deaths surface as one
    consistent failure set, never racing single-rank detections with
    fences recounting quorum between them.

    The records are delivered under the fence cv, which respawn's
    rejoin also holds while it un-fails a replaced rank: a survivor
    can reach rejoin through another survivor's revoke before its own
    record of the death arrived, and a record landing after its
    un-fail would fail the replacement again on the new communicator.
    (The reference delivers after releasing the cv and has that
    race.)"""
    cv = world._f_cv
    with cv:  # release anyone parked in a fence: its quorum shrank
        for grank in granks:
            world.ulfm_failed.add(int(grank))
        for st in list(world.states):
            u = getattr(st, "ulfm", None)
            if u is not None:
                for grank in granks:
                    u.deliver(("fail", int(grank)))
        cv.notify_all()


def _kv_note(state, rec: list) -> None:
    """Append a ``ulfm:note:<n>`` record for the ranks of other
    processes (their watchers consume it)."""
    kv = getattr(state.rte, "kv", None)
    if kv is None:
        return
    try:
        n = kv.incr("ulfm:nseq")
        kv.put(f"ulfm:note:{n}", rec)
    except (ConnectionError, OSError, RuntimeError):
        pass  # control plane gone: local delivery still drains us


def publish_failure(state, grank: int) -> None:
    """Propagate a suspected-permanent rank failure job-wide: direct
    delivery in a thread-rank world, a ``ulfm:note:<n>`` KV record for
    ranks in other processes (each rank's watcher consumes it)."""
    world = getattr(state.rte, "world", None)
    if world is not None and hasattr(world, "ulfm_failed"):
        publish_world_failure(world, grank)
    # the note carries the recovery epoch this failure opens, as
    # mpirun's respawn notes do: a replacement replaying the note
    # stream drops the deaths its own epoch replaces (the reference's
    # note carries none, and a relaunched app shell's ranks would fail
    # each other again on a survivor's transport-detected note)
    _kv_note(state, ["fail", int(grank), state.respawn_epoch + 1])
    u = getattr(state, "ulfm", None)
    if u is not None:
        u.deliver(("fail", int(grank)))


def publish_revoke(comm) -> None:
    """MPIX_Comm_revoke: poison ``comm`` world-wide.  Not collective —
    any member may revoke; the notice reaches every rank through the
    same channel failure records ride."""
    state = comm.state
    rec = ("revoke", int(comm.cid), tuple(comm.group))
    world = getattr(state.rte, "world", None)
    if world is not None and hasattr(world, "states"):
        for st in list(world.states):
            u = getattr(st, "ulfm", None)
            if u is not None:
                u.deliver(rec)
    _kv_note(state, ["revoke", int(comm.cid), list(comm.group)])
    u = getattr(state, "ulfm", None)
    if u is not None:
        u.deliver(rec)
        u.poll()  # the revoker's own parked ops drain immediately


# -- KV watcher (ranks of a job in several processes) -----------------------


def start_watcher(state) -> None:
    """Consume ``ulfm:note:<n>`` records from the KV store on a daemon
    thread with its own KVClient (the shared client is single-threaded
    by contract).  The notes come from mpirun's errmgr (a dead process
    rank or app shell) and from ranks of other processes (their
    revokes and the deaths they saw)."""
    addr = os.environ.get("TPUMPI_KV_ADDR")
    if not addr or getattr(state, "ulfm", None) is None:
        return
    ns = getattr(getattr(state.rte, "kv", None), "ns", None)

    def run() -> None:
        from ompi_tpu_torch.runtime.kvstore import KVClient
        try:
            kv = KVClient(addr, ns=ns)
        except (OSError, RuntimeError):
            return
        n = 0
        while True:
            try:
                rec = kv.get(f"ulfm:note:{n}", timeout=3600.0)
            except (RuntimeError, OSError, TimeoutError):
                if state.finalized:
                    return
                continue
            n += 1
            u = state.ulfm
            if u is None or state.finalized:
                return
            if rec and rec[0] == "fail":
                # respawn-policy notes carry the recovery epoch the
                # failure opens; _ingest drops stale epochs so note
                # replay after a rejoin cannot re-kill a revived rank
                if len(rec) > 2:
                    u.deliver(("fail", int(rec[1]), int(rec[2])))
                else:
                    u.deliver(("fail", int(rec[1])))
            elif rec and rec[0] == "revoke":
                u.deliver(("revoke", int(rec[1]), tuple(rec[2])))

    threading.Thread(target=run, daemon=True,
                     name=f"ulfm-watcher-{state.rank}").start()


# -- injected kills ---------------------------------------------------------


def arm_rank_kill(state, after_s: float) -> None:
    """ft_inject ``rank_kill``: after ``after_s`` the victim's next
    progress sweep raises RankKilled — out of whatever wait it is
    parked in (every blocking wait runs progress, so armed interrupts
    escape blocking calls)."""

    def fire() -> None:
        if state.finalized:
            return
        _trace.instant_state(state, "ft_inject", "ft",
                             cls="rank_kill", rank=state.rank)
        _obs.record_event(_obs.EV_FT_INJECT, _obs.intern("rank_kill"),
                          _obs.intern("rank"), rank=state.rank)
        # this incarnation can never finalize: let process-wide
        # last-rank accounting (coll.device) stop waiting for it
        state.ulfm_dead = True
        state.progress.interrupt = RankKilled(
            f"ft_inject rank_kill: rank {state.rank}")
        state.progress.wakeup()

    t = threading.Timer(max(0.0, after_s), fire)
    t.daemon = True
    t.start()


def kill_now(state):
    """Deterministic in-line kill for tests and chip_smoke: the
    calling rank dies HERE (no timer race)."""
    state.ulfm_dead = True
    raise RankKilled(f"rank {state.rank} killed (ulfm.kill_now)")


# -- the agreement/shrink store ---------------------------------------------


class _InprocStore:
    """Thread-rank backend: the world-shared dict under its lock."""

    def __init__(self, world) -> None:
        self.world = world

    def put_once(self, key: tuple, value: Any) -> bool:
        with self.world.shared_lock:
            if key in self.world.shared:
                return False
            self.world.shared[key] = value
            return True

    def try_get(self, key: tuple) -> Any:
        with self.world.shared_lock:
            return self.world.shared.get(key)

    def next_cid(self) -> int:
        # shrink cids live far above next_cid_local's counting range
        with self.world.shared_lock:
            n = self.world.shared.get(("ulfm", "cid"), 4096)
            self.world.shared[("ulfm", "cid")] = n + 1
            return n


class _KvStore:
    """Backend of ranks in several processes: KV put-once via
    incr-claim (the first caller's pre-increment is 0 — it owns the
    write)."""

    def __init__(self, kv) -> None:
        self.kv = kv

    @staticmethod
    def _k(key: tuple) -> str:
        return "ulfm:" + ":".join(str(p) for p in key)

    def put_once(self, key: tuple, value: Any) -> bool:
        return self.kv.put_once(self._k(key), value)

    def try_get(self, key: tuple) -> Any:
        try:
            return self.kv.get(self._k(key), timeout=0.05)
        except (TimeoutError, RuntimeError):
            return None

    def next_cid(self) -> int:
        return 4096 + self.kv.incr("ulfm:cid")


def _all_local(world) -> bool:
    """Does this thread world hold every rank (a ``run_ranks`` world, a
    pool session) — so its shared dict sees every agreement?"""
    return (world is not None and hasattr(world, "shared")
            and getattr(world, "nlocal", world.size) >= world.size)


def _store(state):
    world = getattr(state.rte, "world", None)
    if _all_local(world):
        return _InprocStore(world)
    kv = getattr(state.rte, "kv", None)
    if kv is not None:
        return _KvStore(kv)
    raise RuntimeError(
        "ULFM agreement needs a store every rank sees: the world-shared "
        "table of a thread world holding every rank, or the launcher's "
        "KV store")


def _require(comm) -> UlfmState:
    u = comm.state.ulfm
    if u is None:
        raise RuntimeError(
            "ULFM is disabled (--mca mpi_ft_ulfm 0): "
            "revoke/agree/shrink unavailable")
    return u


def _tick(comm) -> None:
    """One decision-loop beat: run progress (armed interrupts — e.g. a
    rank_kill landing mid-agreement — fire here) and yield."""
    comm.state.progress.progress()
    time.sleep(0.0005)


# -- MPIX_Comm_agree --------------------------------------------------------


def agree(comm, flag) -> bool:
    """Fault-tolerant agreement: returns the AND of the contributed
    flags, identical on every survivor regardless of when members die.

    Two-phase over the store: (1) every member publishes its
    contribution put-once; (2) the lowest-ranked *live* member gathers
    the contributions of everyone not known-failed and publishes the
    decision put-once.  A leader dying mid-gather just promotes the
    next survivor; because the decision is put-once, a late write from
    a zombie leader cannot split the outcome."""
    u = _require(comm)
    store = _store(comm.state)
    seq = comm.__dict__.get("_ulfm_agree_seq", 0)
    comm.__dict__["_ulfm_agree_seq"] = seq + 1
    base = ("agree", comm.cid, tuple(comm.group), seq)
    hook = u._agree_test_hook
    u.poll()
    if hook is not None:
        hook("pre_contrib")
    store.put_once(base + ("c", comm.rank), bool(flag))
    if hook is not None:
        hook("post_contrib")
    deadline = time.monotonic() + max(1.0, _agree_timeout_var.value)
    while True:
        d = store.try_get(base + ("d",))
        if d is not None:
            if hook is not None:
                hook("post_decision")
            _pv_agreements.add(1)
            _trace.instant_state(comm.state, "ulfm_agree", "ft",
                                 cid=comm.cid, seq=seq,
                                 flag=bool(d["flag"]))
            _obs.record_event(_obs.EV_ULFM_AGREE, comm.cid, seq,
                              int(bool(d["flag"])),
                              rank=comm.state.rank)
            return bool(d["flag"])
        u.poll()
        live = [r for r in range(comm.size)
                if comm.group[r] not in u.failed]
        if live and live[0] == comm.rank:
            vals: List[bool] = []
            complete = True
            for r in range(comm.size):
                v = store.try_get(base + ("c", r))
                if v is not None:
                    vals.append(bool(v))
                elif comm.group[r] not in u.failed:
                    complete = False
                    break
            if complete:
                if hook is not None:
                    hook("pre_decision")
                store.put_once(base + ("d",), {"flag": all(vals)})
                continue
        if time.monotonic() > deadline:
            raise _eh.MPIException(
                _eh.ERR_OTHER,
                f"ulfm agree timed out on {comm.name or comm.cid}")
        _tick(comm)


# -- MPIX_Comm_shrink -------------------------------------------------------

# per-comm cached plans/verdicts that key on the OLD group or device
# set: the reference's keys that the port has, plus the port-only
# per-group caches (the cart neighbour-source table)
_COMM_CACHE_KEYS = (
    # coll/seg: the eligibility verdict, the mapped segment (its
    # generation counters belong to the old epoch) and the repeat plan
    "_seg_eligible", "_coll_seg", "_seg_ar_plan",
    "_hbm_one_device", "_device_rv", "_device_abort_check",
    "_mesh_none", "_mesh", "_fusion_engine", "_dev_seq",
    # large-message tier (coll/pipeline + topo): routing thresholds,
    # hierarchy plans and the cart device mesh all key on the old
    # group — segment state must not leak across shrink/respawn epochs
    "_pipeline_pick", "_hier_eligible", "_hier_plan",
    "_cart_device_mesh",
    # resolved collective plans (coll/plan): a Plan holds the old
    # device list and its destination tables
    "_coll_plans",
    # osc framework: the per-window component verdict keys on the old
    # device set, so a shrunk comm must re-decide
    "_osc_pick",
    # topo/neighbor: the cart's per-member source table (port-only)
    "_nbr_sources",
    # placement verdicts: the tuned module's oversubscription verdict
    # (every member must pick the same algorithm, and a live
    # recovery's re-routed ranks oversubscribe a survivor node) and
    # coll/device's "does this comm span processes" answer
    "_oversub_verdict", "_spans_procs",
)

# the subset safe to purge while a comm stays LIVE: pure routing
# thresholds whose recompute is rank-local (coll/autotune re-resolves
# them online when the calibrate profile moves).  _hier_plan and the
# rendezvous caches are NOT here — their rebuild is collective
# (subcomm construction) and may only happen at epoch boundaries.
# _coll_plans qualifies: a Plan rebuild is rank-local and keys on the
# calibrated segment size, which is exactly what an autotune fold moves
SELECTION_CACHE_KEYS = ("_pipeline_pick", "_osc_pick", "_coll_plans")


def purge_comm_caches(comm, keys=_COMM_CACHE_KEYS) -> None:
    """Drop per-comm cached plans/verdicts.  The full key list is the
    shrink/respawn epoch boundary; callers on a live comm must pass
    SELECTION_CACHE_KEYS (see above)."""
    for k in keys:
        comm.__dict__.pop(k, None)


def _invalidate(comm) -> None:
    """Drop everything keyed on the dying comm's group: its per-comm
    plans and verdicts, its device rendezvous (deposits, recorded
    events or half-read results a killed member left behind), and the
    shard tables of device windows on it."""
    purge_comm_caches(comm)
    world = getattr(comm.state.rte, "world", None)
    if world is not None and hasattr(world, "shared"):
        group = tuple(comm.group)
        with world.shared_lock:
            world.shared.pop(("coll_rv", comm.cid, group), None)
            # device-osc shard tables of windows on the dying comm:
            # the shards belong to the old group and must not be
            # resurrected by a cid reuse after recovery
            dead = [k for k in world.shared
                    if isinstance(k, tuple) and k and
                    k[0] == "osc_devwin" and k[1] == comm.cid and
                    k[2] == group]
            for k in dead:
                world.shared.pop(k, None)


# -- store hygiene ----------------------------------------------------------

# first elements of world.shared tuple keys owned by the ULFM/respawn
# control plane
_STORE_KEY_HEADS = ("agree", "shrink", "respawn", "ulfm")


def purge_tickets(state) -> None:
    """Epoch-rollover hygiene: drop consumed agreement/shrink tickets
    (contributions and decisions).  Respawn decisions are kept until
    finalize (run_ranks' supervision loop reads them)."""
    world = getattr(state.rte, "world", None)
    if world is not None and hasattr(world, "shared"):
        with world.shared_lock:
            for k in [k for k in world.shared
                      if isinstance(k, tuple) and k
                      and k[0] in ("agree", "shrink")]:
                del world.shared[k]
    kv = getattr(state.rte, "kv", None)
    if kv is not None and not _all_local(world):
        try:
            kv.purge("ulfm:agree:")
            kv.purge("ulfm:shrink:")
        except (ConnectionError, OSError, RuntimeError):
            pass


def purge_store(state) -> None:
    """Finalize hygiene: remove every ULFM record this world wrote —
    agreement/shrink/respawn tickets and the shrink cid counter — so
    a looped world starts with a clean failure plane."""
    world = getattr(state.rte, "world", None)
    if world is not None and hasattr(world, "shared"):
        with world.shared_lock:
            for k in [k for k in world.shared
                      if isinstance(k, tuple) and k
                      and k[0] in _STORE_KEY_HEADS]:
                del world.shared[k]
    kv = getattr(state.rte, "kv", None)
    if kv is not None:
        # the KV half: failure notes, the note sequence counter and
        # the KV tickets
        try:
            kv.purge("ulfm:")
        except (ConnectionError, OSError, RuntimeError):
            pass


def shrink(comm, name: str = ""):
    """MPIX_Comm_shrink: revoke the old communicator, agree on the
    failed set, build the survivor communicator (fresh cid from the
    store so every member lands on the same one), and invalidate what
    the old group cached.

    The revoke is the port's, not the reference's: a member can die
    right after completing its part of a collective on ``comm``, so
    one survivor raises ERR_PROC_FAILED at a p2p entry check while
    another still waits on a message from that (live) survivor — and
    then never reaches the agreement.  Revoking first drains every
    such wait with ERR_REVOKED (the MPI-4 FT recovery idiom, revoke
    then shrink, done by the call itself); the old comm is being
    replaced, so nothing valid is lost."""
    u = _require(comm)
    store = _store(comm.state)
    t0 = time.perf_counter()
    publish_revoke(comm)
    u.poll()
    seq = comm.__dict__.get("_ulfm_shrink_seq", 0)
    comm.__dict__["_ulfm_shrink_seq"] = seq + 1
    base = ("shrink", comm.cid, tuple(comm.group), seq)
    store.put_once(base + ("c", comm.rank),
                   sorted(u.failed.intersection(comm.group)))
    deadline = time.monotonic() + max(1.0, _agree_timeout_var.value)
    while True:
        d = store.try_get(base + ("d",))
        if d is not None:
            break
        u.poll()
        live = [r for r in range(comm.size)
                if comm.group[r] not in u.failed]
        if live and live[0] == comm.rank:
            union: Set[int] = set(u.failed.intersection(comm.group))
            complete = True
            for r in range(comm.size):
                v = store.try_get(base + ("c", r))
                if v is not None:
                    union.update(int(x) for x in v)
                elif comm.group[r] not in u.failed:
                    complete = False
                    break
            if complete:
                store.put_once(base + ("d",), {
                    "failed": sorted(union), "cid": store.next_cid()})
                continue
        if time.monotonic() > deadline:
            raise _eh.MPIException(
                _eh.ERR_OTHER,
                f"ulfm shrink timed out on {comm.name or comm.cid}")
        _tick(comm)
    decided = set(int(x) for x in d["failed"])
    survivors = [g for g in comm.group if g not in decided]
    # adopt the decided view: a member that learned of a failure only
    # through the decision must treat that rank as failed from now on
    for g in decided:
        u.deliver(("fail", int(g)))
    u.poll()
    from ompi_tpu_torch.comm.communicator import Communicator, Group
    new = Communicator(comm.state, int(d["cid"]), Group(survivors),
                       name=name or f"{comm.name or 'comm'}-shrink")
    new.errhandler = comm.errhandler
    _invalidate(comm)
    dur_us = int((time.perf_counter() - t0) * 1e6)
    _pv_shrink_us.update_max(dur_us)
    _trace.instant_state(comm.state, "ulfm_shrink", "ft",
                         cid=comm.cid, new_cid=new.cid,
                         survivors=len(survivors), us=dur_us)
    _obs.record_event(_obs.EV_ULFM_SHRINK, comm.cid, new.cid,
                      len(survivors), dur_us, rank=comm.state.rank)
    return new
