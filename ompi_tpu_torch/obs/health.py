"""Gray-failure health plane.

Port of the reference's ``ompi_tpu/obs/health.py``, whole.  Every fault
plane before this one (ULFM shrink, respawn, host domains, KV failover)
models failure as *death detected by silence*.  Real fleets mostly fail
the other way — a host stays alive but runs 10x slow (thermal
throttle, flaky NIC, contended disk), drags every collective it takes
part in down to its speed, and never trips a liveness grace (Huang et
al., HotOS'17; Dean & Barroso, CACM'13).

This module scores every host failure domain from signals the stack
already emits and runs them through a hysteresis state machine::

    healthy (0)  ->  degraded (1)  ->  quarantined (2)
        ^________________|__________________|   (recovery, one step
                                                 per clear streak)

Signals (all integer EWMAs over preallocated per-host arrays):

  * heartbeat inter-arrival EWMA + jitter, sampled where a host beat
    stamps liveness — the primary signal.  An OVERDUE beat counts
    immediately (``now - last`` replaces the EWMA once it exceeds 3x),
    so detection never waits for a slow beat to actually arrive;
  * cross-rank ``rdv_wait`` skew from the critpath phase tables (fed
    via note_rdv_skew — corroboration);
  * per-session queue-wait SLIs and KV round-trip EWMA
    (note_queue_wait / note_kv_rtt);
  * io stall counts (note_io_stall);
  * integrity convictions (note_sdc): decisive, straight to
    quarantined.

The per-tick sweep — ``HealthPlane.tick`` — is held by
``tools/hotpath_audit.py``: pure integer arithmetic over preallocated
lists, no allocation, no formatting.  Everything that allocates (events,
pvars, mitigation) runs in the cold half (``collect``).

The mitigation ladder: degraded stops NEW placements on the host,
reroutes the hierarchical tier's leader hop off it (coll/pipeline
``_hier_plan`` reads ``node_degraded``) and widens its deadlines;
quarantined drains and migrates its sessions; recovery walks back one
state per sustained-clean streak.  The adaptive host-liveness grace
also lives here: ``HostBeatEstimator`` derives each host's grace from
its own beat EWMA + jitter, floored at a static horizon.

Callers: the resident pool of more than one host (tools/dvm.py) builds
a plane, feeds its agents' beats into ``note_beat``, ticks it on its
heartbeat loop, walks the ladder in ``_health_collect`` (with
``health_respawn`` cycling a quarantined host), ``exclude``s a dead
host, asks ``placement_ok`` at placement and ``widen_pct`` at deadline
shedding, and wires the integrity plane's convict hook into
``note_sdc``; the hierarchical tier's leader reroute reads
``node_degraded`` (through the process-global mask
``set_degraded_mask`` holds); the hang doctor's capture takes a
plane's ``snapshot``.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ompi_tpu_torch.mca.params import registry

_enable_var = registry.register(
    "health", "", "enable", 1, int,
    help="Arm the gray-failure health plane on multi-host pools "
         "(score hosts, degrade/quarantine, mitigate); 0 leaves only "
         "the death-by-silence liveness plane")
_tick_ms_var = registry.register(
    "health", "", "tick_ms", 250, int,
    help="Health-plane scoring period (the audited tick rides the "
         "pool heartbeat loop, so the effective period is "
         "max(health_tick_ms, dvm_heartbeat_s))")
_degrade_var = registry.register(
    "health", "", "degrade_score", 40, int,
    help="Composite score (0-100) at or above which a host's trip "
         "streak runs toward `degraded`")
_quarantine_var = registry.register(
    "health", "", "quarantine_score", 75, int,
    help="Composite score (0-100) at or above which a degraded "
         "host's trip streak runs toward `quarantined`")
_trip_var = registry.register(
    "health", "", "trip_ticks", 3, int,
    help="Consecutive over-threshold ticks before the state machine "
         "escalates one step (hysteresis against transient blips)")
_clear_var = registry.register(
    "health", "", "clear_ticks", 8, int,
    help="Consecutive under-threshold ticks before the state machine "
         "recovers one step")
_widen_var = registry.register(
    "health", "", "widen_pct", 300, int,
    help="Deadline widening for sessions touching a degraded host: "
         "the client deadline is treated as this percent of itself "
         "at shed admission (degraded hosts run slow on purpose — "
         "widen, don't shed)")
_grace_k_var = registry.register(
    "health", "", "grace_jitter_k", 4, int,
    help="Adaptive host-liveness grace: jitter multiplier in "
         "grace = max(floor, 6*beat_EWMA + k*jitter)")
_skew_budget_var = registry.register(
    "health", "", "skew_budget_us", 50000, int,
    help="Cross-rank rdv_wait skew EWMA that scores 100 health "
         "points (corroboration signal weighting)")
_respawn_var = registry.register(
    "health", "", "respawn", 0, int,
    help="After a quarantined host is fully drained, cycle the "
         "domain (kill_host + respawn_host) so a fresh agent rejoins "
         "clean; 0 leaves the offender quarantined for the operator")
_pv_host_health = registry.register_pvar(
    "fleet", "", "host_health", var_class="level",
    help="Hosts currently NOT healthy (degraded + quarantined) — the "
         "gray-failure plane's live gauge")
_pv_quarantines = registry.register_pvar(
    "fleet", "", "quarantines",
    help="Host quarantine transitions declared by the health plane "
         "(lifetime; a healthy fleet keeps this at 0)")
_pv_migrations = registry.register_pvar(
    "fleet", "", "migrations",
    help="Sessions drained off a quarantined host (parked + replayed "
         "onto healthy domains — never a failed job)")

#: state machine encoding (ints on the hot path, names for humans)
HEALTHY, DEGRADED, QUARANTINED = 0, 1, 2
STATE_NAMES = ("healthy", "degraded", "quarantined")

#: leader-hop penalty consulted by coll/pipeline._hier_plan: split
#: keys of ranks resident on a degraded/quarantined host are biased
#: past every healthy rank's, so the intra-slice leader (intra.rank 0
#: = smallest key) lands on a healthy host whenever the slice has one
_degraded_mask = 0


def set_degraded_mask(mask: int) -> None:
    global _degraded_mask
    _degraded_mask = int(mask)


def node_degraded(node_id: int) -> bool:
    """True when the health plane holds this host domain at degraded
    or worse — the hier leader-reroute gate (process-global: resident
    DVM rank-threads share the pool process)."""
    return bool(_degraded_mask >> max(0, int(node_id)) & 1)


class HostBeatEstimator:
    """Per-host beat inter-arrival EWMA + jitter, all int ns — the
    shared estimator behind the ADAPTIVE host-liveness grace
    (satellite of DESIGN.md §24).  ``note(h, now_ns)`` on every beat;
    ``grace_ns(h)`` answers with::

        max(floor_ns, mult * ewma + health_grace_jitter_k * jitter)

    With an agent pacing itself at grace/6 (tools/tpud), a crisp host
    sits exactly at the floor; a jittery-but-alive host widens its own
    grace instead of being declared dead.  Consumed by both the DVM
    pool sweep (_host_tick reads the preallocated grace list) and the
    HNP beat monitor (tools/plm._beat_monitor)."""

    def __init__(self, hosts: int, floor_ns: int,
                 mult: int = 6) -> None:
        n = max(1, int(hosts))
        self.hosts = n
        self.floor_ns = max(1, int(floor_ns))
        # grace = mult * EWMA + k * jitter: mult mirrors the
        # consumer's own beat pacing (the DVM agent beats at grace/6
        # -> 6; the HNP daemon beats at interval with a budget-beat
        # horizon -> budget), so a CRISP host sits exactly at the
        # static floor and only genuine jitter widens anything
        self.mult = max(1, int(mult))
        self.last_ns = [0] * n    # last beat stamp (0 = never)
        self.ewma_ns = [0] * n    # inter-arrival EWMA
        self.jitter_ns = [0] * n  # EWMA of |delta - ewma|
        # preallocated adaptive grace, floor-seeded: _host_tick (and
        # the plm monitor) index this list on their sweep paths
        self.grace = [self.floor_ns] * n

    def note(self, h: int, now_ns: int) -> None:
        """One beat arrived from host ``h`` (cold path: the host_beat
        op / HNP dispatch)."""
        if not 0 <= h < self.hosts:
            return
        last = self.last_ns[h]
        self.last_ns[h] = now_ns
        if last <= 0:
            return
        delta = now_ns - last
        if delta <= 0:
            return
        ew = self.ewma_ns[h]
        if ew <= 0:
            ew = delta
        else:
            ew += (delta - ew) >> 1  # alpha 1/2: track mode shifts fast
        self.ewma_ns[h] = ew
        dev = delta - ew
        if dev < 0:
            dev = -dev
        jit = self.jitter_ns[h]
        jit += (dev - jit) >> 1
        self.jitter_ns[h] = jit
        k = max(0, _grace_k_var.value)
        g = self.mult * ew + k * jit
        if g < self.floor_ns:
            g = self.floor_ns
        self.grace[h] = g

    def grace_ns(self, h: int) -> int:
        if not 0 <= h < self.hosts:
            return self.floor_ns
        return self.grace[h]


class HealthPlane:
    """Score -> hysteresis -> mitigation flags for every host domain.

    ``tick(now_ns)`` is the audited hot half (rides the pool's
    _host_tick sweep): integer scoring over preallocated arrays,
    state transitions latched into ``pending``.  ``collect()`` is the
    cold half: drains pending transitions for the server's mitigation
    ladder and maintains the fleet_* pvars."""

    def __init__(self, hosts: int, expect_beat_ns: int,
                 floor_grace_ns: int) -> None:
        n = max(1, int(hosts))
        self.hosts = n
        self.enabled = 1 if _enable_var.value else 0
        self.expect_ns = max(1, int(expect_beat_ns))
        self.est = HostBeatEstimator(n, floor_grace_ns)
        self.grace_ns = self.est.grace  # alias for the _host_tick sweep
        self.tick_ns = max(1, _tick_ms_var.value) * 1_000_000
        self.next_ns = 0
        self.ticks = 0
        # corroboration signal EWMAs (us), fed by note_* (cold paths)
        self.rdv_skew_us = [0] * n
        self.qwait_us = [0] * n
        self.kv_rtt_us = [0] * n
        self.io_stalls = [0] * n
        # sdc convictions (DESIGN.md §25): unlike the graded signals
        # above, a conviction is decisive evidence — one poisons the
        # host straight to quarantined, no hysteresis
        self.sdc = [0] * n
        # state machine (all preallocated ints)
        self.score = [0] * n
        self.state = [0] * n
        self.up_streak = [0] * n
        self.down_streak = [0] * n
        self.pending = [0] * n  # transition latched, cold half collects
        self.excluded = [0] * n  # dead/rehydrating: server-maintained
        self.degraded_n = 0      # hosts at state >= 1 (controller reads)
        self.quarantined_n = 0
        self.sdc_n = 0           # hosts carrying an sdc conviction

    # -- signal ingestion (cold paths) ---------------------------------

    def note_beat(self, h: int, now_ns: int) -> None:
        """A host_beat op landed: feed the shared estimator (which
        also maintains the adaptive per-host grace)."""
        self.est.note(h, now_ns)

    def note_rdv_skew(self, h: int, us: int) -> None:
        """Cross-rank rendezvous-wait skew attributed to host ``h``
        (critpath phase tables / straggler gauges)."""
        if 0 <= h < self.hosts and us >= 0:
            cur = self.rdv_skew_us[h]
            self.rdv_skew_us[h] = cur + ((int(us) - cur) >> 1)

    def note_queue_wait(self, h: int, us: int) -> None:
        if 0 <= h < self.hosts and us >= 0:
            cur = self.qwait_us[h]
            self.qwait_us[h] = cur + ((int(us) - cur) >> 2)

    def note_kv_rtt(self, h: int, us: int) -> None:
        if 0 <= h < self.hosts and us >= 0:
            cur = self.kv_rtt_us[h]
            self.kv_rtt_us[h] = cur + ((int(us) - cur) >> 2)

    def note_io_stall(self, h: int, n: int = 1) -> None:
        if 0 <= h < self.hosts and n > 0:
            self.io_stalls[h] += int(n)

    def note_sdc(self, h: int, n: int = 1) -> None:
        """An integrity conviction (obs/integrity) landed on host
        ``h``: decisive — the next tick quarantines the host outright
        (a chip computing wrong answers cannot be widened around)."""
        if 0 <= h < self.hosts and n > 0:
            self.sdc[h] += int(n)
            c = 0
            for x in self.sdc:
                if x > 0:
                    c += 1
            self.sdc_n = c

    # -- the audited hot half ------------------------------------------

    def tick(self, now: int) -> int:
        # hotpath_audit-enforced (tools/hotpath_audit): rides the pool
        # heartbeat sweep next to DVMServer._host_tick.  Integer
        # compares and divides over preallocated lists only — no
        # allocation, no formatting; transitions are latched into
        # `pending` for the cold collect.
        if self.enabled == 0 or now < self.next_ns:
            return 0
        self.next_ns = now + self.tick_ns
        self.ticks += 1
        expect = self.expect_ns
        last = self.est.last_ns
        ewma = self.est.ewma_ns
        jit = self.est.jitter_ns
        skew = self.rdv_skew_us
        skew_budget = _skew_budget_var.value
        if skew_budget <= 0:
            skew_budget = 50000
        d_th = _degrade_var.value
        q_th = _quarantine_var.value
        trip = _trip_var.value
        if trip < 1:
            trip = 1
        clear = _clear_var.value
        if clear < 1:
            clear = 1
        score = self.score
        state = self.state
        ups = self.up_streak
        downs = self.down_streak
        pend = self.pending
        excl = self.excluded
        sdc = self.sdc
        n = self.hosts
        hit = 0
        deg = 0
        quar = 0
        sdcn = 0
        h = 0
        while h < n:
            if excl[h] == 1:
                # dead / rehydrating domains belong to the liveness
                # plane, not the gray-failure plane
                score[h] = 0
                ups[h] = 0
                h += 1
                continue
            if sdc[h] > 0:
                # sdc conviction: decisive, no hysteresis — wrong
                # answers are worse than slow ones, and the conviction
                # itself proves the chip is alive (DESIGN.md §25)
                sdcn += 1
                score[h] = 100
                ups[h] = 0
                downs[h] = 0
                if state[h] != QUARANTINED:
                    state[h] = QUARANTINED
                    pend[h] = 1
                    hit += 1
                deg += 1
                quar += 1
                h += 1
                continue
            if last[h] == 0:
                # never-beaten domains have no gray-failure evidence
                score[h] = 0
                ups[h] = 0
                h += 1
                continue
            # effective beat interval: the EWMA, or the OVERDUE gap if
            # a beat is already 3x late — detection must not wait for
            # a 10x-slowed beat to actually arrive
            eff = ewma[h]
            if eff <= 0:
                eff = expect
            since = now - last[h]
            if since > 3 * eff and since > 3 * expect:
                eff = since
            # slowness: percent of expected interval past 1x, capped
            s1 = eff * 100 // expect - 100
            if s1 < 0:
                s1 = 0
            elif s1 > 100:
                s1 = 100
            # jitter: half-weight corroboration
            s2 = jit[h] * 100 // expect
            if s2 > 50:
                s2 = 50
            # rdv_wait skew: half-weight corroboration
            s3 = skew[h] * 50 // skew_budget
            if s3 > 50:
                s3 = 50
            sc = s1 + (s2 >> 1) + (s3 >> 1)
            if sc > 100:
                sc = 100
            score[h] = sc
            cur = state[h]
            want = cur
            if sc >= q_th:
                want = QUARANTINED
            elif sc >= d_th:
                want = DEGRADED
            else:
                want = HEALTHY
            if want > cur:
                downs[h] = 0
                ups[h] += 1
                if ups[h] >= trip:
                    ups[h] = 0
                    state[h] = cur + 1  # one ladder rung per streak
                    pend[h] = 1
                    hit += 1
            elif want < cur:
                ups[h] = 0
                downs[h] += 1
                if downs[h] >= clear:
                    downs[h] = 0
                    state[h] = cur - 1
                    pend[h] = 1
                    hit += 1
            else:
                ups[h] = 0
                downs[h] = 0
            if state[h] >= DEGRADED:
                deg += 1
            if state[h] == QUARANTINED:
                quar += 1
            h += 1
        self.degraded_n = deg
        self.quarantined_n = quar
        self.sdc_n = sdcn
        return hit

    # -- the cold half --------------------------------------------------

    def collect(self) -> List[int]:
        """Drain latched transitions (host ids, in order).  The caller
        (DVMServer._health_collect) applies the mitigation ladder; the
        pvars and the leader-reroute mask are maintained here."""
        out: List[int] = []
        mask = 0
        nonhealthy = 0
        for h in range(self.hosts):
            if self.pending[h] == 1:
                self.pending[h] = 0
                out.append(h)
            if self.state[h] >= DEGRADED and self.excluded[h] == 0:
                mask |= 1 << h
                nonhealthy += 1
        set_degraded_mask(mask)
        lvl = _pv_host_health.read()
        if nonhealthy != lvl:
            _pv_host_health.add(nonhealthy - lvl)
        return out

    def note_quarantine(self) -> None:
        _pv_quarantines.add(1)

    def note_migration(self, n: int = 1) -> None:
        _pv_migrations.add(n)

    def exclude(self, h: int, flag: bool) -> None:
        """Dead / rehydrating domains leave the scoring sweep (the
        liveness plane owns them); re-inclusion resets the machine so
        a respawned host starts healthy with fresh estimates."""
        if not 0 <= h < self.hosts:
            return
        self.excluded[h] = 1 if flag else 0
        if flag:
            self.reset_host(h)

    def reset_host(self, h: int) -> None:
        if not 0 <= h < self.hosts:
            return
        self.state[h] = HEALTHY
        self.score[h] = 0
        self.up_streak[h] = 0
        self.down_streak[h] = 0
        self.pending[h] = 0
        self.rdv_skew_us[h] = 0
        self.qwait_us[h] = 0
        self.kv_rtt_us[h] = 0
        self.io_stalls[h] = 0
        self.sdc[h] = 0
        c = 0
        for x in self.sdc:
            if x > 0:
                c += 1
        self.sdc_n = c
        self.est.last_ns[h] = 0
        self.est.ewma_ns[h] = 0
        self.est.jitter_ns[h] = 0
        self.est.grace[h] = self.est.floor_ns

    def placement_ok(self, h: int) -> bool:
        """May NEW sessions place ranks on host ``h``?  Degraded and
        quarantined domains stop taking new placements (existing
        residents are handled by the mitigation ladder)."""
        if not 0 <= h < self.hosts:
            return False
        return self.state[h] == HEALTHY and self.excluded[h] == 0

    def widen_pct(self) -> int:
        """Deadline widening applied at shed admission for sessions
        touching a degraded host (>= 100; 100 = no widening)."""
        return max(100, _widen_var.value)

    def tripped(self, h: int) -> List[str]:
        """Signal names currently contributing to host ``h``'s score
        (diagnostics: top's health column, the doctor verdict)."""
        out: List[str] = []
        if not 0 <= h < self.hosts:
            return out
        if self.sdc[h] > 0:
            out.append("sdc")
        expect = self.expect_ns
        ew = self.est.ewma_ns[h]
        if ew > 0 and ew * 100 // expect > 150:
            out.append("beat_slow")
        if self.est.jitter_ns[h] * 100 // expect > 50:
            out.append("beat_jitter")
        budget = max(1, _skew_budget_var.value)
        if self.rdv_skew_us[h] * 100 // budget > 50:
            out.append("rdv_skew")
        if self.qwait_us[h] > 0 and out:
            out.append("queue_wait")
        if self.io_stalls[h] > 0:
            out.append("io_stall")
        return out

    def snapshot(self) -> List[Dict[str, Any]]:
        """Per-host health rows for the metrics RPC / top / doctor."""
        rows: List[Dict[str, Any]] = []
        for h in range(self.hosts):
            rows.append({
                "host": h,
                "state": STATE_NAMES[self.state[h]],
                "score": self.score[h],
                "beat_ewma_ms": self.est.ewma_ns[h] // 1_000_000,
                "beat_jitter_ms": self.est.jitter_ns[h] // 1_000_000,
                "grace_ms": self.est.grace[h] // 1_000_000,
                "rdv_skew_us": self.rdv_skew_us[h],
                "sdc": self.sdc[h],
                "signals": self.tripped(h),
                "excluded": bool(self.excluded[h]),
            })
        return rows

