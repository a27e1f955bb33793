"""FleetController: the closed loop of the serving control plane.

Port of the reference's ``ompi_tpu/serve/controller.py``, unchanged in
its decisions.

The pool's admission/quota/shed mechanisms (tools/dvm.py, serve/quota)
are all *reactive* — they fire when a request arrives.  The controller
is the *proactive* half: a periodic observation of queue depth and
rank utilization that decides

- **pool resizes** — grow resident capacity when attaches are queuing,
  shrink back when the pool has sat idle; and
- **shed margins** — how pessimistic the deadline estimator should be,
  widening under backlog so infeasible work is rejected at admission
  instead of timing out inside the pool.

Split the same way obs.Scraper is split: :meth:`FleetController.tick`
runs on the sampled progress sweep of every resident rank-thread
(``Progress.progress`` calls it at the same ``counter & 255`` gate
that drives the scraper) and therefore obeys the hot-path audit — no
allocation, integer state only, self-gated on a deadline so ticking
from N threads costs N-1 of them a single compare.  Decisions are
*published* as plain ints; the pool's heartbeat loop — which also
ticks, covering the idle-pool case where no rank-thread is running —
calls :meth:`apply` off the hot path to actually resize and record
flight-recorder events.

On a pool of several host domains it also widens the margins while the
health plane holds a degraded host (or an integrity conviction), holds
the shrink while a lost host rehydrates, and with ``ctrl_host_respawn``
re-places a dead host domain itself.
"""

from __future__ import annotations

from typing import Optional

from ompi_tpu_torch import obs as _obs
from ompi_tpu_torch.mca.params import registry

_interval_var = registry.register(
    "ctrl", "tick", "interval_ms", 200,
    help="FleetController decision interval, milliseconds")
_grow_depth_var = registry.register(
    "ctrl", "grow", "queue_depth", 2,
    help="Queue depth (parked attach waiters) at or above which the "
         "controller grows the pool")
_grow_step_var = registry.register(
    "ctrl", "grow", "step", 4,
    help="Ranks added per grow decision")
_shrink_ticks_var = registry.register(
    "ctrl", "shrink", "idle_ticks", 25,
    help="Consecutive idle controller ticks (no waiters, no active "
         "ranks) before the pool shrinks back to its floor")
_margin_max_var = registry.register(
    "ctrl", "shed", "margin_max_pct", 400,
    help="Ceiling of the deadline-shed safety margin, percent")
pv_ticks = registry.register_pvar(
    "ctrl", "loop", "ticks",
    help="FleetController decision-loop ticks taken")
_host_respawn_var = registry.register(
    "ctrl", "host", "respawn", 0,
    help="1 = the controller auto-respawns dead host failure domains "
         "on its apply sweep (the cluster-scheduler stand-in); 0 "
         "leaves respawn to the operator / chaos probe so MTTR can "
         "be measured")


class FleetController:
    """Queue-depth-driven resize + shed-margin loop for a DVM pool.

    ``server`` is duck-typed (reads ``capacity``, ``active_ranks``,
    ``_waiters``, ``est_wall_us``): tests drive the loop against a
    stub.  ``floor``/``ceil`` bound the capacity decisions."""

    def __init__(self, server=None, floor: int = 1,
                 ceil: Optional[int] = None) -> None:
        self.server = server
        self.floor = max(1, floor)
        self.ceil = ceil if ceil and ceil >= self.floor else self.floor * 4
        self.interval_ns = max(1, _interval_var.value) * 1_000_000
        self.grow_depth = max(1, _grow_depth_var.value)
        self.grow_step = max(1, _grow_step_var.value)
        self.shrink_ticks = max(1, _shrink_ticks_var.value)
        self.margin_max = max(100, _margin_max_var.value)
        self.next_ns = 0
        self.ticks = 0
        self.idle_ticks = 0
        # published decisions (ints, read by apply / the shed check)
        self.want_capacity = 0       # 0 = no pending resize
        self.shed_margin_pct = 100
        self.last_depth = 0
        # published hang-doctor tolerance (DESIGN.md §23), percent of
        # the EWMA wall estimate: seeded from obs_watchdog_factor and
        # widened under backlog the same way the shed margin is — a
        # loaded pool legitimately runs jobs slower, so the watchdog
        # must not cry wolf exactly when preemption churn peaks
        self.wd_base_pct = _obs.watchdog_factor_pct()
        self.wd_factor_pct = self.wd_base_pct

    def tick(self, now: int) -> int:
        # hot path: called from Progress.progress on resident
        # rank-threads (see tools/hotpath_audit.py) — gate first,
        # integer state only, publish decisions without acting
        if now < self.next_ns:
            return 0
        self.next_ns = now + self.interval_ns
        srv = self.server
        if srv is None:
            return 0
        depth = len(srv._waiters)
        active = srv.active_ranks
        cap = srv.capacity
        self.last_depth = depth
        margin = 100 + depth * 25
        if margin > self.margin_max:
            margin = self.margin_max
        wf = self.wd_base_pct + depth * 25
        if wf > self.wd_base_pct * 2:
            wf = self.wd_base_pct * 2
        hp = getattr(srv, "health", None)
        if hp is not None and (hp.degraded_n > 0 or hp.sdc_n > 0):
            # gray-failure mitigation: a degraded host runs slow ON
            # PURPOSE while the health plane holds it (and a host
            # convicted of silent data corruption is mid-drain, its
            # retried collectives inflating run times the same way) —
            # widen the shed margin and the watchdog tolerance by 1.5x
            # so the estimator and the hang doctor do not punish the
            # sessions the fleet chose not to migrate yet
            margin = margin + (margin >> 1)
            if margin > self.margin_max:
                margin = self.margin_max
            wf = wf + (wf >> 1)
        self.shed_margin_pct = margin
        self.wd_factor_pct = wf
        if depth >= self.grow_depth and cap < self.ceil:
            want = cap + self.grow_step
            if want > self.ceil:
                want = self.ceil
            self.want_capacity = want
            self.idle_ticks = 0
        elif depth == 0 and active == 0 \
                and getattr(srv, "rehydrated_parked", 0) == 0 \
                and getattr(srv, "hosts_rehydrating", 0) == 0:
            # rehydrated-but-unresumed sessions (crash recovery,
            # DESIGN.md §20) hold zero ranks yet are about to resume:
            # shrinking now would yank capacity out from under the
            # recovering pool and add resize churn to the MTTR.
            # Likewise a lost host domain mid-rehydration: its parked
            # sessions need their ranks back the moment the
            # replacement host rejoins
            self.idle_ticks += 1
            if self.idle_ticks >= self.shrink_ticks and cap > self.floor:
                self.want_capacity = self.floor
        else:
            self.idle_ticks = 0
        self.ticks += 1
        pv_ticks.add(1)
        return 1

    # -- off the hot path --------------------------------------------------

    def apply(self) -> bool:
        """Act on the published decision: resize the pool if the tick
        loop asked for it.  Called from the pool heartbeat loop (and
        tests) — may lock, allocate, log.  Returns True if a resize
        was applied."""
        srv = self.server
        self._maintain_hosts(srv)
        want = self.want_capacity
        if srv is None or not want or want == srv.capacity:
            self.want_capacity = 0
            return False
        self.want_capacity = 0
        _obs.record_event(_obs.EV_CTRL_ADJUST, self.shed_margin_pct,
                          self.last_depth, getattr(srv, "est_wall_us", 0))
        srv.resize(want)
        return True

    def _maintain_hosts(self, srv) -> None:
        """Host-granularity repair: a dead failure domain is replaced,
        not merely mourned.  The controller stands in for a cluster
        scheduler handing back a machine: it re-places the lost domain
        so the parked sessions' next run lands on a live fleet.
        Opt-in (ctrl_host_respawn=1): chaos runs measure the gap
        between a kill and an operator-driven respawn."""
        if srv is None or getattr(srv, "hosts", 1) < 2:
            return
        if not _host_respawn_var.value:
            return
        dead = getattr(srv, "_host_dead", None)
        if not dead:
            return
        for h, d in enumerate(dead):
            if d:
                srv.respawn_host(h)
