"""MCA-selectable fault injection: the injectors of the port's paths.

Port of the part of the reference's ft_inject (ompi_tpu/ft_inject/
__init__.py) that the port's choke points consume: a deterministic,
seed-driven interposer, driven by MCA params only, so a chaos run is
``--mca ft_inject_plan delay --mca ft_inject_seed 7`` with no code
change.  Ported injection points:

  * the device-collective rendezvous (coll/device.py ``meet`` and
    ``meet_begin``): ``delay`` holds the depositing rank thread
    (straggler arrival orders), ``host_slow`` stalls every deposit of
    the ranks resident on ``ft_inject_victim_host`` (the GRAY failure
    the health plane scores), ``rdv_sever`` wedges the victim rank
    short of its Nth deposit until the world is poisoned (the hang
    doctor's crime scene), ``device_sdc`` flips a bit of the victim
    rank's operand after the integrity gate digested it (the silent
    failure only obs/integrity can see);
  * the one-sided window's active-message apply (osc/window.py):
    ``rma_delay`` holds the target's apply loop;
  * MPI_Init (runtime/init.py): ``rank_kill`` arms a one-shot timer on
    each of ``ft_inject_victim_rank``'s ranks that kills it
    ``ft_inject_after`` seconds later (a RankKilled out of its next
    progress sweep — the ULFM detect/shrink/respawn target);
  * the node daemon (tools/tpud.py): on ``ft_inject_victim_node``,
    ``daemon_kill`` hard-exits the daemon ``ft_inject_after`` seconds
    after it starts (the HNP's heartbeat and errmgr path) and
    ``oob_sever`` drops its channel to the HNP (the reconnect path);
    (``node_faults``); ``rank_kill`` there SIGKILLs the launch unit
    hosting the victim rank.

Determinism: a rolling injector owns a ``random.Random`` seeded from
``(ft_inject_seed, scope, rank)``, so a chaos run replays bit for bit
from its seed; ``device_sdc`` and ``rdv_sever`` use no RNG at all (an
armed op count, and for ``device_sdc`` a period), nor does
``host_slow`` (a delay from ``ft_inject_delay_ms`` and
``ft_inject_host_slow_factor``).  ``ft_inject_max`` bounds the
injections a scope makes.

An injection that fires leaves an ``ft_inject`` instant (cat
``fault``) on the injecting rank's trace when tracing is on, and an
``EV_FT_INJECT`` event in the flight recorder (ompi_tpu_torch/obs).

The process world's network paths (btl/tcp frames, KV client ops and
the KV primary):

  * btl/tcp (btl/tcp.py ``send``): the frame faults ``drop``,
    ``delay``, ``dup``, ``reorder``, ``corrupt``, ``sever`` and
    ``corrupt_payload`` (``BtlInjector``), and ``net_jitter`` —
    seeded added latency, and with ``ft_inject_net_jitter_loss`` a
    drop the reliable sublayer replays;
  * the KV client (runtime/kvstore.py ``KVClient._request``):
    ``kv_partition`` severs the socket before an op (``KvInjector``),
    ``net_jitter`` delays it;
  * the KV primary (runtime/kvstore.py ``KVServer``): ``kv_kill``
    crashes it at its Nth served op (``KillInjector``).

The resident pool (tools/dvm.py):

  * its client (``DvmClient.run``): ``dvm_disconnect`` drops the pool
    connection right after a run request is sent (``DvmInjector``),
    leaving the session's program executing with no client;
  * its server (``serve()``, a subprocess pool only):
    ``dvm_kill`` hard-exits the server at its Nth served op
    (``KillInjector``; the journal rehydration path);
  * its fleet of host failure domains: ``host_kill`` severs
    ``ft_inject_victim_host`` at the pool's Nth served op — agent,
    KV endpoint and resident ranks as one record (``KillInjector``,
    in-process safe, so an embedded pool arms it too), and
    ``host_slow`` makes that host's ``tpud --fleet`` agent beat
    ``ft_inject_host_slow_factor`` times slower.

Not ported (ROADMAP.md): checkpoint I/O faults (A9).
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

from ompi_tpu_torch.mca.params import registry

_seed_var = registry.register(
    "ft", "inject", "seed", 0, int,
    help="Deterministic seed for every injector's RNG (replay a "
         "failing chaos run bit-for-bit)")
_plan_var = registry.register(
    "ft", "inject", "plan", "", str,
    help="Comma list of fault classes to arm, each optionally "
         "class:rate — e.g. 'delay:0.5'.  Classes: delay (a straggler "
         "at the device-collective rendezvous), rma_delay (a slow "
         "one-sided AM apply), device_sdc (the SILENT failure: "
         "ft_inject_victim_rank's operand bit-flips at the armed op "
         "count, visible only to the integrity plane; the number is "
         "that count, not a rate), rdv_sever (wedges "
         "ft_inject_victim_rank short of its Nth device-collective "
         "deposit — the hang doctor's target; the number is that "
         "count), host_slow (the GRAY failure: every rank resident on "
         "ft_inject_victim_host stalls delay_ms*(factor-1) at each "
         "deposit), rank_kill (ft_inject_victim_rank's ranks die "
         "ft_inject_after seconds after MPI_Init; the number is "
         "ignored), daemon_kill and oob_sever (the node daemon on "
         "ft_inject_victim_node hard-exits, or drops its channel to "
         "the HNP, ft_inject_after seconds after it starts), the "
         "btl/tcp frame faults (drop, delay, dup, "
         "reorder, corrupt, sever, corrupt_payload), kv_partition (a "
         "KV client op severs its socket first), kv_kill (the KV "
         "primary dies serving its Nth op; the number is that count), "
         "dvm_disconnect (a pool client drops its connection right "
         "after sending a run), dvm_kill (a subprocess pool server "
         "hard-exits serving its Nth op; the number is that count), "
         "host_kill (a multi-host pool severs ft_inject_victim_host's "
         "whole failure domain — agent plus every resident rank — at "
         "its Nth served op; the number is that count) "
         "and net_jitter (seeded latency on tcp frames and KV ops).  "
         "Empty = framework disabled")
_rate_var = registry.register(
    "ft", "inject", "rate", 0.02, float,
    help="Default per-event injection probability for plan entries "
         "without an explicit rate")
_max_var = registry.register(
    "ft", "inject", "max", 64, int,
    help="Cap on injections per scope (0 = unlimited); a capped "
         "injected stream always converges to a clean one")
_skip_var = registry.register(
    "ft", "inject", "skip", 8, int,
    help="Skip the first N eligible events per scope so bring-up "
         "traffic establishes the job before chaos")
_victim_host_var = registry.register(
    "ft", "inject", "victim_host", 1, int,
    help="Host (failure-domain) id the host_slow class slows (every "
         "rank whose node_id it is, and its host agent's beat) and the "
         "host_kill class severs")
_victim_rank_var = registry.register(
    "ft", "inject", "victim_rank", "1", str,
    help="Global rank(s) the rank_kill class kills, the device_sdc "
         "class corrupts and the rdv_sever class wedges: a single "
         "rank, a comma list ('1,3'), or 'random' for a seed-"
         "deterministic pick")
_after_var = registry.register(
    "ft", "inject", "after", 1.0, float,
    help="Seconds after MPI_Init at which the rank_kill class kills "
         "its victims; the node-level scenarios (daemon_kill/"
         "oob_sever) fire this many seconds after daemon start")
_victim_var = registry.register(
    "ft", "inject", "victim_node", 1, int,
    help="Node id that hosts the daemon_kill/oob_sever scenarios")
_delay_ms_var = registry.register(
    "ft", "inject", "delay_ms", 20, int,
    help="How long a 'delay' or 'rma_delay' hit holds its thread")
_slow_factor_var = registry.register(
    "ft", "inject", "host_slow_factor", 10, int,
    help="Slowdown multiplier the host_slow gray-failure scenario "
         "applies to ft_inject_victim_host: resident ranks stall "
         "delay_ms*(factor-1) at every device-collective deposit (and "
         "a host agent would beat factor times slower) — alive, never "
         "silent")
_jitter_ms_var = registry.register(
    "ft", "inject", "net_jitter_ms", 5, int,
    help="Mean added latency (milliseconds) of the net_jitter class; "
         "each hit sleeps a seeded uniform draw in [0, 2*mean]")
_jitter_loss_var = registry.register(
    "ft", "inject", "net_jitter_loss", 0.0, float,
    help="Per-event probability a net_jitter hit also DROPS the "
         "frame (tcp path only — the reliable sublayer retransmits; "
         "KV ops are never dropped, only delayed)")
_sdc_period_var = registry.register(
    "ft", "inject", "sdc_period", 0, int,
    help="device_sdc repeat period after the first armed flip (every "
         "Nth subsequent collective on the victim also flips); 0 = "
         "one-shot — probes measuring detection RATE arm a period so "
         "one run carries many independent flips")

# corrupt_payload flips frame bytes OUTSIDE the header-CRC span (the
# header CRC stays valid by construction — equivalent to recomputing
# it after the flip), so only the reliable layer's payload digest
# (btl_tcp_payload_digest) can catch it
BTL_CLASSES = ("drop", "delay", "dup", "reorder", "corrupt", "sever",
               "corrupt_payload")
NODE_CLASSES = ("daemon_kill", "oob_sever")
# seeded latency/loss shaping on the tcp + KV client paths — the
# network-flakiness half of gray failure
NET_CLASSES = ("net_jitter",)


def plan() -> Dict[str, float]:
    """Parse ft_inject_plan into {class: rate}."""
    out: Dict[str, float] = {}
    s = _plan_var.value.strip()
    if not s:
        return out
    for item in s.split(","):
        item = item.strip()
        if not item:
            continue
        if ":" in item:
            cls, r = item.split(":", 1)
            out[cls.strip()] = float(r)
        else:
            out[item] = _rate_var.value
    return out


def enabled() -> bool:
    return bool(plan())


class _Scoped:
    """Shared per-scope bookkeeping: deterministic rng, warm-up skip,
    total-injection cap."""

    def __init__(self, scope: str, rank: int,
                 classes: Dict[str, float]) -> None:
        self.scope = scope
        self.classes = classes
        self._rng = random.Random(f"{_seed_var.value}:{scope}:{rank}")
        self._count = 0
        self._injected = 0

    def _roll(self) -> Optional[str]:
        self._count += 1
        if self._count <= max(0, _skip_var.value):
            return None
        cap = _max_var.value
        if cap > 0 and self._injected >= cap:
            return None
        for cls, rate in self.classes.items():
            if self._rng.random() < rate:
                self._injected += 1
                # annotate the span timeline: a fault firing explains
                # the latency spike around it (trace is a leaf module;
                # import here keeps injection import-light when off)
                from ompi_tpu_torch import obs as _obs
                from ompi_tpu_torch import trace
                tr = trace.current_tracer()
                if tr is not None:
                    tr.instant("ft_inject", "fault", cls=cls,
                               scope=self.scope)
                _obs.record_event(_obs.EV_FT_INJECT,
                                  _obs.intern(cls),
                                  _obs.intern(str(self.scope)))
                return cls
        return None


class BtlInjector(_Scoped):
    @property
    def delay_s(self) -> float:
        return max(0, _delay_ms_var.value) / 1000.0

    def pick(self, rail: int, peer: int) -> Optional[str]:
        """One frame is about to be sent; return a fault class to
        apply to it, or None to let it through clean."""
        return self._roll()


def btl_injector(rank: int) -> Optional[BtlInjector]:
    p = {c: r for c, r in plan().items() if c in BTL_CLASSES}
    if not p:
        return None
    return BtlInjector("btl", rank, p)


class KvInjector(_Scoped):
    def sever(self) -> bool:
        """About to issue a KV op: True = partition first (close the
        socket under the client's feet)."""
        return self._roll() == "kv_partition"


def kv_injector(rank: int) -> Optional[KvInjector]:
    p = {c: r for c, r in plan().items() if c == "kv_partition"}
    if not p:
        return None
    return KvInjector("kv", rank, p)


class KillInjector:
    """One-shot deterministic control-plane death: ``op()`` counts the
    victim's served ops and returns True exactly once, when the armed
    count is reached.  No RNG — death at op N replays bit-for-bit."""

    def __init__(self, scope: str, after_ops: float) -> None:
        self.scope = scope
        # plan rates below 1 (including the 0.02 default applied to a
        # bare class name) mean "no explicit count": arm a mid-run
        # default instead of dying on the first op
        self.after_ops = int(after_ops) if after_ops >= 1 else 64
        self._count = 0
        self._fired = False

    def op(self) -> bool:
        if self._fired:
            return False
        self._count += 1
        if self._count < self.after_ops:
            return False
        self._fired = True
        from ompi_tpu_torch import obs as _obs
        from ompi_tpu_torch import trace
        tr = trace.current_tracer()
        if tr is not None:
            tr.instant("ft_inject", "fault", cls=self.scope + "_kill",
                       scope=self.scope)
        _obs.record_event(_obs.EV_FT_INJECT,
                          _obs.intern(self.scope + "_kill"),
                          _obs.intern(self.scope))
        return True


def kv_kill_injector() -> Optional[KillInjector]:
    p = plan()
    if "kv_kill" not in p:
        return None
    return KillInjector("kv", p["kv_kill"])


def dvm_kill_injector() -> Optional[KillInjector]:
    p = plan()
    if "dvm_kill" not in p:
        return None
    return KillInjector("dvm", p["dvm_kill"])


def host_kill_injector() -> Optional[KillInjector]:
    p = plan()
    if "host_kill" not in p:
        return None
    return KillInjector("host", p["host_kill"])


def host_kill_victim() -> int:
    """Host id the host_kill scenario severs."""
    return _victim_host_var.value


# the pool client's fault: dvm_disconnect drops the client's pool
# connection right after a run request is sent — the session's program
# is already executing inside the pool, so this drives the client-
# death cleanup (the pool must finish or poison ONLY that session)
DVM_CLASSES = ("dvm_disconnect",)


class DvmInjector(_Scoped):
    def disconnect(self) -> bool:
        """A run request was just sent: True = drop the pool
        connection now, leaving the job executing with no client."""
        return self._roll() == "dvm_disconnect"


def dvm_injector(rank: int = 0) -> Optional[DvmInjector]:
    p = {c: r for c, r in plan().items() if c in DVM_CLASSES}
    if not p:
        return None
    return DvmInjector("dvm", rank, p)


class NetJitterInjector(_Scoped):
    """Seeded latency/loss shaping on the network client paths (btl
    tcp frames, KV ops).  A 'net_jitter' roll sleeps a uniform draw
    in [0, 2*net_jitter_ms]; on the tcp path it may also drop the
    frame with net_jitter_loss probability (the reliable sublayer
    retransmits — KV callers never see a drop, only added RTT)."""

    def maybe_delay_s(self) -> float:
        """Returns seconds to hold the op/frame (0 = clean)."""
        if self._roll() == "net_jitter":
            ms = max(0, _jitter_ms_var.value)
            return self._rng.uniform(0.0, 2.0 * ms) / 1000.0
        return 0.0

    def should_drop(self) -> bool:
        """tcp frames only: a seeded loss decision taken AFTER a
        jitter hit (callers pair it with maybe_delay_s)."""
        loss = _jitter_loss_var.value
        return loss > 0 and self._rng.random() < loss


def net_jitter_injector(rank: int,
                        scope: str = "net") -> Optional[NetJitterInjector]:
    p = {c: r for c, r in plan().items() if c in NET_CLASSES}
    if not p:
        return None
    return NetJitterInjector(scope, rank, p)


class CollInjector(_Scoped):
    """Straggler simulation at the device-collective rendezvous: a
    'delay' roll holds the depositing rank thread before it arrives,
    so meetings (fused batches, plans, segments) see arbitrary arrival
    orders."""

    def maybe_delay(self) -> float:
        """Returns seconds to sleep before depositing (0 = clean)."""
        if self._roll() == "delay":
            return max(0, _delay_ms_var.value) / 1000.0
        return 0.0


def coll_injector(rank: int) -> Optional[CollInjector]:
    p = {c: r for c, r in plan().items() if c == "delay"}
    if not p:
        return None
    return CollInjector("coll", rank, p)


class RdvSeverInjector:
    """One-shot deterministic rendezvous sever: ``should_sever()``
    counts the victim rank's meetings and returns True exactly once, at
    the armed count — no RNG, so the wedge replays bit for bit.  The
    caller then holds the rank BEFORE it deposits, in small
    abort-checked sleeps, until the world is poisoned — its peers wedge
    at the rendezvous and the hang doctor gets a live crime scene
    (coll/device ``_sever_hold``)."""

    def __init__(self, rank: int, after_ops: float) -> None:
        self.rank = rank
        # a rate below 1 (including the bare-class default) means "no
        # explicit count": arm a post-bring-up default
        self.after_ops = int(after_ops) if after_ops >= 1 else 8
        self._count = 0
        self._fired = False

    def should_sever(self) -> bool:
        if self._fired:
            return False
        self._count += 1
        if self._count < self.after_ops:
            return False
        self._fired = True
        from ompi_tpu_torch import obs as _obs
        from ompi_tpu_torch import trace
        tr = trace.current_tracer()
        if tr is not None:
            tr.instant("ft_inject", "fault", cls="rdv_sever",
                       scope="coll", rank=self.rank)
        _obs.record_event(_obs.EV_FT_INJECT,
                          _obs.intern("rdv_sever"),
                          _obs.intern("coll"), rank=self.rank)
        return True


def rdv_sever_injector(rank: int,
                       size: Optional[int] = None
                       ) -> Optional[RdvSeverInjector]:
    p = plan()
    if "rdv_sever" not in p or rank not in victim_ranks(size):
        return None
    return RdvSeverInjector(rank, p["rdv_sever"])


class HostSlowInjector:
    """Deterministic gray-failure slowdown for one host's residents.
    No RNG, no op counting: the victim is simply SLOW, everywhere,
    from the first op — ``delay_s()`` is the stall a resident rank
    adds at every device-collective deposit, ``beat_interval_s(iv)``
    the inflated heartbeat pacing of a host agent (tools/tpud --fleet).
    Both derive from delay_ms and host_slow_factor, so a 10x-slow
    chaos run replays bit for bit with no seed involved."""

    def __init__(self, host: int) -> None:
        self.host = host
        self._announced = False

    @property
    def factor(self) -> int:
        return max(2, _slow_factor_var.value)

    def delay_s(self) -> float:
        """Per-deposit stall of a resident rank: delay_ms scaled so
        the victim runs ~factor times slower than a clean rank whose
        per-op cost is about one delay_ms."""
        self._announce()
        return max(0, _delay_ms_var.value) * (self.factor - 1) / 1000.0

    def beat_interval_s(self, iv: float, grace: float = 0.0) -> float:
        """A host agent's inflated beat pacing: alive, never silent —
        the beat EWMA drifts up instead of the grace tripping.  Capped
        at 3/4 of the liveness grace when the caller knows it: a gray
        host delays its heartbeats, it does not stop them."""
        self._announce()
        slow = iv * self.factor
        if grace > 0:
            cap = grace * 0.75
            if slow > cap:
                slow = max(iv, cap)
        return slow

    def _announce(self) -> None:
        if self._announced:
            return
        self._announced = True
        from ompi_tpu_torch import obs as _obs
        _obs.record_event(_obs.EV_FT_INJECT,
                          _obs.intern("host_slow"),
                          _obs.intern("host"))


def host_slow_injector(host: int) -> Optional[HostSlowInjector]:
    """Armed only on ft_inject_victim_host's residents (rank threads
    consult it with their node_id)."""
    if "host_slow" not in plan() or host != _victim_host_var.value:
        return None
    return HostSlowInjector(host)


class SdcInjector:
    """Deterministic operand bit-flip at the device-collective meet:
    fires at the armed op count (no RNG, replays bit for bit) and then,
    when ft_inject_sdc_period > 0, every period-th collective after
    that, so one chaos run carries many independent flips for
    detection-RATE measurement."""

    def __init__(self, rank: int, after_ops: float, period: int = 0) -> None:
        self.rank = rank
        # a rate below 1 (the bare-class default) means "no explicit
        # count": arm a post-bring-up default
        self.after_ops = int(after_ops) if after_ops >= 1 else 8
        self.period = max(0, int(period))
        self._count = 0
        self.flips = 0
        self.last_flip_ns = 0

    def should_flip(self) -> bool:
        self._count += 1
        n = self._count
        if n < self.after_ops:
            return False
        if n > self.after_ops:
            if self.period <= 0 or (n - self.after_ops) % self.period:
                return False
        self.flips += 1
        self.last_flip_ns = time.monotonic_ns()
        from ompi_tpu_torch import obs as _obs
        from ompi_tpu_torch import trace
        tr = trace.current_tracer()
        if tr is not None:
            tr.instant("ft_inject", "fault", cls="device_sdc",
                       scope="coll", rank=self.rank)
        _obs.record_event(_obs.EV_FT_INJECT,
                          _obs.intern("device_sdc"),
                          _obs.intern("coll"), rank=self.rank)
        return True


def sdc_injector(rank: int,
                 size: Optional[int] = None) -> Optional[SdcInjector]:
    p = plan()
    if "device_sdc" not in p or rank not in victim_ranks(size):
        return None
    return SdcInjector(rank, p["device_sdc"], _sdc_period_var.value)


class RmaInjector(_Scoped):
    """AM-apply delay for one-sided windows: a 'rma_delay' roll holds
    the target's apply loop, so passive-target lock waits and pt2pt op
    application see slow targets (the osc analog of the collective
    rendezvous straggler)."""

    def maybe_delay(self) -> float:
        """Returns seconds the AM apply sleeps (0 = clean)."""
        if self._roll() == "rma_delay":
            return max(0, _delay_ms_var.value) / 1000.0
        return 0.0


def rma_injector(rank: int) -> Optional[RmaInjector]:
    p = {c: r for c, r in plan().items() if c == "rma_delay"}
    if not p:
        return None
    return RmaInjector("rma", rank, p)


#: permanent rank-level scenario classes (armed once at MPI_Init)
RANK_CLASSES = ("rank_kill",)


def node_faults(node_id: int) -> List[str]:
    """Node-level scenario classes armed on THIS node (the daemon
    consults this once at startup and arms timers)."""
    if node_id != _victim_var.value:
        return []
    p = plan()
    return [c for c in NODE_CLASSES if c in p]


def victim_ranks(size: Optional[int] = None) -> List[int]:
    """Parse ft_inject_victim_rank into the concrete victim list.

    Accepts a single rank, a comma list, or ``random`` (one victim,
    chosen seed-deterministically so a chaos run replays from its
    seed).  ``random`` needs the world size — pass it, or export
    TPUMPI_SIZE; without either the random pick degrades to rank 1.
    """
    s = str(_victim_rank_var.value).strip()
    if not s:
        return []
    if s.lower() == "random":
        if size is None:
            import os
            size = int(os.environ.get("TPUMPI_SIZE", "0")) or None
        if not size:
            return [1]
        rng = random.Random(f"{_seed_var.value}:victim_rank")
        return [rng.randrange(size)]
    out: List[int] = []
    for item in s.split(","):
        item = item.strip()
        if item:
            out.append(int(item))
    return out


def rank_faults(rank: int, size: Optional[int] = None) -> List[str]:
    """Permanent rank-level scenario classes armed on THIS global
    rank (mpi_init consults this once and arms a one-shot timer;
    tpud consults it to kill the victim's child process for real)."""
    if rank not in victim_ranks(size):
        return []
    p = plan()
    return [c for c in RANK_CLASSES if c in p]


def rank_kill_victim() -> int:
    """First armed victim (compat shim for single-victim callers)."""
    v = victim_ranks()
    return v[0] if v else -1


def after_s() -> float:
    return max(0.0, _after_var.value)
