"""MCA-selectable fault injection: the injectors of the port's paths.

Port of the part of the reference's ft_inject (ompi_tpu/ft_inject/
__init__.py) that the port's choke points consume: a deterministic,
seed-driven interposer, driven by MCA params only, so a chaos run is
``--mca ft_inject_plan delay --mca ft_inject_seed 7`` with no code
change.  Ported injection points:

  * the device-collective rendezvous (coll/device.py ``meet`` and
    ``meet_begin``): ``delay`` holds the depositing rank thread
    (straggler arrival orders), ``device_sdc`` flips a bit of the
    victim rank's operand after the integrity gate digested it (the
    silent failure only obs/integrity can see);
  * the one-sided window's active-message apply (osc/window.py):
    ``rma_delay`` holds the target's apply loop.

Determinism: a rolling injector owns a ``random.Random`` seeded from
``(ft_inject_seed, scope, rank)``, so a chaos run replays bit for bit
from its seed; ``device_sdc`` uses no RNG at all (an armed op count
and a period).  ``ft_inject_max`` bounds the injections a scope makes.

An injection that fires leaves an ``ft_inject`` instant (cat
``fault``) on the injecting rank's trace when tracing is on.

Not ported (ROADMAP.md): the btl/tcp frame faults, kv, checkpoint
I/O, dvm, node, rank, host and process kills, ``rdv_sever`` (with the
hang doctor), ``host_slow`` and ``net_jitter`` (with the health plane),
and the flight-recorder event records an injection leaves (A6).
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
         "that count, not a rate).  Empty = framework disabled")
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
_victim_rank_var = registry.register(
    "ft", "inject", "victim_rank", "1", str,
    help="Global rank(s) the device_sdc class corrupts: a single "
         "rank, a comma list ('1,3'), or 'random' for a "
         "seed-deterministic pick")
_delay_ms_var = registry.register(
    "ft", "inject", "delay_ms", 20, int,
    help="How long a 'delay' or 'rma_delay' hit holds its thread")
_sdc_period_var = registry.register(
    "ft", "inject", "sdc_period", 0, int,
    help="device_sdc repeat period after the first armed flip (every "
         "Nth subsequent collective on the victim also flips); 0 = "
         "one-shot — probes measuring detection RATE arm a period so "
         "one run carries many independent flips")


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
                from ompi_tpu_torch import trace
                tr = trace.current_tracer()
                if tr is not None:
                    tr.instant("ft_inject", "fault", cls=cls,
                               scope=self.scope)
                return cls
        return None


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
        from ompi_tpu_torch import trace
        tr = trace.current_tracer()
        if tr is not None:
            tr.instant("ft_inject", "fault", cls="device_sdc",
                       scope="coll", rank=self.rank)
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
