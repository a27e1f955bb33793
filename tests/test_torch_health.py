"""The gray-failure health plane (obs/health) and the ``host_slow``
injector through both packages: ompi_tpu.obs.health and its port,
ompi_tpu_torch.obs.health.

Ports the host-plane cases of tests/test_grayfail.py (:126-262): the
tick is held by the hot-path audit, the hysteresis ladder walks one
rung per streak, an overdue beat scores before it arrives, the
adaptive grace sits on its floor for a crisp host and widens for a
jittery one, and the doctor names a straggler on a sick host.  Each
runs through both packages.  On top of those, seeded synthetic traces
of beats, skew notes, convictions, exclusions and resets go through
both packages' ``HealthPlane`` and ``HostBeatEstimator``: state,
score, streaks, pending, grace and ``collect()`` equal at every tick.

The pool that feeds the plane (``tools/dvm.py``: its heartbeat sweep
and ``_health_collect``) is tested in tests/test_torch_grayfail.py.
Its convict-hook wiring is done here by hand, as the pool does it: a
``device_sdc`` conviction quarantines the victim's host at the next
tick in both packages, and ``collect()`` drains it into the degraded
mask the hierarchical tier reads.

Tolerance: exact (integer state machines; the same inputs).
"""

import numpy as np
import pytest
import torch

import ompi_tpu.ft_inject as ref_fi
import ompi_tpu.runtime.oob  # noqa: F401  (registers its knobs)
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.obs import health as ref_health
from ompi_tpu.obs import integrity as ref_ig
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu.tools import doctor as ref_doctor
from ompi_tpu_torch import convert, obs
from ompi_tpu_torch import ft_inject as port_fi
from ompi_tpu_torch.coll import device as port_device
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.obs import health as port_health
from ompi_tpu_torch.obs import integrity as port_ig
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import run_ranks as port_run_ranks
from ompi_tpu_torch.tools import doctor as port_doctor
from ompi_tpu_torch.tools import hotpath_audit

import jax  # noqa: E402  (after the reference's imports, as elsewhere)

CPU = torch.device("cpu")
MS = 1_000_000  # ns a ms
PKGS = {"port": (port_health, port_registry), "ref": (ref_health,
                                                     ref_registry)}


class knobs:
    """Set MCA knobs in both registries; restore on exit."""

    def __init__(self, vals) -> None:
        self.vals = vals

    def __enter__(self):
        self.saved = [(reg, {k: reg.get(k) for k in self.vals})
                      for reg in (ref_registry, port_registry)]
        for reg, _ in self.saved:
            for k, v in self.vals.items():
                reg.set(k, v)
        return self

    def __exit__(self, *exc):
        for reg, saved in self.saved:
            for k, v in saved.items():
                reg.set(k, v)
        for health in (ref_health, port_health):
            health.set_degraded_mask(0)


def _pv(reg, name):
    return reg._pvars[name].read()


def _reset_gauge(hp):
    """Leave no process-global residue (the degraded mask, the
    fleet_host_health level) for later tests in this process."""
    for h in range(hp.hosts):
        hp.reset_host(h)
    hp.collect()


# -- the audited hot tick -----------------------------------------------------

def test_health_tick_is_hotpath_audited():
    """HealthPlane.tick is declared hot in the port's audit, as in the
    reference's, and passes it."""
    funcs = hotpath_audit.HOT_FUNCTIONS.get("ompi_tpu_torch/obs/health.py")
    assert funcs and "HealthPlane.tick" in funcs
    assert hotpath_audit.audit() == []


# -- tests/test_grayfail.py:139-262 through both packages ---------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_hysteresis_ladder_one_rung_per_streak(pkg):
    """A slow host escalates healthy -> degraded -> quarantined one rung
    per trip streak and recovers one rung per clear streak; the crisp
    host beside it never trips; the degraded mask and the
    fleet_host_health gauge follow."""
    health, reg = PKGS[pkg]
    with knobs({"health_enable": 1, "health_tick_ms": 1,
                "health_trip_ticks": 2, "health_clear_ticks": 2,
                "health_degrade_score": 40,
                "health_quarantine_score": 75}):
        base_lvl = _pv(reg, "fleet_host_health")
        expect = 100 * MS
        hp = health.HealthPlane(2, expect_beat_ns=expect,
                                floor_grace_ns=1000 * MS)
        t0 = 1000 * MS
        hp.note_beat(0, t0)
        hp.note_beat(1, t0)
        states = []
        t = t0
        for i in range(1, 9):  # host 1 beats once per 800 ms
            t = t0 + i * expect
            hp.note_beat(0, t)
            if i % 8 == 0:
                hp.note_beat(1, t)
            hp.tick(t + 1)
            states.append(hp.state[1])
            if hp.pending[1]:
                assert hp.collect() == [1]
        assert states[-1] == health.QUARANTINED
        for a, b in zip(states, states[1:]):
            assert b - a <= 1, f"ladder skipped a rung: {states}"
        assert health.DEGRADED in states, states
        assert not hp.placement_ok(1) and hp.placement_ok(0)
        assert health.node_degraded(1) and not health.node_degraded(0)
        assert _pv(reg, "fleet_host_health") == base_lvl + 1
        assert hp.snapshot()[1]["state"] == "quarantined"
        assert hp.state[0] == health.HEALTHY and hp.score[0] == 0
        down = []
        for i in range(1, 16):
            t += expect
            hp.note_beat(0, t)
            hp.note_beat(1, t)
            hp.tick(t + 1)
            down.append(hp.state[1])
            if hp.pending[1]:
                assert hp.collect() == [1]
        assert down[-1] == health.HEALTHY, down
        for a, b in zip(down, down[1:]):
            assert a - b <= 1, f"recovery skipped a rung: {down}"
        assert health.DEGRADED in down, down
        hp.collect()
        assert not health.node_degraded(1)
        assert _pv(reg, "fleet_host_health") == base_lvl


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_overdue_beat_scores_before_arrival(pkg):
    """Once a beat is 3x late the gap itself replaces the EWMA; a host
    that never beat is skipped."""
    health, _ = PKGS[pkg]
    with knobs({"health_enable": 1, "health_tick_ms": 1}):
        expect = 100 * MS
        hp = health.HealthPlane(2, expect_beat_ns=expect,
                                floor_grace_ns=1000 * MS)
        t = 0
        for i in range(5):
            t = i * expect
            hp.note_beat(0, t)
        hp.tick(t + 1)
        assert hp.score[0] == 0
        hp.tick(t + 9 * expect)
        assert hp.score[0] == 100
        assert hp.score[1] == 0 and hp.up_streak[1] == 0


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_adaptive_grace_floor_and_widening(pkg):
    """A crisp host sits exactly at the static floor; a jittery host
    widens its own grace past it; the pacing multiplier is honoured."""
    health, _ = PKGS[pkg]
    with knobs({"health_grace_jitter_k": 4}):
        floor = 1000 * MS
        est = health.HostBeatEstimator(2, floor_ns=floor, mult=6)
        t0, t1 = 0, 0
        for _ in range(10):
            t0 += 100 * MS
            est.note(0, t0)
        assert est.grace_ns(0) == floor
        for i in range(10):
            t1 += (50 if i % 2 == 0 else 450) * MS
            est.note(1, t1)
        assert est.grace_ns(1) > floor
        assert est.grace_ns(99) == floor
        est12 = health.HostBeatEstimator(1, floor_ns=floor, mult=12)
        t = 0
        for _ in range(10):
            t += 100 * MS
            est12.note(0, t)
        assert est12.grace_ns(0) > floor


def _straggler_doc():
    return {"sid": 3, "np": 4, "ns": "s3", "run_ms": 900, "est_ms": 100,
            "factor_pct": 300, "mttd_ms": 12, "placement": [0, 0, 1, 1],
            "host_health": [
                {"host": 0, "state": "healthy", "score": 0,
                 "signals": [], "excluded": False},
                {"host": 1, "state": "degraded", "score": 62,
                 "signals": ["beat_slow", "rdv_skew"], "excluded": False}]}


@pytest.mark.parametrize("state,excluded,straggler",
                         [("degraded", False, True),
                          ("healthy", False, False),
                          ("quarantined", True, False)],
                         ids=["degraded", "healthy", "excluded"])
def test_doctor_straggler_verdict(state, excluded, straggler):
    """A stall with ranks resident on a host scored sick is a straggler
    (host, score, signals and resident ranks named); a healthy fleet
    is local compute; an excluded host belongs to the liveness plane.
    The same lines in both packages."""
    doc = _straggler_doc()
    doc["host_health"][1].update(state=state, excluded=excluded)
    lines = port_doctor.verdict(doc)
    assert lines == ref_doctor.verdict(doc)
    text = "\n".join(lines)
    assert ("VERDICT: straggler" in text) == straggler
    if straggler:
        assert "host 1 is degraded" in text and "score 62" in text
        assert "[2,3]" in text and "beat_slow" in text
    else:
        assert "straggler" not in text and "local compute" in text


# -- seeded synthetic traces through both packages -----------------------------

def _trace(seed, hosts=4, steps=120):
    """A seeded event list: host 0 a metronome, host 1 slow by a seeded
    factor for a middle stretch, host 2 jittery, host 3 silent until a
    late start; rdv skew notes, a conviction, an exclusion and a reset
    at seeded moments; a tick every step, a collect every few."""
    rng = np.random.default_rng(seed)
    expect = 100 * MS
    slow = int(rng.integers(3, 12))
    lo, hi = sorted(int(v) for v in rng.integers(10, steps - 10, 2))
    sdc_at = int(rng.integers(20, steps - 5))
    excl_at = int(rng.integers(5, steps - 20))
    evs = []
    last = [0] * hosts
    for i in range(1, steps + 1):
        t = 1000 * MS + i * expect
        evs.append(("beat", 0, t))
        gap = slow if lo <= i < hi else 1
        if t - last[1] >= gap * expect:
            evs.append(("beat", 1, t))
            last[1] = t
        evs.append(("beat", 2, t + int(rng.integers(-40, 40)) * MS))
        if i > steps // 2:
            evs.append(("beat", 3, t))
        if rng.random() < 0.2:
            evs.append(("skew", int(rng.integers(0, hosts)),
                        int(rng.integers(0, 120_000))))
        if rng.random() < 0.1:
            evs.append(("qwait", int(rng.integers(0, hosts)),
                        int(rng.integers(0, 5_000))))
        if i == sdc_at:
            evs.append(("sdc", int(rng.integers(0, hosts))))
        if i == excl_at:
            evs.append(("exclude", 2, True))
        if i == excl_at + 10:
            evs.append(("exclude", 2, False))
        if i == sdc_at + 3:
            evs.append(("reset", 0))
        evs.append(("tick", t + 1))
        if i % int(rng.integers(1, 4)) == 0:
            evs.append(("collect",))
    return evs


def _replay(health, evs):
    """Every observable after each tick and each collect."""
    hp = health.HealthPlane(4, expect_beat_ns=100 * MS,
                            floor_grace_ns=1000 * MS)
    seen = []
    for ev in evs:
        kind = ev[0]
        if kind == "beat":
            hp.note_beat(ev[1], ev[2])
        elif kind == "skew":
            hp.note_rdv_skew(ev[1], ev[2])
        elif kind == "qwait":
            hp.note_queue_wait(ev[1], ev[2])
        elif kind == "sdc":
            hp.note_sdc(ev[1])
        elif kind == "exclude":
            hp.exclude(ev[1], ev[2])
        elif kind == "reset":
            hp.reset_host(ev[1])
        elif kind == "tick":
            hit = hp.tick(ev[1])
            seen.append(("tick", hit, list(hp.state), list(hp.score),
                         list(hp.up_streak), list(hp.down_streak),
                         list(hp.pending), list(hp.est.grace),
                         hp.degraded_n, hp.quarantined_n, hp.sdc_n))
        else:
            seen.append(("collect", hp.collect(),
                         [health.node_degraded(h) for h in range(4)],
                         hp.snapshot(), [hp.placement_ok(h)
                                         for h in range(4)]))
    _reset_gauge(hp)
    return seen


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_synthetic_traces_match_reference(seed):
    """The same seeded trace through both packages' planes: every tick's
    transitions, states, scores, streaks, pending flags and graces, and
    every collect's hosts, degraded mask, snapshot rows and placement
    verdicts are equal; the trace walks the ladder somewhere."""
    evs = _trace(seed)
    with knobs({"health_enable": 1, "health_tick_ms": 1,
                "health_trip_ticks": 2, "health_clear_ticks": 3}):
        port = _replay(port_health, evs)
        ref = _replay(ref_health, evs)
    assert port == ref
    assert any(s[0] == "tick" and max(s[2]) >= port_health.DEGRADED
               for s in port)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_plane_disabled_never_ticks(pkg):
    """health_enable 0: the tick is a no-op, whatever the beats say."""
    health, _ = PKGS[pkg]
    with knobs({"health_enable": 0, "health_tick_ms": 1}):
        hp = health.HealthPlane(2, expect_beat_ns=100 * MS,
                                floor_grace_ns=1000 * MS)
        hp.note_beat(0, 1)
        hp.note_beat(0, 10_000 * MS)
        assert hp.tick(20_000 * MS) == 0 and hp.ticks == 0
        assert hp.score == [0, 0]


# -- the convict hook, wired by hand as the pool wires it ---------------------

INJECT = {"integrity_enable": 1, "integrity_sample": 1,
          "integrity_sample_auto": 0, "ft_inject_plan": "device_sdc:1",
          "ft_inject_victim_rank": "1", "ft_inject_sdc_period": 1}


def test_convict_hook_quarantines_the_victims_host():
    """A ``device_sdc`` conviction of rank 1, which lives on host 0 (the
    ranks' node ids are rank // 2), reaches a plane through a hook
    installed as ``tools/dvm.py:708-717`` does it: the next tick
    quarantines host 0 outright in both packages, and ``collect()``
    drains the transition into the degraded mask in both."""
    n = 4
    xs = [np.arange(64, dtype=np.int32) * (r + 1) for r in range(n)]

    def prog(put, op):
        def fn(comm):
            # set before the deposit, so before the conviction reads it
            # (no barrier: under injection the reference's coll/sm
            # barrier meets too, and its flip refuses a None deposit)
            comm.state.rte.node_id = comm.rank // 2
            comm.allreduce_arr(put(xs[comm.rank], comm), op.SUM)
        return fn

    planes = {}
    hooks = {}
    for name, health, ig in (("port", port_health, port_ig),
                             ("ref", ref_health, ref_ig)):
        hp = planes[name] = health.HealthPlane(
            2, expect_beat_ns=100 * MS, floor_grace_ns=1000 * MS)

        def _on_sdc(rec, _hp=hp):
            _hp.note_sdc(int(rec.get("host", 0)))
        hooks[name] = (ig, _on_sdc)
    saved = [(reg, {k: reg.get(k) for k in INJECT})
             for reg in (ref_registry, port_registry)]
    try:
        for reg, _ in saved:
            for k, v in INJECT.items():
                reg.set(k, v)
        for ig, hook in hooks.values():
            ig.refresh()
            ig.reset()
            ig.install_convict_hook(hook)
        port_run_ranks(n, prog(lambda a, c: convert.to_torch(a, c.device),
                               port_op), device_map=lambda r: CPU)
        ref_run_ranks(n, prog(lambda a, c: jax.device_put(a, c.device),
                              ref_op),
                      device_map=lambda r: jax.devices()[0])
        for name, hp in planes.items():
            assert hp.sdc[0] > 0 and hp.sdc[1] == 0, name
            assert hp.tick(1) == 1
            assert hp.state == [port_health.QUARANTINED,
                                port_health.HEALTHY], name
        assert planes["port"].snapshot() == planes["ref"].snapshot()
        assert planes["port"].collect() == planes["ref"].collect() == [0]
        assert port_health.node_degraded(0) and ref_health.node_degraded(0)
        assert not port_health.node_degraded(1)
    finally:
        for ig, hook in hooks.values():
            ig.remove_convict_hook(hook)
            ig.reset()
        for reg, vals in saved:
            for k, v in vals.items():
                reg.set(k, v)
        for ig, _ in hooks.values():
            ig.refresh()
        for hp in planes.values():
            _reset_gauge(hp)


# -- the host_slow injector -----------------------------------------------------

@pytest.mark.parametrize("factor,delay_ms", [(10, 20), (3, 5), (1, 7)])
def test_host_slow_delay_matches_reference(factor, delay_ms):
    """``delay_s()`` and ``beat_interval_s()`` equal the reference's for
    the same knobs (the factor floored at 2, the beat capped at 3/4 of
    a grace); only the victim host's residents get an injector."""
    with knobs({"ft_inject_plan": "host_slow",
                "ft_inject_victim_host": 1,
                "ft_inject_host_slow_factor": factor,
                "ft_inject_delay_ms": delay_ms}):
        p, r = port_fi.host_slow_injector(1), ref_fi.host_slow_injector(1)
        assert port_fi.host_slow_injector(0) is None
        assert ref_fi.host_slow_injector(0) is None
        assert p.factor == r.factor
        assert p.delay_s() == r.delay_s()
        for iv, grace in ((0.5, 0.0), (0.5, 2.0), (1.0, 3.0), (2.0, 1.0)):
            assert p.beat_interval_s(iv, grace) == \
                r.beat_interval_s(iv, grace)
    with knobs({"ft_inject_plan": ""}):
        assert port_fi.host_slow_injector(1) is None


def test_host_slow_sleeps_only_on_the_victim_host(monkeypatch):
    """4 ranks, node ids rank // 2, victim host 1: at every deposit only
    ranks 2 and 3 sleep delay_ms*(factor-1); the result is the clean
    run's; each resident's injector announces itself once (one
    ft_inject event a victim rank)."""
    n = 4
    import time as _time
    slept = []
    real_sleep = _time.sleep

    class _Time:
        def __getattr__(self, name):
            return getattr(_time, name)

        @staticmethod
        def sleep(s):
            import threading
            name = threading.current_thread().name
            if s > 0.01:
                slept.append((name, s))
                return None
            return real_sleep(s)

    monkeypatch.setattr(port_device, "time", _Time())

    def fn(comm):
        comm.state.rte.node_id = comm.rank // 2
        x = torch.arange(16, dtype=torch.int32) * (comm.rank + 1)
        outs = [convert.to_numpy(comm.allreduce_arr(x, port_op.SUM))
                for _ in range(3)]
        return [o.tobytes() for o in outs]

    clean = port_run_ranks(n, fn, device_map=lambda r: CPU)
    rec = obs.recorder()
    h0 = rec.recorded
    with knobs({"ft_inject_plan": "host_slow", "ft_inject_victim_host": 1,
                "ft_inject_host_slow_factor": 10,
                "ft_inject_delay_ms": 20}):
        slow = port_run_ranks(n, fn, device_map=lambda r: CPU)
    assert slow == clean
    assert sorted(slept) == sorted(
        [(f"mpi-rank-{r}", 0.18) for r in (2, 3) for _ in range(3)])
    evs = [e for e in rec.snapshot(last=rec.recorded - h0)
           if e["name"] == "ft_inject"]
    assert [e["args"] for e in evs] == [{"cls": "host_slow",
                                         "scope": "host"}] * 2
