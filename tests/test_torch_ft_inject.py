"""Delay faults through both packages: ft_inject's ``delay`` straggler at
the device-collective rendezvous and its ``rma_delay`` at the one-sided
window's AM apply (ompi_tpu_torch/ft_inject, wired into coll/device
``meet`` / ``meet_begin`` and osc/window ``_apply``).

Analogs of the reference's chaos cases: test_fused_under_delay_faults
(tests/test_coll_fusion.py), test_plan_under_delay_faults
(tests/test_coll_plan.py) and test_segmented_under_delay_faults
(tests/test_coll_pipeline.py), run on the port's coll/hbm (every rank
on torch.device("cpu")) and its mesh (logical devices of the CPU):
seed-driven stragglers change no byte, and the bytes are the
reference's.  The rma_delay case runs the one-sided RMA workloads
(ompi_tpu_torch.testing.rma) under the device window with the delay
armed.  The injectors' seeded rolls are the reference's, roll for roll.
"""

import jax
import numpy as np
import pytest
import torch

import ompi_tpu.coll.plan  # noqa: F401  (registers the plan knobs)
import ompi_tpu.ft_inject as ref_fi
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch import ft_inject as port_fi
from ompi_tpu_torch import osc as port_osc
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.osc import device as _port_device  # noqa: F401
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks
from ompi_tpu_torch.testing.rma import (Buffers, counter_workload,
                                        expected_halo, halo_workload)

CPU = torch.device("cpu")

DELAY = {"ft_inject_plan": "delay", "ft_inject_seed": 7,
         "ft_inject_rate": 0.5, "ft_inject_delay_ms": 5,
         "ft_inject_skip": 0}
RMA_DELAY = dict(DELAY, ft_inject_plan="rma_delay")
# everything >= 2 KiB takes the tiers, in 4 KiB segments
PLAN_ON = {"coll_pipeline_enable": True, "coll_pipeline_min_bytes": 2048,
           "coll_seg_size": 4096, "coll_pipeline_rd_max_bytes": 0,
           "coll_hier_enable": False, "coll_plan_enable": True}
PIPE_ON = dict(PLAN_ON, coll_plan_enable=False)


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


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x).tobytes()
    return np.asarray(x).tobytes()


def _ref(tier):
    def run(n, fn):
        kw = {"devices": True} if tier == "mesh" else \
            {"device_map": lambda r: jax.devices()[0]}
        return ref_run_ranks(
            n, lambda c: fn(c, lambda a: jax.device_put(a, c.device),
                            ref_op), **kw)
    return run


def _port(tier):
    dm = logical_devices("cpu") if tier == "mesh" else (lambda r: CPU)

    def run(n, fn):
        return port_run_ranks(
            n, lambda c: fn(c, lambda a: convert.to_torch(a, c.device),
                            port_op), device_map=dm)
    return run


def _chaos_parity(tier, fn, tier_knobs):
    """fn's results: the port clean, the port under delay faults, and
    the reference under the same faults — all three the same."""
    with knobs(tier_knobs):
        clean = _port(tier)(4, fn)
        with knobs(DELAY):
            chaotic = _port(tier)(4, fn)
            ref = _ref(tier)(4, fn)
    assert chaotic == clean
    assert chaotic == ref
    return clean


def _interleaved(comm, put, op):
    """The canonical fused batch: mixed kinds, ops, dtypes, a scalar."""
    r = comm.rank
    b = np.ones((8,), np.float32) * (r + 1)
    b[0] = -r
    reqs = [comm.iallreduce_arr(put(np.arange(16, dtype=np.int32) * (r + 1)),
                                op.SUM),
            comm.iallreduce_arr(put(b), op.MAX),
            comm.ibcast_arr(put(np.full((5,), r * 3 + 1, np.int32)), 1),
            comm.iallreduce_arr(put(np.asarray(r + 2, dtype=np.int32)),
                                op.PROD)]
    for q in reqs:
        q.wait()
    return [_bytes(q.result) for q in reqs]


@pytest.mark.parametrize("tier", ["hbm", "mesh"])
def test_fused_under_delay_faults(tier):
    """Stragglers at the batch's one rendezvous change no byte."""
    _chaos_parity(tier, _interleaved, {"coll_pipeline_enable": False})


def _reduce_ops(comm, put, op):
    r = comm.rank
    out = []
    for n in (4096, 4097, 4095):
        out.append(_bytes(comm.allreduce_arr(
            put((np.arange(n, dtype=np.float32) % 11) + r), op.SUM)))
        out.append(_bytes(comm.allreduce_arr(
            put(((np.arange(n) % 17) * (r + 1)).astype(np.int32)), op.MAX)))
    return b"".join(out)


@pytest.mark.parametrize("tier", ["hbm", "mesh"])
def test_plan_under_delay_faults(tier):
    """Straggler arrival orders through the plan path (one rendezvous
    an op) change nothing."""
    _chaos_parity(tier, _reduce_ops, PLAN_ON)


def _mixed_ops(comm, put, op):
    r = comm.rank
    base = (np.arange(4099, dtype=np.float32) % 11).astype(np.float32)
    out = [_bytes(comm.allreduce_arr(put(base + r), op.SUM)),
           _bytes(comm.bcast_arr(put(base * (r + 1)), root=2))]
    a2a = _bytes(comm.alltoall_arr(put(np.arange(1031 * 4, dtype=np.int32)
                                       + 100000 * r)))
    return b"".join(out), a2a


@pytest.mark.parametrize("tier", ["hbm", "mesh"])
def test_segmented_under_delay_faults(tier):
    """Straggler arrival orders through the pipelined begin/finish
    schedule (several segments an op, tails included) change no
    byte."""
    clean = _chaos_parity(tier, _mixed_ops, PIPE_ON)
    assert len({common for common, _ in clean}) == 1


@pytest.mark.parametrize("workload", ["rma_counter", "halo_stencil"])
def test_rma_workloads_under_rma_delay(workload, monkeypatch):
    """rma_delay holds the target's AM apply (the device window's
    passive lock and unlock traffic rides it): the workloads' bytes are
    the clean run's and the reference's under the same faults."""
    from ompi_tpu import osc as ref_osc
    from ompi_tpu.osc import device as _ref_device  # noqa: F401

    def wl(osc, ops, bufs):
        return counter_workload(osc, ops, bufs) \
            if workload == "rma_counter" else halo_workload(osc, bufs)

    def port_run(bufs):
        return port_run_ranks(4, wl(port_osc, port_op, bufs),
                              device_map=logical_devices("cpu"))

    hits = []
    roll = port_fi.RmaInjector.maybe_delay

    def counted(self):
        d = roll(self)
        if d:
            hits.append(d)
        return d

    monkeypatch.setattr(port_fi.RmaInjector, "maybe_delay", counted)
    clean = port_run(Buffers(True))
    with knobs(RMA_DELAY):
        chaotic = port_run(Buffers(True))
        ref = ref_run_ranks(4, wl(ref_osc, ref_op, Buffers(False)),
                            devices=True)
    for r in range(4):
        assert chaotic[r]["component"] == "DeviceWindow"
        for k in clean[r]:
            if k != "component":
                assert chaotic[r][k] == clean[r][k] == ref[r][k], (r, k)
        if workload == "halo_stencil":
            assert chaotic[r]["halo"] == expected_halo(r, 4)
    if workload == "rma_counter":  # its passive-target epochs were held
        assert hits


@pytest.mark.parametrize("scope", ["coll", "rma"])
def test_delay_rolls_match_reference(scope):
    """The seeded rolls (skip, rate, cap) fire at the reference's
    events; an empty plan arms nothing."""
    plan = "delay" if scope == "coll" else "rma_delay"
    with knobs(dict(DELAY, ft_inject_plan=plan, ft_inject_skip=3,
                    ft_inject_max=5)):
        for rank in (0, 3):
            rolls = []
            for fi in (ref_fi, port_fi):
                inj = fi.coll_injector(rank) if scope == "coll" \
                    else fi.rma_injector(rank)
                rolls.append([inj.maybe_delay() for _ in range(40)])
            assert rolls[0] == rolls[1]
            assert rolls[1][:3] == [0.0] * 3
            assert sum(1 for d in rolls[1] if d) == 5
    with knobs({"ft_inject_plan": "", "ft_inject_victim_rank": "1,3"}):
        assert port_fi.coll_injector(0) is None
        assert port_fi.victim_ranks() == ref_fi.victim_ranks() == [1, 3]
