"""ULFM rank-failure mitigation through the port (ompi_tpu_torch/ft/
ulfm) with the reference beside it: detect -> ERR_PROC_FAILED ->
revoke / agree / shrink, on the host path and on both device tiers.

Each case runs the same rank program, from the same numpy inputs,
through both packages' thread worlds (the reference's device cases on
the conftest's virtual CPU devices, ``run_ranks(devices=True)``; the
port's on the CPU: ``lambda r: torch.device("cpu")`` for coll/hbm,
``logical_devices("cpu")`` for the mesh tier, where the kernels take
their plain versions).  Tolerance: error codes, survivor views and
results compare exactly; the device results are float32 sums of small
integers, exact in any order, so they compare byte for byte.  Kills
are ``kill_now`` (no timers but the one arm_rank_kill case), and a
survivor waits for the failure record by polling, not by sleeping.

Pinned divergences, each with the test named after it:
  * no compiled-program cache to purge: the port's kernel libraries
    do not depend on the device set, so shrink drops the per-comm
    caches and the rendezvous only
    (``test_divergence_no_compiled_program_cache``);
  * the posted result wins over a late failure: a survivor still in a
    meeting whose result is posted returns it, where the reference's
    wait loop runs the abort check first and may raise
    (``test_divergence_posted_result_wins_over_late_failure``; the
    reference's unsteady test_plan_across_shrink_epoch and
    test_segmented_across_shrink_epoch, whose port counterparts are
    here);
  * shrink (and a survivor's rejoin) revokes the communicator it
    replaces, so a survivor parked on a live member that raised and
    left is released (``test_divergence_shrink_revokes_the_old_comm``).
"""

import time

import numpy as np
import pytest
import torch

from ompi_tpu import errhandler as ref_eh
from ompi_tpu import ft_inject as _ref_fi  # noqa: F401 (knobs)
from ompi_tpu.coll import pipeline as _ref_pipeline  # noqa: F401 (knobs)
from ompi_tpu.coll import plan as _ref_plan  # noqa: F401 (knobs)
from ompi_tpu.ft import ulfm as ref_ulfm
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import errhandler as eh
from ompi_tpu_torch import ft_inject
from ompi_tpu_torch.coll import device as port_device
from ompi_tpu_torch.coll import pipeline as _pipeline  # noqa: F401 (knobs)
from ompi_tpu_torch.coll import plan as _plan  # noqa: F401 (knobs)
from ompi_tpu_torch.ft import ulfm
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import logical_devices, run_ranks

PF = eh.ERR_PROC_FAILED
PFP = eh.ERR_PROC_FAILED_PENDING
RV = eh.ERR_REVOKED
FT = (PF, PFP, RV)
assert (ref_eh.ERR_PROC_FAILED, ref_eh.ERR_PROC_FAILED_PENDING,
        ref_eh.ERR_REVOKED) == FT

HBM = lambda r: torch.device("cpu")  # noqa: E731
TIERS = {"hbm": HBM, "mesh": logical_devices("cpu")}
PKGS = {"port": (ulfm, port_op, eh.MPIException),
        "ref": (ref_ulfm, ref_op, ref_eh.MPIException)}


def both(n, fn, **kw):
    """fn(comm, pkg) on n ranks through each package's host world."""
    port = run_ranks(n, lambda c: fn(c, "port"), **kw)
    ref = ref_run_ranks(n, lambda c: fn(c, "ref"), **kw)
    return port, ref


def wait_failed(comm, grank, timeout=10.0):
    """Poll this rank's ULFM state until ``grank``'s failure record is
    ingested (both packages: same attributes)."""
    u = comm.state.ulfm
    deadline = time.monotonic() + timeout
    while True:
        u.poll()
        if grank in u.failed:
            return
        assert time.monotonic() < deadline, "failure never detected"
        time.sleep(0.001)


class knobs:
    """Set MCA knobs in both registries; restore on exit."""

    def __init__(self, vals) -> None:
        self.vals = vals

    def __enter__(self):
        self.saved = [(reg, {k: reg.get(k) for k in self.vals})
                      for reg in (registry, ref_registry)]
        for reg, _ in self.saved:
            for k, v in self.vals.items():
                reg.set(k, v)
        return self

    def __exit__(self, *exc):
        for reg, saved in self.saved:
            for k, v in saved.items():
                reg.set(k, v)


def _port_dev_arr(comm, a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref_dev_arr(comm, a):
    import jax
    return jax.device_put(a, comm.device)


# ---- detect + report ------------------------------------------------

def test_parked_recv_raises_proc_failed():
    """A receive parked on a peer that dies completes with
    ERR_PROC_FAILED instead of hanging."""
    def fn(comm, pkg):
        u, _, exc = PKGS[pkg]
        if comm.rank == 1:
            time.sleep(0.05)
            u.kill_now(comm.state)
        buf = np.zeros(4)
        with pytest.raises(exc) as ei:
            comm.Recv(buf, source=1, tag=7)
        return ei.value.code

    port, ref = both(3, fn, allow_failures=True)
    assert port == ref == [PF, None, PF]
    assert ulfm._pv_failures.read() >= 1


def test_detection_latency_bound():
    """arm_rank_kill (the ft_inject rank_kill path) fires out of the
    victim's blocking wait; the survivor learns of the death and
    drains within a small multiple of the kill delay."""
    def fn(comm, pkg):
        u, _, exc = PKGS[pkg]
        if comm.rank == 1:
            u.arm_rank_kill(comm.state, 0.05)
            comm.Recv(np.zeros(4), source=0, tag=99)  # parked: killed
            return "victim survived"
        t0 = time.monotonic()
        with pytest.raises(exc) as ei:
            comm.Recv(np.zeros(4), source=1, tag=42)
        return (ei.value.code, time.monotonic() - t0)

    for r in both(2, fn, allow_failures=True):
        assert r[1] is None
        code, dt = r[0]
        assert code == PF and 0.04 <= dt < 10.0, r


def test_parked_allreduce_raises_proc_failed():
    """Survivors parked inside a blocking host collective drain with a
    ULFM error when a member (rank 0) dies.  The port's host allreduce
    is p2p recursive doubling (the reference's thread world takes
    coll/sm, which the port does not have): a survivor whose partner
    raised and left stays parked on that live partner, so a survivor
    that catches the error revokes the comm — the ULFM idiom — and the
    parked one drains with ERR_REVOKED."""
    def fn(comm, pkg):
        u, op, exc = PKGS[pkg]
        if comm.rank == 0:
            time.sleep(0.05)
            u.kill_now(comm.state)
        x = np.full(32, comm.rank + 1.0)
        with pytest.raises(exc) as ei:
            try:
                comm.Allreduce(x, np.empty_like(x), op.SUM)
            except exc:
                comm.revoke()
                raise
        return ei.value.code

    for r in both(4, fn, allow_failures=True):
        assert r[0] is None and all(c in FT for c in r[1:]), r


def test_send_to_failed_peer_raises_at_entry():
    """Once a failure is known, NEW ops naming the dead peer fail at
    post time."""
    def fn(comm, pkg):
        u, _, exc = PKGS[pkg]
        if comm.rank == 1:
            u.kill_now(comm.state)
        wait_failed(comm, 1)
        with pytest.raises(exc) as ei:
            comm.Send(np.zeros(4), dest=1, tag=3)
        return ei.value.code

    port, ref = both(3, fn, allow_failures=True)
    assert port == ref == [PF, None, PF]


def test_anysource_pending_then_ack():
    """ANY_SOURCE with an unacknowledged failure raises
    ERR_PROC_FAILED_PENDING; after ack_failed() it matches a live
    sender again."""
    def fn(comm, pkg):
        u, _, exc = PKGS[pkg]
        if comm.rank == 1:
            u.kill_now(comm.state)
        wait_failed(comm, 1)
        if comm.rank == 2:
            comm.Send(np.full(4, 7.0), dest=0, tag=5)
            return "sent"
        buf = np.zeros(4)
        with pytest.raises(exc) as ei:
            comm.Recv(buf, source=-1, tag=5)
        assert ei.value.code == PFP
        assert comm.ack_failed() == 1
        comm.Recv(buf, source=-1, tag=5)
        return float(buf[0])

    port, ref = both(3, fn, allow_failures=True)
    assert port == ref == [7.0, None, "sent"]


def test_get_failed_and_epoch():
    def fn(comm, pkg):
        u, _, _ = PKGS[pkg]
        if comm.rank == 2:
            u.kill_now(comm.state)
        wait_failed(comm, 2)
        assert comm.state.ulfm.epoch >= 1
        return comm.get_failed()

    port, ref = both(3, fn, allow_failures=True)
    assert port == ref == [[2], [2], None]


# ---- revoke ---------------------------------------------------------

def test_revoke_drains_all_ranks():
    """revoke poisons the communicator world-wide: parked ops drain
    with ERR_REVOKED, later ops fail at entry, the parent still works."""
    def fn(comm, pkg):
        _, _, exc = PKGS[pkg]
        sub = comm.dup(name="revokee")
        if comm.rank == 0:
            time.sleep(0.05)
            sub.revoke()
            code = RV
        else:
            with pytest.raises(exc) as ei:
                sub.Recv(np.zeros(4), source=0, tag=1)
            code = ei.value.code
        assert sub.is_revoked()
        with pytest.raises(exc) as ei2:
            sub.Send(np.zeros(2), dest=(comm.rank + 1) % comm.size)
        assert ei2.value.code == RV
        comm.Barrier()
        return code

    port, ref = both(4, fn, allow_failures=True)
    assert port == ref == [RV] * 4
    assert ulfm._pv_revokes.read() >= 1


def test_collective_on_revoked_comm_raises_before_it_deposits():
    """The coll shim's entry check: a device collective on a revoked
    comm raises ERR_REVOKED on every member without depositing (no
    meeting of the comm ever forms)."""
    def fn(comm):
        sub = comm.dup()
        if comm.rank == 0:
            sub.revoke()
        comm.Barrier()
        with pytest.raises(eh.MPIException) as ei:
            sub.allreduce_arr(torch.ones(4), port_op.SUM)
        world = comm.state.rte.world
        key = ("coll_rv", sub.cid, tuple(sub.group))
        return ei.value.code, key in world.shared

    assert run_ranks(3, fn, device_map=HBM) == [(RV, False)] * 3


# ---- agree ----------------------------------------------------------

def test_agree_healthy():
    def fn(comm, pkg):
        return (comm.agree(comm.rank != 2), comm.agree(True))

    port, ref = both(4, fn)
    assert port == ref == [(False, True)] * 4


@pytest.mark.parametrize("phase", ["pre_contrib", "post_contrib",
                                   "pre_decision", "post_decision"])
def test_agree_identical_under_kill(phase):
    """Every survivor returns the SAME flag at whichever protocol
    phase a member dies; the victim is the initial leader."""
    def fn(comm, pkg):
        u = comm.state.ulfm
        if comm.rank == 0:
            killed = PKGS[pkg][0].RankKilled

            def hook(p):
                if p == phase:
                    raise killed(f"killed at {p}")
            u._agree_test_hook = hook
        return comm.agree(comm.rank != 2)

    port, ref = both(4, fn, allow_failures=True)
    assert port == ref == [None, False, False, False], (phase, port, ref)


# ---- shrink ---------------------------------------------------------

def test_shrink_host_path():
    """shrink returns a survivor communicator every member agrees on:
    dense new ranks, the same cid everywhere, the errhandler handed
    on, and host collectives work on it."""
    def fn(comm, pkg):
        u, op, _ = PKGS[pkg]
        if comm.rank == 0:
            u.kill_now(comm.state)
        wait_failed(comm, 0)
        new = comm.shrink(name="survivors")
        assert new.errhandler is comm.errhandler
        x = np.full(16, new.rank + 1.0)
        r = np.empty_like(x)
        new.Allreduce(x, r, op.SUM)
        return (new.size, new.rank, new.cid, float(r[0]))

    port, ref = both(4, fn, allow_failures=True)
    assert port == ref
    assert port[0] is None
    live = port[1:]
    assert [(s, rk) for s, rk, _, _ in live] == [(3, 0), (3, 1), (3, 2)]
    assert len({cid for _, _, cid, _ in live}) == 1
    assert all(v == 6.0 for _, _, _, v in live)


def _survivor_bytes(x_of, to_np, dev_arr, pkg):
    def fn(comm):
        u, op, _ = PKGS[pkg]
        if comm.rank == 0:
            u.kill_now(comm.state)
        wait_failed(comm, 0)
        new = comm.shrink()
        return to_np(new.allreduce_arr(dev_arr(new, x_of(new.rank)),
                                       op.SUM)).tobytes()
    return fn


def _fresh_bytes(x_of, to_np, dev_arr, pkg):
    def fn(comm):
        op = PKGS[pkg][1]
        return to_np(comm.allreduce_arr(dev_arr(comm, x_of(comm.rank)),
                                        op.SUM)).tobytes()
    return fn


@pytest.mark.parametrize("tier", ["hbm", "mesh"])
@pytest.mark.parametrize("n", [4, 8])
def test_shrink_device_allreduce_byte_identical(tier, n):
    """A device allreduce on the shrunk (n - 1)-rank communicator is
    byte-identical to the same allreduce on a fresh (n - 1)-rank
    world, in both packages (the mesh tier's survivor mesh is not a
    power of two: its fold table and ring order are rebuilt)."""
    def x_of(r):
        return (np.arange(1031, dtype=np.float32) % 13) * (r + 1)

    port_np = lambda t: t.numpy()  # noqa: E731
    got = run_ranks(n, _survivor_bytes(x_of, port_np, _port_dev_arr,
                                       "port"),
                    device_map=TIERS[tier], allow_failures=True)
    fresh = run_ranks(n - 1, _fresh_bytes(x_of, port_np, _port_dev_arr,
                                          "port"),
                      device_map=TIERS[tier])
    ref = ref_run_ranks(n - 1, _fresh_bytes(x_of, np.asarray,
                                            _ref_dev_arr, "ref"),
                        devices=True)
    assert got[0] is None
    assert set(got[1:]) == set(fresh) == set(ref)


def test_divergence_no_compiled_program_cache():
    """The reference's shrink evicts its CompiledLRU's executables of
    the old mesh; the port has no compiled-program cache (its kernel
    libraries do not depend on the device set).  What the port purges
    is the old comm's per-group caches and its rendezvous — all of
    them, after plan, pipeline and fused traffic filled them."""
    assert not hasattr(port_device, "compile_cache")

    def fn(comm):
        x = torch.arange(4099, dtype=torch.float32) % 11 + comm.rank
        comm.allreduce_arr(x, port_op.SUM)          # plan tier
        comm.iallreduce_arr(x[:8], port_op.SUM).wait()  # fusion
        filled = {k for k in ulfm._COMM_CACHE_KEYS if k in comm.__dict__}
        if comm.rank == 0:
            ulfm.kill_now(comm.state)
        wait_failed(comm, 0)
        comm.shrink()
        world = comm.state.rte.world
        left = {k for k in ulfm._COMM_CACHE_KEYS if k in comm.__dict__}
        return (filled, left,
                ("coll_rv", comm.cid, tuple(comm.group)) in world.shared)

    with knobs({"coll_pipeline_min_bytes": 2048, "coll_seg_size": 4096,
                "coll_plan_enable": True}):
        r = run_ranks(4, fn, device_map=HBM, allow_failures=True)
    for filled, left, rv in r[1:]:
        assert {"_coll_plans", "_device_rv", "_fusion_engine",
                "_hbm_one_device"} <= filled, filled
        assert left == set() and not rv


# ---- the finish race (the reference's unsteady shrink-epoch tests) --

def test_divergence_posted_result_wins_over_late_failure():
    """Rank 0 dies right after leaving each of 50 meetings: no
    survivor raises for the op that completed.  The port reads the
    posted result under the meeting lock before every abort check;
    the reference's loop runs the check first."""
    def fn(comm):
        x = torch.full((64,), comm.rank + 1.0)
        out = comm.allreduce_arr(x, port_op.SUM)
        if comm.rank == 0:
            ulfm.kill_now(comm.state)
        return float(out[0])

    for i in range(50):
        dm = HBM if i % 2 else TIERS["mesh"]
        r = run_ranks(6, fn, device_map=dm, allow_failures=True)
        assert r == [None] + [21.0] * 5, (i, r)


def _epoch_case(knob_set, check_keys):
    def x_of(r):
        return (np.arange(4099, dtype=np.float32) % 11) + r

    def survivor(comm):
        comm.allreduce_arr(torch.from_numpy(x_of(comm.rank)),
                           port_op.SUM)  # old-epoch op
        if comm.rank == 0:
            ulfm.kill_now(comm.state)
        new = comm.shrink()
        for k in check_keys:
            assert k not in comm.__dict__
        return new.allreduce_arr(torch.from_numpy(x_of(new.rank)),
                                 port_op.SUM).numpy().tobytes()

    def fresh(comm, pkg):
        dev_arr = _port_dev_arr if pkg == "port" else _ref_dev_arr
        to_np = (lambda t: t.numpy()) if pkg == "port" else np.asarray
        op = PKGS[pkg][1]
        return to_np(comm.allreduce_arr(dev_arr(comm, x_of(comm.rank)),
                                        op.SUM)).tobytes()

    with knobs(knob_set):
        got = run_ranks(4, survivor, device_map=TIERS["mesh"],
                        allow_failures=True)
        ref = ref_run_ranks(3, lambda c: fresh(c, "ref"), devices=True)
    assert got[0] is None
    assert got[1] == got[2] == got[3] == ref[0]


PLAN_ON = {"coll_pipeline_enable": True, "coll_pipeline_min_bytes": 2048,
           "coll_seg_size": 4096, "coll_pipeline_rd_max_bytes": 0,
           "coll_hier_enable": False, "coll_plan_enable": True}
PIPE_ON = dict(PLAN_ON, coll_plan_enable=False)


@pytest.mark.parametrize("run", range(5))
def test_plan_across_shrink_epoch(run):
    """The port's test_coll_plan.py::test_plan_across_shrink_epoch:
    rank 0 dies right after a plan-path op; survivors shrink (the old
    comm's plans purged) and the shrunk world's bytes equal a fresh
    3-rank world's.  Five runs, every one must pass."""
    _epoch_case(PLAN_ON, ("_coll_plans",))


@pytest.mark.parametrize("run", range(5))
def test_segmented_across_shrink_epoch(run):
    """The port's test_coll_pipeline.py::
    test_segmented_across_shrink_epoch, on the segmented tier."""
    _epoch_case(PIPE_ON, ("_pipeline_pick", "_hier_plan"))


def test_divergence_shrink_revokes_the_old_comm():
    """Rank 3 dies; rank 2 raises at a p2p entry check naming it and
    shrinks, while rank 0 is parked in a receive from rank 2 (alive,
    but gone to shrink).  The port's shrink revokes the old comm
    first, so rank 0's receive drains with ERR_REVOKED and rank 0
    joins the shrink; without the revoke it would wait forever and
    the shrink would never decide."""
    def fn(comm):
        if comm.rank == 3:
            ulfm.kill_now(comm.state)
        if comm.rank == 0:
            with pytest.raises(eh.MPIException) as ei:
                comm.Recv(np.zeros(4), source=2, tag=9)
            code = ei.value.code
        else:
            wait_failed(comm, 3)
            with pytest.raises(eh.MPIException) as ei:
                comm.Send(np.zeros(4), dest=3, tag=9)
            code = ei.value.code
        new = comm.shrink()
        return code, new.size

    with knobs({"mpi_ft_ulfm_agree_timeout": 5.0}):
        r = run_ranks(4, fn, allow_failures=True, timeout=20.0)
    assert r[0] == (RV, 3) and r[3] is None
    # a member that shrank first may have revoked before the other sent
    assert all(size == 3 and code in (PF, RV) for code, size in r[1:3])


# ---- chaos demo -----------------------------------------------------

@pytest.mark.parametrize("tier", ["hbm", "mesh"])
def test_chaos_demo_threadworld(tier):
    """A 4-rank job loses rank 0 mid-loop; survivors catch the
    failure, shrink, and finish the loop on 3 — the final device
    allreduce byte-identical to a fresh 3-rank world's (both
    packages)."""
    steps = 12

    def x_of(r):
        return np.arange(8, dtype=np.float32) * (r + 1)

    def chaos(comm):
        work, out, step = comm, None, 0
        while step < steps:
            if comm.rank == 0 and step == 5:
                ulfm.kill_now(comm.state)
            try:
                out = work.allreduce_arr(torch.from_numpy(x_of(work.rank)),
                                         port_op.SUM)
                step += 1
            except eh.MPIException as e:
                assert e.code in FT, e.code
                work = work.shrink(name="survivors")
        return (work.size, out.numpy().tobytes())

    got = run_ranks(4, chaos, device_map=TIERS[tier], allow_failures=True)
    ref = ref_run_ranks(3, _fresh_bytes(x_of, np.asarray, _ref_dev_arr,
                                        "ref"), devices=True)
    assert got[0] is None
    assert all(x == (3, ref[0]) for x in got[1:]), got


# ---- knobs ----------------------------------------------------------

def test_ulfm_disabled_is_absent():
    """mpi_ft_ulfm=0: no UlfmState is attached and the mitigation API
    refuses, in both packages."""
    def fn(comm, pkg):
        assert comm.state.ulfm is None
        with pytest.raises(RuntimeError, match="ULFM is disabled"):
            comm.agree(True)
        with pytest.raises(RuntimeError, match="ULFM is disabled"):
            comm.shrink()
        return True

    with knobs({"mpi_ft_ulfm": "0"}):
        port, ref = both(2, fn)
    assert port == ref == [True, True]


def test_ft_inject_rank_faults_gating():
    ref_fi = _ref_fi
    for fi in (ft_inject, ref_fi):
        assert fi.rank_faults(0) == []
    with knobs({"ft_inject_plan": "rank_kill",
                "ft_inject_victim_rank": "2"}):
        for fi in (ft_inject, ref_fi):
            assert fi.rank_faults(2) == ["rank_kill"]
            assert fi.rank_faults(0) == []
            assert fi.rank_kill_victim() == 2


def test_rank_kill_injector_kills_at_init():
    """ft_inject rank_kill armed through the knobs: mpi_init arms the
    victim's timer, the victim dies out of its parked receive and the
    survivor's receive from it drains with ERR_PROC_FAILED."""
    def fn(comm):
        if comm.rank == 1:
            comm.Recv(np.zeros(1), source=0, tag=1)  # parked: killed
            return "victim survived"
        with pytest.raises(eh.MPIException) as ei:
            comm.Recv(np.zeros(1), source=1, tag=1)
        return ei.value.code

    with knobs({"ft_inject_plan": "rank_kill",
                "ft_inject_victim_rank": "1", "ft_inject_after": 0.05}):
        assert run_ranks(2, fn, allow_failures=True) == [PF, None]


def test_purge_store_at_finalize_leaves_a_clean_table():
    """Agreement and shrink tickets are gone from the world table once
    the survivors finalize (looped worlds never replay them)."""
    worlds = []

    def fn(comm):
        worlds.append(comm.state.rte.world)
        comm.agree(True)
        if comm.rank == 0:
            ulfm.kill_now(comm.state)
        wait_failed(comm, 0)
        comm.shrink()
        return True

    run_ranks(3, fn, allow_failures=True)
    shared = worlds[0].shared
    assert not [k for k in shared if isinstance(k, tuple) and k
                and k[0] in ulfm._STORE_KEY_HEADS]
